"""Multi-node training and sharded evaluation of the port's entry points
(``--multihost``) on the CPU, on the tiny tree of ``tests/test_torch_cli.py``
(training) and on one of four samples (evaluation, so that each rank owns
indices that are not adjacent): two gloo ranks started by ``python -m torch.distributed.run`` (``env://``)
against the same run spawned by ``--ranks 2`` and against one process.

- ``cli.train --multihost``: the same log and the same checkpoint,
  bitwise, as ``--ranks 2``, each rank on one sample of a global batch of 2.
- ``cli.test --multihost`` through ``tools/launch_test_torch.sh``, with
  ``--tmpdir`` shard files and with the all-gather: the merged JSON and the
  metrics are the one process's, byte for byte, over samples 0 and 2 on
  rank 0 and 1 and 3 on rank 1.
- ``--batch-size`` is the global batch (the JAX tool's): the ranks must
  divide it, and ``--multihost`` refuses ``--ranks``.

The port is held to the JAX package by the one-process runs of
``tests/test_torch_cli.py``; here the ranks are held to those runs. Every
process runs one thread. At most five tests, for the reason
``tests/test_torch_cli.py`` gives.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from fullysparsefusion_tpu_torch.cli import make_fake_nuscenes as M
from fullysparsefusion_tpu_torch.cli import test as T
from fullysparsefusion_tpu_torch.cli import train as TR
from fullysparsefusion_tpu_torch.config import tiny_fsf_config
from fullysparsefusion_tpu_torch.parallel.launch import ENV_KEYS
from fullysparsefusion_tpu_torch.train import checkpoint as ckpt
from test_torch_cli import IMG, _data, tree  # noqa: F401 (module fixture)
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the launch script's CONFIG; --tiny wins over it
REF_CONFIG = os.path.join(REPO, "tests", "torch_reference_configs", "nuScenes",
                          "FSF_nuScenes_config.py")
RUN_TIMEOUT = 300


def _env(**extra):
    """This environment for the launched ranks: the repository importable,
    one thread each, no rank variables of an enclosing launch."""
    env = {k: v for k, v in os.environ.items() if k not in ENV_KEYS}
    env.update(PYTHONPATH=os.pathsep.join([REPO] + sys.path), OMP_NUM_THREADS="1", **extra)
    return env


def _launch(argv, **env):
    r = subprocess.run(argv, cwd=REPO, env=_env(**env), capture_output=True, text=True,
                       timeout=RUN_TIMEOUT)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return r.stdout


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _log(work):
    """train_log.jsonl without the wall-clock field."""
    with open(os.path.join(work, "train_log.jsonl")) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "sec_per_step"} for line in f]


def _state_equal(a, b):
    if torch.is_tensor(a):
        return a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_state_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_state_equal(x, y) for x, y in zip(a, b))
    return a == b


TRAIN = ["--model", "fsf", "--tiny", "--cpu", "--max-steps", "1", "--batch-size", "2",
         "--log-interval", "1"]


@pytest.fixture(scope="module")
def spawned(tree, tmp_path_factory):  # noqa: F811
    """``--ranks 2 --batch-size 2``: two spawned gloo ranks, one step."""
    work = str(tmp_path_factory.mktemp("ranks2"))
    out = TR.run(tiny_fsf_config(), TR.parse_args(TRAIN + ["--ranks", "2", "--work-dir", work,
                                                           *_data(tree)]))
    return dict(out, work=work)


@pytest.fixture(scope="module")
def tree4(tmp_path_factory):
    """The tiny tree with four samples: rank 0 of 2 serves 0 and 2, rank 1
    serves 1 and 3, so a merge in rank order is not dataset order."""
    root = str(tmp_path_factory.mktemp("nusc4"))
    info, masks = M.write_dataset(root, n_samples=4, n_sweeps=2, extent=12.0)
    return dict(root=root, info=info, masks=masks)


def test_two_launched_ranks_train_bitwise_as_spawned_ranks(tree, spawned, tmp_path):  # noqa: F811
    work = str(tmp_path / "multihost")
    _launch([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
             "2", "-m", "fullysparsefusion_tpu_torch.cli.train", "--multihost", *TRAIN,
             "--work-dir", work, *_data(tree)])
    r0, r1 = spawned["ranks"]
    assert [s["batch"] for s in r0["steps"] + r1["steps"]] == [1, 1]    # 2 over 2 ranks
    assert r0["steps"][0]["loss"] == r1["steps"][0]["loss"]
    assert sorted(os.listdir(work)) == sorted(os.listdir(spawned["work"])) == \
        ["step_00000001.pt", "train_log.jsonl"]
    log = _log(work)
    assert log == _log(spawned["work"])
    assert log[0]["loss"] == round(r0["steps"][0]["loss"], 4) and np.isfinite(log[0]["loss"])
    got, want = (torch.load(ckpt.checkpoint_path(w, 1), weights_only=True)
                 for w in (work, spawned["work"]))
    assert _state_equal(got, want)


@pytest.mark.parametrize("shards", [True, False], ids=["tmpdir", "allgather"])
def test_two_launched_ranks_evaluate_as_one_process(tree4, spawned, tmp_path, shards):
    path = ckpt.checkpoint_path(spawned["work"], 1)
    common = ["--model", "fsf", "--tiny", "--cpu", "--mask-dir", tree4["masks"], *IMG]
    one = str(tmp_path / "one.json")
    res = T.run(tiny_fsf_config(), T.parse_args(
        ["--checkpoint", path, "--info-pkl", tree4["info"], "--data-root", tree4["root"],
         "--eval", "--out", one, *common]))
    two, tmpdir = str(tmp_path / "two.json"), str(tmp_path / "shards")
    stdout = _launch([os.path.join(REPO, "tools", "launch_test_torch.sh"), REF_CONFIG, path,
                      tree4["info"], tree4["root"], *common, "--out", two,
                      *(["--tmpdir", tmpdir] if shards else [])],
                     NPROC_PER_NODE="2", MASTER_PORT=str(_free_port()))
    tokens = [r["token"] for r in res["results"]]
    assert len(set(tokens)) == 4 and sum(len(r["scores"]) for r in res["results"]) > 0
    with open(one, "rb") as f, open(two, "rb") as g:
        assert g.read() == f.read()
    assert json.dumps(res["metrics"], indent=2) in stdout      # rank 0's, over all four samples
    (summary,) = [json.loads(line) for line in stdout.splitlines()
                  if line.startswith('{"samples": ')]           # rank 0 alone writes
    assert summary["samples"] == 4 and summary["launches"] == res["launches"]
    if shards:
        assert sorted(os.listdir(tmpdir)) == ["results_rank000.json", "results_rank001.json"]
        for r, name in enumerate(sorted(os.listdir(tmpdir))):
            with open(os.path.join(tmpdir, name)) as f:
                assert [s["token"] for s in json.load(f)] == tokens[r::2]
    else:
        assert not os.path.exists(tmpdir)


def test_batch_size_is_the_global_batch(tree):  # noqa: F811
    assert [TR.per_rank_batch(b, w) for b, w in ((0, 1), (0, 2), (2, 2), (8, 2), (3, 1))] == \
        [1, 1, 1, 4, 3]
    with pytest.raises(ValueError, match=r"\(3, 2\)"):
        TR.per_rank_batch(3, 2)
    # refused before any rank starts
    with pytest.raises(ValueError, match="not divisible by the 2 ranks"):
        TR.run(tiny_fsf_config(), TR.parse_args(
            ["--model", "fsf", "--tiny", "--cpu", "--max-steps", "1", "--ranks", "2",
             "--batch-size", "3", *_data(tree)]))


def test_multihost_refuses_ranks_and_needs_torchrun(tree, monkeypatch):  # noqa: F811
    with pytest.raises(ValueError, match="--multihost takes its ranks"):
        TR.run(tiny_fsf_config(), TR.parse_args(
            ["--model", "fsf", "--tiny", "--cpu", "--multihost", "--ranks", "2", *_data(tree)]))
    for key in ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        TR.run(tiny_fsf_config(), TR.parse_args(
            ["--model", "fsf", "--tiny", "--cpu", "--multihost", *_data(tree)]))
    with pytest.raises(RuntimeError, match="RANK, WORLD_SIZE"):
        T.run(tiny_fsf_config(), T.parse_args(
            ["--model", "fsf", "--tiny", "--cpu", "--multihost", *_data(tree)]))
