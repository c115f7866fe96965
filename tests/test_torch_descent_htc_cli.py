"""The port's training-descent and HTC-parity entry points on the CPU, and
the bench capacities they share with ``chip_smoke.py``:

- ``cli/train_descent.pool_arrays`` is the JAX tool's pool
  (``tools/train_descent.py``: ``tests/fixtures.make_lidar_scene`` /
  ``make_camera_data`` / ``with_noaug_channels``, seeds ``101 + 17 s + b``),
  array for array, at batch 1 and 2 (no model runs on the JAX side);
- ``config.bench_fsf_config(batch)`` holds the config that the JAX
  package's ``bench.py`` builds for ``FSF_BENCH_BATCH`` (its capacities and
  UNet stage capacities);
- ``cli.train_descent --tiny --cpu`` writes an artifact with the JAX
  artifact's keys and finite losses;
- ``cli.htc_parity``: a dump of the tiny HTC compares with itself (exit 0),
  a copy with one tap perturbed stops at that tap (exit 1), and
  ``--print-torch-snippet`` prints the JAX tool's ``TORCH_SNIPPET``, read
  from its source as text.

The descent's model and the HTC are held to the JAX package elsewhere
(``tests/test_torch_train.py``, ``tests/test_torch_htc_tiny.py``); no JAX
model is compiled here. At most five tests, for the reason
``tests/test_torch_cli.py`` gives.
"""
import ast
import contextlib
import dataclasses
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fixtures import make_camera_data, make_lidar_scene, with_noaug_channels
from fullysparsefusion_tpu.utils.containers import PointBatch
from fullysparsefusion_tpu_torch.cli import htc_parity as H
from fullysparsefusion_tpu_torch.cli import train_descent as D
from fullysparsefusion_tpu_torch.config import bench_fsf_config
from fullysparsefusion_tpu_torch.utils.htc_parity import ACTIVATION_ORDER
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the keys of the JAX tool's artifact but its TPU-only pair_budget_probe
JAX_ARTIFACT_KEYS = {"device", "config", "steps", "sec_per_step_steady", "loss_first",
                     "loss_last", "log"}


def _jax_pool(scenes, batch, cfg):
    """``tools/train_descent.py``'s pool, its own code on the host."""
    out = []
    for s in range(scenes):
        pbs, gts = [], []
        for b in range(batch):
            pb_b, gt_b = make_lidar_scene(seed=101 + s * 17 + b, n_cap=131072,
                                          max_gt=cfg.fsd.caps.max_gt, n_boxes=32, extent=48.0)
            pbs.append(pb_b)
            gts.append(gt_b)
        pb = PointBatch(points=jnp.concatenate([p.points for p in pbs]),
                        batch_idx=jnp.concatenate([p.batch_idx + b for b, p in enumerate(pbs)]),
                        valid=jnp.concatenate([p.valid for p in pbs]))
        gt = jax.tree_util.tree_map(lambda *xs: jnp.concatenate(xs), *gts)
        cam = make_camera_data(pb, gt, batch_size=batch, num_cams=cfg.num_cams,
                               num_classes=cfg.num_classes, img_h=450, img_w=800, max_anno=250,
                               fx=400.0)
        out.append((with_noaug_channels(pb), cam, gt))
    return out


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("scenes,batch", [(4, 1), (1, 2)])
def test_descent_pool_is_the_jax_tools(scenes, batch):
    cfg = bench_fsf_config(batch)
    pool = D.pool_arrays(cfg, scenes, batch)
    assert len(pool) == scenes
    for (sc, cam), (pb, jcam, gt) in zip(pool, _jax_pool(scenes, batch, cfg)):
        for k, v in (("points", pb.points), ("batch_idx", pb.batch_idx), ("valid", pb.valid),
                     ("gt_boxes", gt.boxes), ("gt_labels", gt.labels), ("gt_valid", gt.valid)):
            _same(sc[k], v)
        assert cam["masks"].shape[1:4] == (cfg.num_cams, jcam.img_h, jcam.img_w)
        _same(cam["masks"].reshape(-1, cam["masks"].shape[-1]), jcam.masks)
        _same(cam["anno"], jcam.anno)
        _same(cam["lidar2img"], jcam.lidar2img)
        assert int(sc["valid"].sum()) > 100000 * batch and int(sc["gt_valid"].sum()) == 32 * batch


class _Captured(Exception):
    pass


def test_bench_fsf_config_holds_the_jax_bench(monkeypatch):
    """``bench.build_bench_model`` up to its config (the JAX ``FSFConfig``
    constructor replaced by one that stops the build there)."""
    import bench
    from fullysparsefusion_tpu import config as jcfg

    real = jcfg.FSFConfig

    def capture(**kw):
        raise _Captured(real(**kw))

    monkeypatch.setattr(bench, "_enable_compile_cache", lambda: None)
    monkeypatch.setattr(jcfg, "FSFConfig", capture)
    for batch in (1, 2):
        monkeypatch.setenv("FSF_BENCH_BATCH", str(batch))
        with pytest.raises(_Captured) as got:
            bench.build_bench_model()
        want, ours = got.value.args[0], bench_fsf_config(batch)
        assert dataclasses.asdict(ours.fsd.caps) == dataclasses.asdict(want.fsd.caps)
        for field in ("unet_stage_capacities", "unet_dense_min_occupancy"):
            assert getattr(ours.fsd.segmentor, field) == getattr(want.fsd.segmentor, field)
        # the bench sets only the window-conv knobs beside these, which the
        # port keeps for field parity alone (config.py)
        a, b = dataclasses.asdict(ours), dataclasses.asdict(want)
        for d in (a, b):
            d["fsd"]["segmentor"].pop("unet_window_conv")
        assert a == b
    assert bench_fsf_config(2).fsd.caps.points == 262144
    assert bench_fsf_config(2).fsd.caps.max_gt == 128


def test_train_descent_tiny_writes_the_jax_artifact(tmp_path):
    out = str(tmp_path / "descent.json")
    D.main(["--tiny", "--cpu", "--steps", "3", "--scenes", "2", "--log-every", "1",
            "--out", out])
    with open(out) as f:
        art = json.load(f)
    assert JAX_ARTIFACT_KEYS <= set(art) and "pair_budget_probe" not in art
    assert art["steps"] == 3 and [e["step"] for e in art["log"]] == [2, 3]
    assert [r["scene"] for r in art["per_step"]] == [0, 1, 0]
    losses = [r["loss"] for r in art["per_step"]]
    assert all(np.isfinite(losses))
    assert art["loss_first"] == losses[0] and art["loss_last"] == losses[-1]
    assert art["log"][-1]["loss"] == round(losses[-1], 4)
    assert any(k.endswith("num_pos") for k in art["log"][0])
    for r in art["per_step"]:
        assert r["forward_ms"] > 0 and r["backward_ms"] > 0 and r["optimizer_ms"] > 0
        assert set(r["launches"]) == {"gather_conv", "ccl_roots", "nms_keep", "dw_per_tap",
                                      "segment_sum"}
        assert sum(r["launches"].values()) == 0          # CPU tensors: the plain versions
    assert art["device"] == "cpu" and art["card"] is None
    assert 1 <= art["slowest_step"]["step"] <= 3


def _cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = H.main(argv)
    return rc, buf.getvalue()


def test_htc_parity_cli_dump_compare_and_snippet(tmp_path):
    rois = str(tmp_path / "rois.npy")
    np.save(rois, np.asarray([[4, 4, 40, 30], [10, 8, 60, 50], [0, 0, 90, 60]], np.float32))
    ours = str(tmp_path / "ours.npz")
    rc, text = _cli(["dump", "--tiny", "--cpu", "--hw", "64,96", "--rois", rois, "--out", ours])
    assert rc == 0 and f"wrote {len(ACTIVATION_ORDER)} activations" in text
    rc, text = _cli(["compare", ours, ours])
    assert rc == 0 and text.rstrip().endswith("all modules match")
    assert [line.split()[0] for line in text.splitlines()[:len(ACTIVATION_ORDER)]] == \
        list(ACTIVATION_ORDER)
    with np.load(ours) as z:
        acts = {k: z[k] for k in z.files}
    acts["roi.bbox_feats1"] = acts["roi.bbox_feats1"] + 1e-2
    theirs = str(tmp_path / "theirs.npz")
    np.savez_compressed(theirs, **acts)
    rc, text = _cli(["compare", theirs, ours])
    assert rc == 1 and text.rstrip().endswith("first divergent module: roi.bbox_feats1")
    assert "bbox_head0.rois" in text and "DIVERGED" in text

    tree = ast.parse(open(os.path.join(REPO, "tools", "htc_parity.py")).read())
    (snippet,) = [n.value.value for n in tree.body if isinstance(n, ast.Assign)
                  and getattr(n.targets[0], "id", None) == "TORCH_SNIPPET"]
    rc, text = _cli(["--print-torch-snippet"])
    assert rc == 0 and text == snippet + "\n"
