"""Data-parallel training in the port against the port on the CPU (gloo):
SyncBN alone on two ranks against one layer over the concatenated rows,
``sharded_train_step`` at world size 1 against ``train_step`` bitwise, and
two ranks x batch 1 against one process at batch 2.

This module imports no JAX: the rank processes that ``spawn_ranks`` starts
import it again for its rank functions, which ``tests/test_torch_ddp.py``
(the port against the JAX package) uses too. Each rank runs one thread.

Two ranks against one process follow ``tests/test_train.py::
test_sharded_losses_match_single_device``: capacities are per global batch,
so each rank gets ample ones and the one process twice those, and neither
truncates. Two cases (``DDP_CASES``), and an empty rank
(``test_a_rank_without_valid_points_adds_nothing``):

* ``eval_bn`` (eval-form BN, detection weight 1): the ranks couple only
  through the loss normalizers (``mesh_mean``) and the gradient mean, the
  forward is the one process's row for row, and losses and every gradient
  agree to f32 sum order, ``DDP_EXACT_RTOL`` [2.9e-7 measured];
* ``segmentor_pretrain`` (train-form BN, weight 0): no discrete
  assignment downstream of the SyncBN statistics, held to every tolerance
  of that test: total loss ``DDP_TOTAL_RTOL``, loss terms ``DDP_TERM_RTOL``
  (``loss_sem_seg`` and ``loss_vote`` ``DDP_TIGHT_RTOL`` [9e-5]),
  ``num_pos`` (a mean over the ranks) times 2 within ``DDP_COUNT_RTOL``,
  each gradient's norm ``DDP_LEAF_RTOL``, the whole gradient's norm
  ``DDP_NORM_RTOL`` [1.7e-3]; the detection heads' gradients are 0.

Train-form BN at detection weight 1 is not held here: on the CPU the SyncBN
sums run in another order than the one process's (two partial sums against
one), and the bf16 UNet carries that f32 noise into a few foreground and
cluster-in-box decisions of the LiDAR branch, so detection terms and single
gradients move by percents, in the JAX package too
(``tools/ddp_equivalence.py``). ``tests/test_torch_ddp.py`` holds that case
to the JAX package's two devices term by term and leaf by leaf, and
``chip_smoke.py`` holds it to one process on the card, where it meets every
bound of ``tests/test_train.py``.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from fullysparsefusion_tpu_torch import synthetic as S
from fullysparsefusion_tpu_torch.config import tiny_fsf_config
from fullysparsefusion_tpu_torch.models.layers import MaskedBatchNorm, bn_group
from fullysparsefusion_tpu_torch.parallel import train as T
from fullysparsefusion_tpu_torch.parallel.launch import spawn_ranks
from fullysparsefusion_tpu_torch.train.hooks import RuntimeSchedule
from fullysparsefusion_tpu_torch.weights import build_fsf

RANK_TIMEOUT = 240.0
BN_TOL = 1e-6
# a sum over every rank's rows, in another order than one layer's
BN_SUM_TOL = 1e-5
DDP_TOTAL_RTOL = 5e-3
DDP_TERM_RTOL = 1e-2
DDP_TIGHT_RTOL = 1e-3
DDP_COUNT_RTOL = 5e-2
DDP_LEAF_RTOL = 1.5e-1
DDP_NORM_RTOL = 2e-2
DDP_EXACT_RTOL = 1e-5
# a weight-0 step whose rank 0 has no valid point
EMPTY_RANK_CASE = {"rank_all_invalid": (0.0, True, True)}
# the heads whose gradients a detection weight of 0 leaves exactly 0
DETECTION_HEADS = ("frustum_head.", "fsd_branch.bbox_head.", "refined_head_0.")
SCENE_SEEDS = (100, 101)


def gather_only(cfg):
    """``cfg`` with every UNet conv on the gather path."""
    seg = dataclasses.replace(cfg.fsd.segmentor, unet_dense_min_occupancy=2.0)
    return dataclasses.replace(cfg, fsd=dataclasses.replace(cfg.fsd, segmentor=seg))


def rank_config(scale: int = 1, tiny=tiny_fsf_config):
    """The tiny FSF config (``tiny()``: the port's, or the JAX package's),
    gather path only, with capacities ample for one scene, times ``scale``
    (per global batch)."""
    cfg = gather_only(tiny())
    c = cfg.caps
    caps = dataclasses.replace(
        c, points=512 * scale, voxels=c.voxels * scale, prevox=c.prevox * scale,
        fg_per_group=1024 * scale, cluster_voxels_per_group=1024 * scale,
        clusters=512 * scale, frustum_points=1024 * scale, frustum_objects=64 * scale,
        roi_points=4096 * scale)
    return dataclasses.replace(cfg, fsd=dataclasses.replace(cfg.fsd, caps=caps))


def scene_arrays(seed: int, cfg, all_invalid: bool = False):
    """(scene, camera) NumPy arrays of one sample; ``all_invalid`` marks
    every point invalid (the GT stays)."""
    sc = S.make_scene_arrays(seed=seed, batch_size=1, boxes_per_sample=2, bg_points=120,
                             n_cap=cfg.caps.points, max_gt=cfg.caps.max_gt)
    if all_invalid:
        sc["valid"][:] = False
    cam = S.make_camera_arrays(sc["gt_boxes"], sc["gt_labels"], sc["gt_valid"], batch_size=1,
                               num_classes=cfg.num_classes)
    return sc, cam


def case_scenes(cfg, all_invalid=False):
    """Rank 0's and rank 1's scenes; with ``all_invalid`` rank 0's has no
    valid point."""
    return [scene_arrays(SCENE_SEEDS[0], cfg, all_invalid=all_invalid),
            scene_arrays(SCENE_SEEDS[1], cfg)]


def concat_scenes(scenes):
    """One batch of the samples of ``scenes`` (each of batch 1), in order."""
    (sc0, cam0) = scenes[0]
    sc = {k: np.concatenate([s[k] for s, _ in scenes]) for k in sc0}
    sc["batch_idx"] = np.concatenate([s["batch_idx"] + i for i, (s, _) in enumerate(scenes)])
    cam = {k: np.concatenate([c[k] for _, c in scenes]) for k in cam0}
    return sc, cam


def to_batch(sc, cam, device="cpu"):
    pb, cd = S.fsf_inputs(sc, cam, device=device)
    gt = S.to_ground_truth(sc, device=device)
    return T.Batch(pb, cd, gt, gt)


def state_arrays(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def load_model(cfg, state, device="cpu"):
    model = build_fsf(cfg, device=device)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()}, strict=True)
    return model


def step_result(model, out, grads):
    loss, losses, gnorm = out
    return dict(total=float(loss), losses={k: float(v) for k, v in losses.items()},
                grads=grads, grad_norm=float(gnorm),
                buffers={k: v.detach().clone() for k, v in model.named_buffers()})


def fsf_step_rank(rank, world, group, cfg, state, cases):
    """Rank function: for each case (detection weight, BN form, every
    rank's (scene, camera) arrays) a model loaded from ``state`` takes one
    ``sharded_train_step`` on this rank's scene (train-form BN), or, with
    eval-form BN, the same forward under ``bn_group``, backward and
    gradient mean. Returns per case the averaged losses, the averaged
    gradients (as the optimizer gets them) and the BN buffers after it."""
    results = []
    for det_weight, train_bn, scenes in cases:
        model = load_model(cfg, state)
        batch = to_batch(*scenes[rank])
        grads = {}

        def mark(phase):
            if phase == "allreduce":
                grads.update({n: p.grad.detach().clone() for n, p in model.named_parameters()})

        if train_bn:
            opt = T.make_optimizer(model, total_steps=10)
            sched = RuntimeSchedule(enable_detection_step=0 if det_weight else 1)
            out = T.sharded_train_step(model, opt, sched, batch, 0, group, mark)
        else:
            with bn_group(group):
                losses = model(batch.pb, batch.cam, 1, batch.gt, batch.no_aug_gt, train=False,
                               detection_weight=det_weight)["losses"]
            T.total_loss(losses).backward()
            T.allreduce_grads_mean_(model.parameters(), group)
            mark("allreduce")
            losses = T.allreduce_mean(losses, group)
            out = (T.total_loss(losses), losses, torch.zeros(()))
        results.append(step_result(model, out, grads))
    return results


def world1_rank(rank, world, group, cfg, state, scene):
    """Rank function at world size 1: ``train_step`` and
    ``sharded_train_step`` (under the group) from one state; returns both
    steps' results and updated parameters."""
    out = {}
    for name, group_ in (("train_step", None), ("sharded", group)):
        model = load_model(cfg, state)
        opt = T.make_optimizer(model, total_steps=10)
        res = T.sharded_train_step(model, opt, RuntimeSchedule(), to_batch(*scene), 0, group_)
        out[name] = step_result(model, res, {n: p.grad.detach().clone()
                                             for n, p in model.named_parameters()})
        out[name]["params"] = {n: p.detach().clone() for n, p in model.named_parameters()}
    return out


def bn_rank(rank, world, group, cases):
    """Rank function: for each case (every rank's rows, validity and output
    cotangents) one ``MaskedBatchNorm`` in train form on this rank's rows
    under the group; returns its output, input gradient, parameter
    gradients (averaged over the ranks) and running statistics."""
    return [bn_case(rank, group, *case) for case in cases]


def bn_case(rank, group, xs, valids, cot):
    c = xs[rank].shape[1]
    m = MaskedBatchNorm(c).train()
    with torch.no_grad():
        m.weight.copy_(torch.linspace(0.5, 1.5, c))
        m.bias.copy_(torch.linspace(-0.2, 0.2, c))
    x = torch.as_tensor(xs[rank]).requires_grad_(True)
    with bn_group(group):
        y = m(x, torch.as_tensor(valids[rank]))
    y.backward(torch.as_tensor(cot[rank]))
    T.allreduce_grads_mean_(m.parameters(), group)
    return dict(y=y, dx=x.grad, dweight=m.weight.grad, dbias=m.bias.grad,
                running_mean=m.running_mean, running_var=m.running_var)


def bn_inputs(seed=3, rows=(200, 140), c=12):
    """Two ranks' rows (rank 1's all invalid when ``rows[1]`` is 0 valid),
    validity and output cotangents."""
    rng = np.random.default_rng(seed)
    xs = [rng.normal(1.5, 2.0, (n, c)).astype(np.float32) for n in rows]
    valids = [rng.random(n) > 0.25 for n in rows]
    cot = [rng.normal(size=(n, c)).astype(np.float32) for n in rows]
    return xs, valids, cot


def run_jobs(rank, world, group, jobs):
    """Rank function: each job's ``fn(rank, world, group, *args)`` in turn,
    so one spawn (each rank pays for starting a process and importing
    torch) serves a module's tests."""
    return [fn(rank, world, group, *args) for fn, args in jobs]


def spawn(fn, world, tmp_path, *args):
    return spawn_ranks(fn, world, str(tmp_path / "rendezvous"), args, backend="gloo",
                       device="cpu", timeout=RANK_TIMEOUT)


BN_CASES = ["masked", "rank_all_invalid"]


@pytest.mark.parametrize("case", BN_CASES)
def test_sync_batchnorm_two_ranks_equal_one_layer_on_the_concatenated_rows(two_ranks, case):
    (xs, valids, cot), ranks = two_ranks["bn"][case]
    m = MaskedBatchNorm(xs[0].shape[1]).train()
    with torch.no_grad():
        m.weight.copy_(torch.linspace(0.5, 1.5, m.weight.numel()))
        m.bias.copy_(torch.linspace(-0.2, 0.2, m.bias.numel()))
    x = torch.as_tensor(np.concatenate(xs)).requires_grad_(True)
    y = m(x, torch.as_tensor(np.concatenate(valids)))
    y.backward(torch.as_tensor(np.concatenate(cot)))
    split = np.cumsum([len(a) for a in xs])[:-1]
    for name, ref in (("y", y), ("dx", x.grad)):
        got = np.concatenate([r[name] for r in ranks])
        np.testing.assert_allclose(got, ref.detach().numpy(), rtol=BN_TOL, atol=BN_TOL,
                                   err_msg=name)
    assert len(np.split(x.grad.numpy(), split)[1]) == len(xs[1])
    # parameter gradients: the mean over ranks of each rank's; the one layer's is their sum
    for name, ref in (("dweight", m.weight.grad), ("dbias", m.bias.grad)):
        for r in ranks:
            np.testing.assert_allclose(2 * r[name], ref.numpy(), rtol=BN_SUM_TOL,
                                       atol=BN_SUM_TOL, err_msg=name)
    for name in ("running_mean", "running_var"):
        assert np.array_equal(ranks[0][name], ranks[1][name]), name
        np.testing.assert_allclose(ranks[0][name], getattr(m, name).numpy(), rtol=BN_TOL,
                                   atol=BN_TOL, err_msg=name)


def test_sharded_train_step_at_world_size_one_equals_train_step_bitwise(tmp_path):
    cfg = rank_config()
    state = state_arrays(build_fsf(cfg, seed=0, device="cpu"))
    (out,) = spawn(world1_rank, 1, tmp_path, cfg, state, scene_arrays(SCENE_SEEDS[0], cfg))
    a, b = out["train_step"], out["sharded"]
    assert a["total"] == b["total"] and a["losses"] == b["losses"]
    assert a["grad_norm"] == b["grad_norm"]
    for part in ("grads", "params", "buffers"):
        assert a[part].keys() == b[part].keys()
        for k in a[part]:
            assert np.array_equal(a[part][k], b[part][k]), (part, k)


@contextlib.contextmanager
def one_thread():
    """One intra-op thread, as the ranks run: many threads of the parallel
    test workers would contend for the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def torch_one_thread():
    """Every test and fixture of a module that has this fixture (defined or
    imported) runs torch on one intra-op thread, and the count is restored
    after the module: the parallel test workers would otherwise
    oversubscribe the cores, which slows a tiny CPU step down many times."""
    with one_thread():
        yield


@one_thread()
def single_process_reference(scenes, state, det_weight=1.0, train_bn=True):
    """One process on the batch of ``scenes`` (the ranks' scenes, in rank
    order) with as many times a rank's capacities: losses, gradients before
    the optimizer, and the BN buffers after the forward."""
    model = load_model(rank_config(scale=len(scenes)), state)
    batch = to_batch(*concat_scenes(scenes))
    out = model(batch.pb, batch.cam, len(scenes), batch.gt, batch.no_aug_gt, train=train_bn,
                detection_weight=det_weight)
    loss = T.total_loss(out["losses"])
    loss.backward()
    return dict(total=float(loss.detach()),
                losses={k: float(v.detach()) for k, v in out["losses"].items()},
                grads={n: p.grad.detach().numpy() for n, p in model.named_parameters()},
                buffers={k: v.numpy() for k, v in model.named_buffers()})


def assert_ddp_matches_single_process(rank_res, ref, case, world=2):
    """``tests/test_train.py``'s DDP-equivalence checks; exact ones for
    eval-form BN (see the module docstring)."""
    exact = case.startswith("eval_bn")
    np.testing.assert_allclose(rank_res["total"], ref["total"],
                               rtol=DDP_EXACT_RTOL if exact else DDP_TOTAL_RTOL)
    assert rank_res["losses"].keys() == ref["losses"].keys()
    for k, v in ref["losses"].items():
        count = not ("loss" in k or "recall" in k)
        tight = k in ("loss_sem_seg", "loss_vote")
        rtol = (DDP_EXACT_RTOL if exact else DDP_TIGHT_RTOL if tight
                else DDP_COUNT_RTOL if count else DDP_TERM_RTOL)
        np.testing.assert_allclose(rank_res["losses"][k] * (world if count else 1), v,
                                   rtol=rtol, atol=1e-5, err_msg=k)
    tot_ref = tot_got = 0.0
    for n, g in ref["grads"].items():
        got = rank_res["grads"][n]
        if exact:
            d, m = float(np.linalg.norm(got - g)), float(np.linalg.norm(g))
            assert d <= DDP_EXACT_RTOL * m + 1e-7, (n, d / max(m, 1e-12))
        n1, n2 = float(np.linalg.norm(g)), float(np.linalg.norm(got))
        np.testing.assert_allclose(n2, n1, rtol=DDP_LEAF_RTOL, atol=1e-6, err_msg=n)
        tot_ref, tot_got = tot_ref + n1 ** 2, tot_got + n2 ** 2
    np.testing.assert_allclose(tot_got ** 0.5, tot_ref ** 0.5, rtol=DDP_NORM_RTOL)


# (detection weight, train-form BN, rank 0's scene has no valid point) of
# each case of the two-rank step
DDP_CASES = {"segmentor_pretrain": (0.0, True, False), "eval_bn": (1.0, False, False)}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One spawn of two gloo ranks for the module: ``BN_CASES``, then every
    FSF case (``DDP_CASES`` and the empty rank) on the scenes of
    ``SCENE_SEEDS``, one per rank."""
    bn_cases = []
    for case in BN_CASES:
        xs, valids, cot = bn_inputs()
        if case == "rank_all_invalid":
            valids[1][:] = False
        bn_cases.append((xs, valids, cot))
    cfg = rank_config()
    state = state_arrays(build_fsf(cfg, seed=0, device="cpu"))
    cases = {name: (dw, train_bn, case_scenes(cfg, invalid))
             for name, (dw, train_bn, invalid) in dict(DDP_CASES, **EMPTY_RANK_CASE).items()}
    jobs = [(bn_rank, (bn_cases,)), (fsf_step_rank, (cfg, state, list(cases.values())))]
    bn, fsf = zip(*spawn(run_jobs, 2, tmp_path_factory.mktemp("ddp"), jobs))
    return dict(
        bn={name: (bn_cases[i], [r[i] for r in bn]) for i, name in enumerate(BN_CASES)},
        state=state,
        fsf={name: (c[2], [r[i] for r in fsf]) for i, (name, c) in enumerate(cases.items())})


@pytest.mark.parametrize("case", list(DDP_CASES))
def test_two_ranks_match_one_process_on_the_whole_batch(two_ranks, case):
    state = two_ranks["state"]
    scenes, (r0, r1) = two_ranks["fsf"][case]
    assert r0["total"] == r1["total"] and r0["losses"] == r1["losses"]
    for part in ("grads", "buffers"):
        for k in r0[part]:
            assert np.array_equal(r0[part][k], r1[part][k]), (part, k)
    assert r0["losses"]["fsd_num_pos"] > 0 and r0["losses"]["stage0_num_pos"] > 0
    det_weight, train_bn, _ = DDP_CASES[case]
    ref = single_process_reference(scenes, state, det_weight, train_bn)
    assert_ddp_matches_single_process(r0, ref, case)
    if det_weight == 0:
        for n, g in r0["grads"].items():
            if n.startswith(DETECTION_HEADS):
                assert not g.any(), n


def test_a_rank_without_valid_points_adds_nothing(two_ranks):
    """Rank 0's scene has no valid point (detection weight 0, train-form
    BN): the step finishes (the ranks issue the same collectives whatever
    their data), rank 0 adds exact zeros to every SyncBN sum, so the BN
    buffers are one process's on rank 1's scene alone, and the mean over
    the ranks of the (local) segmentor losses and of the gradients is half
    of that process's, to f32 sum order; ``num_pos`` (a mean over ranks)
    is half of its count."""
    state = two_ranks["state"]
    scenes, (r0, r1) = two_ranks["fsf"]["rank_all_invalid"]
    assert r0["losses"] == r1["losses"]
    ref = single_process_reference(scenes[1:], state, det_weight=0.0)
    for k, v in ref["losses"].items():
        if "loss" in k:
            np.testing.assert_allclose(2 * r0["losses"][k], v, rtol=DDP_EXACT_RTOL, err_msg=k)
        elif "num_pos" in k:
            assert 2 * r0["losses"][k] == v, k
    assert ref["losses"]["fsd_num_pos"] > 0 and ref["losses"]["loss_vote"] > 0
    for n, g in ref["grads"].items():
        assert np.array_equal(r0["grads"][n], r1["grads"][n]), n
        d, m = float(np.linalg.norm(2 * r0["grads"][n] - g)), float(np.linalg.norm(g))
        assert d <= DDP_EXACT_RTOL * m + 1e-7, (n, d / max(m, 1e-12))
    for k, v in ref["buffers"].items():
        assert np.array_equal(r0["buffers"][k], r1["buffers"][k]), k
        np.testing.assert_allclose(r0["buffers"][k], v, rtol=DDP_EXACT_RTOL, atol=1e-7,
                                   err_msg=k)
