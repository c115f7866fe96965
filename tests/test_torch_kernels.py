"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``gpu`` and skips without a CUDA device. The file
imports torch, numpy and the port only (not the JAX package, which needs
``flax``), so that it runs on a machine with a card:

    python -m pytest tests/test_torch_kernels.py -m gpu

The scene generators here (``t``, ``_ccl_problems``, ``_boxes``) are shared
with ``test_torch_ops.py``, which holds the plain versions to the JAX package.

Tolerances: K1 takes bf16 operands whose products are exact in f32, so the
kernel and the plain version differ only in the order of the f32 sums: 1e-4
of the output's magnitude. ``dw_per_tap`` likewise sums exact bf16 products
in f32, over up to n_out rows: 1e-4 of each tap's ``||d_w[k]||`` (and exactly
0 for a tap nothing hits). K2 and K3 are bitwise, also past the sizes where
their scratch leaves shared memory (K3 at N = 15,360, K2 at 50,000).
``fsf::segment_sum`` is bitwise its plain version on the CPU: both add each
segment's rows in ascending row order from 0.
"""
import numpy as np
import pytest
import torch

from fullysparsefusion_tpu_torch.models.sparse_unet import SubmRulebook
from fullysparsefusion_tpu_torch.ops import ccl, geometry, nms, sparse_conv
from fullysparsefusion_tpu_torch.synthetic import ccl_known_components, ccl_problem_arrays
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; on the card chip_smoke.py runs the kernels")
    return torch.device("cuda")


def t(x):
    return torch.from_numpy(np.array(x))


# --- K1: gather conv ---------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("n_src,n_out,cin,cout", [(1000, 1000, 64, 64), (1000, 700, 128, 128),
                                                  (300, 1111, 512, 256), (777, 777, 256, 128),
                                                  (500, 500, 16, 48)])
def test_gather_conv_kernel_matches_plain(cuda, n_src, n_out, cin, cout):
    g = torch.Generator().manual_seed(n_src + cin)
    feats = torch.randn(n_src, cin, generator=g).to(torch.bfloat16)
    rows = torch.randint(0, 2 * n_src, (27, n_out), generator=g, dtype=torch.int32)
    rows = torch.where(rows < n_src, rows, torch.full_like(rows, n_src))   # ~half misses
    rows[:, :64] = n_src                                                   # an all-miss tile
    w = (torch.randn(27, cin, cout, generator=g) / (27 * cin) ** 0.5).to(torch.bfloat16)
    args = [a.to(cuda) for a in (feats, rows, w)]
    got = sparse_conv.gather_conv(*args)
    ref = sparse_conv.gather_conv_plain(*args)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= 1e-4 * max(1.0, float(ref.abs().max()))
    assert not got[:64].any()


def _adversarial_rulebook(case, g):
    """(feats, rows, w) for the K1 kernel's edge cases."""
    n_src, n_out, cin, cout = 700, 1000, 64, 128
    if case == "cin16_cout48":
        cin, cout = 16, 48
    feats = torch.randn(n_src, cin, generator=g).to(torch.bfloat16)
    rows = torch.randint(0, 3 * n_src, (27, n_out), generator=g, dtype=torch.int32)
    rows = torch.where(rows < n_src, rows, torch.full_like(rows, n_src))
    if case == "every_slot_misses":
        rows[:] = n_src
    elif case == "one_hit_per_row":
        tap = torch.randint(0, 27, (n_out,), generator=g)
        hit = torch.randint(0, n_src, (n_out,), generator=g, dtype=torch.int32)
        rows[:] = n_src
        rows[tap, torch.arange(n_out)] = hit
    elif case == "padding_tiles":
        rows[:, 100:500] = n_src                   # 400 rows with no hit: 3 all-miss tiles
    elif case == "hits_in_one_tile":               # 100 rows hit: one tile of the sorted order
        keep = rows[:, 200:300].clone()
        rows[:] = n_src
        rows[:, 200:300] = keep
    w = (torch.randn(27, cin, cout, generator=g) / (27 * cin) ** 0.5).to(torch.bfloat16)
    return feats, rows, w


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["every_slot_misses", "one_hit_per_row", "padding_tiles",
                                  "hits_in_one_tile", "cin16_cout48"])
def test_gather_conv_kernel_adversarial_rulebooks(cuda, case):
    """n_out = 1000 is off the 128-row tile in every case; two runs are
    bitwise equal, with the plan given or made by the wrapper."""
    args = [a.to(cuda) for a in _adversarial_rulebook(case, torch.Generator().manual_seed(1))]
    plan = sparse_conv.plan_rulebook(args[1], args[0].shape[0])
    got = sparse_conv.gather_conv(*args, plan)
    again = sparse_conv.gather_conv(*args)
    ref = sparse_conv.gather_conv_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert float((got - ref).abs().max()) <= 1e-4 * max(1.0, float(ref.abs().max()))
    if case == "every_slot_misses":
        assert not got.any()

# --- dw_per_tap: the gather conv's weight gradient ----------------------------

DW_RTOL = 1e-4


def _dw_close(got, ref):
    diff = (got - ref).flatten(1).norm(dim=1)
    assert bool((diff <= DW_RTOL * ref.flatten(1).norm(dim=1)).all()), float(diff.max())


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["random", "every_slot_misses", "one_hit_per_row",
                                  "padding_tiles", "hits_in_one_tile", "cin16_cout48"])
@pytest.mark.parametrize("n_out", [1000, 20000 - 77])
def test_dw_per_tap_kernel_matches_plain(cuda, case, n_out):
    """The adversarial rulebooks of K1, at 1,000 rows (a tap's list is one
    chunk of a few tiles) and at 19,923 (many chunks per tap, added by the
    second pass); g stands for the output gradient. Two runs are bitwise
    equal."""
    gen = torch.Generator().manual_seed(2)
    feats, rows, _ = _adversarial_rulebook(case, gen)
    if n_out > rows.shape[1]:
        rows = rows.repeat(1, -(-n_out // rows.shape[1]))[:, :n_out].contiguous()
    g = torch.randn(rows.shape[1], 48 if case == "cin16_cout48" else 128,
                    generator=gen).to(torch.bfloat16)
    args = [a.to(cuda) for a in (feats, rows, g)]
    got = sparse_conv.dw_per_tap(*args)
    again = sparse_conv.dw_per_tap(*args, sparse_conv.plan_rulebook(args[1], feats.shape[0]))
    ref = sparse_conv.dw_per_tap_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _dw_close(got, ref)
    if case == "every_slot_misses":
        assert not got.any()


@pytest.mark.gpu
@pytest.mark.parametrize("n_chunks", [27, 66, 132])
@pytest.mark.parametrize("case", ["random", "every_slot_misses", "one_hit_per_row",
                                  "padding_tiles", "hits_in_one_tile"])
def test_dw_work_list_kernel_matches_plain(cuda, case, n_chunks):
    """The list kernels against the torch glue on the CPU, every field
    bitwise, at 1,000 and at 19,923 rows."""
    _, rows, _ = _adversarial_rulebook(case, torch.Generator().manual_seed(4))
    for r in (rows, rows.repeat(1, 20)[:, :20000 - 77].contiguous()):
        plan = sparse_conv.plan_rulebook(r, 700)
        got = sparse_conv.dw_work_list(sparse_conv.ConvPlan(*(a.to(cuda) for a in plan)), 27,
                                       n_chunks)
        ref = sparse_conv.dw_work_list(plan, 27, n_chunks)
        for name, a, b in zip(ref._fields, got, ref):
            assert torch.equal(a.cpu(), b), name


@pytest.mark.gpu
@pytest.mark.parametrize("cin,cout", [(16, 16), (64, 48), (256, 128), (512, 512), (1024, 256)])
def test_dw_per_tap_kernel_widths(cuda, cin, cout):
    gen = torch.Generator().manual_seed(cin + cout)
    n_src, n_out = 2000, 5000
    feats = torch.randn(n_src, cin, generator=gen).to(torch.bfloat16)
    rows = torch.randint(0, 4 * n_src, (27, n_out), generator=gen, dtype=torch.int32)
    rows = torch.where(rows < n_src, rows, torch.full_like(rows, n_src))
    g = torch.randn(n_out, cout, generator=gen).to(torch.bfloat16)
    args = [a.to(cuda) for a in (feats, rows, g)]
    _dw_close(sparse_conv.dw_per_tap(*args), sparse_conv.dw_per_tap_plain(*args))


def _active_set(n, cap, dims=(48, 48, 16), batch_size=2, seed=0):
    """A key-sorted, clumped active set of ``n`` voxels (capacity ``cap``)."""
    rng = np.random.default_rng(seed)
    nx, ny, nz = dims
    centers = rng.uniform(0, 1, (8, 4)) * [batch_size, nz, ny, nx]
    pts = centers[rng.integers(0, 8, 4 * n)] + rng.normal(0, [0, 2, 5, 5], (4 * n, 4))
    b, z, y, x = [np.clip(np.floor(pts[:, i]), 0, m - 1).astype(np.int64)
                  for i, m in enumerate((batch_size, nz, ny, nx))]
    keys = np.unique(((b * nz + z) * ny + y) * nx + x)[:n]
    n = len(keys)
    coords = np.zeros((cap, 3), np.int32)
    batch = np.zeros(cap, np.int32)
    coords[:n] = np.stack([keys % nx, keys // nx % ny, keys // (nx * ny) % nz], 1)
    batch[:n] = keys // (nx * ny * nz)
    return sparse_conv.SparseTensor(feats=torch.zeros(cap, 1), coords=t(coords), batch=t(batch),
                                    valid=t(np.arange(cap) < n), dims=dims,
                                    batch_size=batch_size)


@pytest.mark.gpu
@pytest.mark.parametrize("cin,cout", [(64, 128), (128, 512), (1024, 256)])
def test_subm_conv_backward_runs_the_kernels(cuda, cin, cout):
    """A submanifold conv's backward on the card: d_feats is K1 over the
    mirrored rows with wᵀ (Cout = the forward's Cin, up to 1024, so the
    kernel's column blocks pass 256), d_w is dw_per_tap; each against its
    plain version on the same inputs. The stage's mirrored plan equals
    ``plan_rulebook(rows.flip(0))``."""
    st = _active_set(3000, 4096)
    st = st.replace(coords=st.coords.to(cuda), batch=st.batch.to(cuda), valid=st.valid.to(cuda))
    rb = SubmRulebook(st)
    gen = torch.Generator().manual_seed(3)
    feats = (torch.randn(4096, cin, generator=gen) * st.valid.cpu()[:, None]).to(cuda)
    feats = feats.to(torch.bfloat16).requires_grad_(True)
    w = (torch.randn(27, cin, cout, generator=gen) / (27 * cin) ** 0.5).to(cuda)
    w.requires_grad_(True)
    cot = torch.randn(4096, cout, generator=gen).to(cuda)
    k1, dw = sparse_conv.gather_conv.launches, sparse_conv.dw_per_tap.launches
    out = sparse_conv.subm_conv_apply(feats, st.valid, rb.rows, w, rb.plan, rb.mirror)
    out.backward(cot)
    torch.cuda.synchronize()
    assert sparse_conv.gather_conv.launches - k1 == 2 and sparse_conv.dw_per_tap.launches - dw == 1
    rows_m, plan_m = rb.mirror()
    ref_plan = sparse_conv.plan_rulebook(rb.rows.flip(0), st.capacity)
    assert torch.equal(plan_m.masks, ref_plan.masks) and torch.equal(plan_m.order, ref_plan.order)
    g16 = (cot * st.valid[:, None]).to(torch.bfloat16)
    w16 = w.detach().to(torch.bfloat16)
    ref = sparse_conv.gather_conv_plain(g16, rows_m, w16.transpose(1, 2).contiguous())
    got = feats.grad.float()
    # d_feats returns in the input's dtype, bf16: one bf16 ulp
    assert float((got - ref).abs().max()) <= 4e-3 * max(1.0, float(ref.abs().max()))
    _dw_close(w.grad, sparse_conv.dw_per_tap_plain(feats.detach(), rb.rows, g16))


# --- K2: CCL roots -----------------------------------------------------------


def _ccl_problems(seed, g=3, n=96):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 9, (g, n, 2)).astype(np.float32)
    # away from the random points: a chain at d² == 1 (apart) and one at 0.99 (joined)
    xy[0, :10] = np.arange(10, dtype=np.float32)[:, None] * np.float32([1.0, 0.0]) - 30
    xy[0, 10:20] = np.arange(10, dtype=np.float32)[:, None] * np.float32([0.99, 0.0]) - 60
    batch = rng.integers(0, 2, (g, n)).astype(np.int32)
    batch[0, :20] = 0
    valid = rng.random((g, n)) > 0.15
    valid[0, :20] = True
    valid[2] = False                                  # an all-invalid problem
    return xy, batch, valid


@pytest.mark.gpu
def test_ccl_kernel_matches_plain(cuda):
    xy, batch, valid = _ccl_problems(0, g=6, n=1024)
    args = [t(a).to(cuda) for a in (xy, batch, valid)]
    assert torch.equal(ccl.ccl_roots(*args).cpu(), ccl.ccl_roots_plain(*args).cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("case,g,n", [("reversed_chain", 6, 1024), ("grid", 6, 1024),
                                      ("random", 6, 1000), ("random", 1, 8192),
                                      ("coincident", 6, 1024), ("mixed_batch", 6, 1024),
                                      ("all_invalid", 6, 1024)])
def test_ccl_kernel_adversarial_problems(cuda, case, g, n):
    """Bitwise equal to the plain version on inputs that are hard for a
    sweep-based CCL (the reversed chain, one component of all N nodes), at
    N off the 32-bit word and at the wrapper's largest N, on complete graphs
    (coincident points), batch ids that split them, and all-invalid nodes."""
    args = [t(a).to(cuda) for a in ccl_problem_arrays(case, g, n)]
    got = ccl.ccl_roots(*args)
    assert torch.equal(got, ccl.ccl_roots(*args))
    assert torch.equal(got.cpu(), ccl.ccl_roots_plain(*args).cpu())
    if case in ("reversed_chain", "grid"):
        assert not got.any()
    if case == "all_invalid":
        assert (got == -1).all()


# --- K3: NMS -----------------------------------------------------------------


def _boxes(rng, n, extent=6.0):
    b = np.zeros((n, 9), np.float32)
    b[:, :2] = rng.uniform(-extent, extent, (n, 2))
    b[:, 2] = rng.uniform(-1, 0, n)
    b[:, 3:6] = rng.uniform(0.5, 3.0, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    b[:, 7:] = rng.normal(size=(n, 2))
    return b


@pytest.mark.gpu
@pytest.mark.parametrize("n,g", [(12000, 1), (9000, 3)])
def test_ccl_kernel_past_8192_matches_plain(cuda, n, g):
    """Past the old 8,192-node cap: the union-find's parent[] in opted-in
    shared memory (N = 9,000 and 12,000 need more than 48 KB)."""
    args = [t(a).to(cuda) for a in ccl_problem_arrays("random", g, n)]
    got = ccl.ccl_roots(*args)
    assert torch.equal(got, ccl.ccl_roots(*args))
    assert torch.equal(got.cpu(), ccl.ccl_roots_plain(*args).cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("n,chain", [(40000, 100), (50000, 100), (50000, 45000)])
def test_ccl_kernel_known_components(cuda, n, chain):
    """Chains and coincident stacks with shuffled indices, components known
    by construction: at 40,000 nodes parent[] is in shared memory, at 50,000
    (past the opt-in limit) in device memory; chain=45,000 is one chain of
    diameter 45,000. Twenty runs each, since the union-find's hooks and path
    halving interleave differently each run."""
    xy, batch, valid, roots = ccl_known_components(n, seed=n, chain=chain)
    args = [t(a).to(cuda) for a in (xy, batch, valid)]
    want = t(roots).to(cuda)
    for run in range(20):
        got = ccl.ccl_roots(*args)
        assert torch.equal(got, want), f"run {run}: {int((got != want).sum())} nodes off"


@pytest.mark.gpu
def test_nms_kernel_matches_plain(cuda):
    rng = np.random.default_rng(0)
    n, c = 1280, 10
    boxes = t(_boxes(rng, n, extent=20.0)).to(cuda)
    scores = t(rng.random((c, n)).astype(np.float32)).to(cuda)
    valid = t(rng.random((c, n)) > 0.1).to(cuda)
    iou = geometry.boxes_iou_bev(boxes, boxes).contiguous()
    order, vs = nms.class_orders(scores, valid)
    assert torch.equal(nms.nms_keep(iou, order, vs.contiguous(), 0.25).cpu(),
                       nms.nms_keep_plain(iou, order, vs, 0.25).cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("c", [1, 2])
def test_nms_kernel_per_task_classes(cuda, c):
    """A multi-task decode's calls: one per task of one or two classes over
    the 1,024 clusters, so one or two warps scan every row."""
    rng = np.random.default_rng(c)
    n = 1024
    boxes = t(_boxes(rng, n, extent=20.0)).to(cuda)
    iou = geometry.boxes_iou_bev(boxes, boxes).contiguous()
    scores = t(rng.random((c, n)).astype(np.float32)).to(cuda)
    valid = t(rng.random((c, n)) > 0.2).to(cuda)
    order, vs = nms.class_orders(scores, valid)
    for thr in (0.1, 0.25, 0.5):
        got = nms.nms_keep(iou, order, vs.contiguous(), thr)
        assert torch.equal(got.cpu(), nms.nms_keep_plain(iou, order, vs, thr).cpu())
        assert 0 < int(got.sum()) < int(vs.sum())


@pytest.mark.gpu
@pytest.mark.parametrize("n,c,ties,invalid_classes", [(1000, 3, True, (1,)), (77, 2, False, (0, 1)),
                                                     (1280, 10, True, ()), (1, 1, False, ())])
def test_nms_kernel_edge_cases(cuda, n, c, ties, invalid_classes):
    """N off the 64-row word, tied IoUs and scores, classes with no valid row."""
    rng = np.random.default_rng(n)
    m = rng.random((n, n)).astype(np.float32)
    iou = (m + m.T) / 2
    if ties:
        iou = np.round(iou * 8) / 8               # IoU equal to the threshold: `>` decides
    np.fill_diagonal(iou, 1.0)
    scores = rng.random((c, n)).astype(np.float32)
    if ties:
        scores = np.round(scores * 4) / 4
    valid = rng.random((c, n)) > 0.3
    valid[list(invalid_classes)] = False
    order, vs = nms.class_orders(t(scores).to(cuda), t(valid).to(cuda))
    iou = t(iou).to(cuda)
    for thr in (0.25, 0.5, 0.875):
        got = nms.nms_keep(iou, order, vs.contiguous(), thr)
        assert got.dtype == torch.bool
        assert torch.equal(got.cpu(), nms.nms_keep_plain(iou, order, vs, thr).cpu())
        assert not got[list(invalid_classes)].any()


@pytest.mark.gpu
def test_nms_kernel_past_the_shared_memory_limit(cuda):
    """N = 15,360 (a batch of 12 x 1,280 queries): two 64-row mask blocks no
    longer fit in shared memory, so the scan reads them from device memory.
    IoU only within each sample's 1,280 rows, as the batched NMS gives it."""
    n, c = 15360, 3
    gen = torch.Generator(device=cuda).manual_seed(0)
    m = torch.rand(n, n, generator=gen, device=cuda)
    same = (torch.arange(n, device=cuda)[:, None] // 1280) == (torch.arange(n, device=cuda) // 1280)
    iou = torch.where(same, torch.round((m + m.T) * 4) / 8, 0.0)
    iou.fill_diagonal_(1.0)
    scores = torch.rand(c, n, generator=gen, device=cuda)
    valid = torch.rand(c, n, generator=gen, device=cuda) > 0.3
    order, vs = nms.class_orders(scores, valid)
    got = nms.nms_keep(iou, order, vs.contiguous(), 0.5)
    assert torch.equal(got, nms.nms_keep_plain(iou, order, vs, 0.5))
    assert 0 < int(got.sum()) < int(vs.sum())


# --- fsf::segment_sum ----------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("width,row_stride", [(1, 1), (3, 4), (4, 4), (6, 6), (27, 27),
                                              (81, 81), (128, 128), (128, 130)])
def test_segment_sum_kernel_matches_plain(cuda, width, row_stride):
    """Bitwise the plain version on the CPU (each segment's rows added in
    ascending row order from 0), twice the same: half the rows invalid, keys
    past the capacity, segments of one row to thousands, rows read through
    a stride (16-, 8- and 4-byte loads)."""
    from fullysparsefusion_tpu_torch.ops import segment

    g = torch.Generator().manual_seed(width + row_stride)
    n, capacity = 20000, 900
    keys = (torch.rand(n, generator=g) ** 3 * 1200).to(torch.int32)   # skewed sizes
    valid = torch.rand(n, generator=g) < 0.5
    wide = torch.randn(n, row_stride, generator=g)

    def view(x):
        return x[:, 0] if width == 1 else x[:, :width]

    feat = view(wide)
    seg = segment.unique_segments(keys.to(cuda), valid.to(cuda), capacity)
    before = segment.segment_sum.launches
    got = seg.sum(view(wide.to(cuda)))
    again = segment.segment_sum(view(wide.to(cuda)), seg.seg_id, capacity)
    torch.cuda.synchronize()
    assert segment.segment_sum.launches - before == 2
    ref = segment.segment_sum_plain(feat, seg.seg_id.cpu(), capacity)
    assert torch.equal(got.cpu(), ref) and torch.equal(again.cpu(), ref)
