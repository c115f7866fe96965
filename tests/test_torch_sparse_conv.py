"""The PyTorch port's sparse convolution against the JAX package's on the CPU:
rulebook rows, strided output sets and pair rows must be exactly equal; the
plain version of kernel K1 (gather conv) is held to ``_gather_conv`` and to
the Pallas ``window_gather_conv`` in interpret mode, and its per-rulebook plan
to a numpy reference. ``test_torch_kernels.py`` holds the CUDA kernel to the
plain version on a card.

Tolerances: K1 takes bf16 operands whose products are exact in f32, so the
two packages differ only in the order of the f32 sums: 1e-5 relative to the
output's magnitude. The dense path rounds its conv output to bf16 on both
sides (XLA's conv and PyTorch's conv3d sum in different orders), so it may
land one bf16 ulp apart: 2^-8 ≈ 4e-3 relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullysparsefusion_tpu.ops import sparse_conv as jsc
from fullysparsefusion_tpu.ops.pallas_kernels import window_gather_conv
from fullysparsefusion_tpu_torch.ops import sparse_conv as tsc
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)

K1_TOL = 1e-5
BF16_TOL = 4e-3
K, S = (3, 3, 3), (2, 2, 2)


def _active_set(seed, cin, dims=(16, 16, 8), batch_size=2, n=420, cap=512):
    """Key-sorted active set (as the UNet's sets are) with ``cap - n`` invalid rows;
    returns the JAX and the port's SparseTensor over the same arrays."""
    rng = np.random.default_rng(seed)
    nx, ny, nz = dims
    # clumped occupancy: voxels of a few blobs, so taps find neighbours
    centers = rng.uniform(0, 1, (6, 4)) * [batch_size, nz, ny, nx]
    pts = centers[rng.integers(0, 6, 4 * n)] + rng.normal(0, [0, 1.5, 3, 3], (4 * n, 4))
    b, z, y, x = [np.clip(np.floor(pts[:, i]), 0, m - 1).astype(np.int64)
                  for i, m in enumerate((batch_size, nz, ny, nx))]
    keys = np.unique(((b * nz + z) * ny + y) * nx + x)[:n]
    n = len(keys)
    coords = np.zeros((cap, 3), np.int32)
    batch = np.zeros(cap, np.int32)
    coords[:n] = np.stack([keys % nx, keys // nx % ny, keys // (nx * ny) % nz], 1)
    batch[:n] = keys // (nx * ny * nz)
    valid = np.arange(cap) < n
    feats = (rng.normal(size=(cap, cin)) * valid[:, None]).astype(jnp.bfloat16)
    jst = jsc.SparseTensor(feats=jnp.asarray(feats), coords=jnp.asarray(coords),
                           batch=jnp.asarray(batch), valid=jnp.asarray(valid), dims=dims,
                           batch_size=batch_size)
    tst = tsc.SparseTensor(feats=_bf16(feats), coords=torch.from_numpy(coords),
                           batch=torch.from_numpy(batch), valid=torch.from_numpy(valid),
                           dims=dims, batch_size=batch_size)
    return jst, tst


def _bf16(x):
    return torch.from_numpy(np.asarray(x).astype(np.float32)).to(torch.bfloat16)


def _weights(seed, cin, cout):
    w = (np.random.default_rng(seed).normal(size=(27, cin, cout)) / np.sqrt(27 * cin))
    return w.astype(jnp.bfloat16)


def _close(got, ref, tol):
    ref = np.asarray(ref, np.float32)
    got = got.float().numpy()
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * max(1.0, np.abs(ref).max()))


def _eq(got, ref):
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _strided(jst, tst, out_cap=256, pad=(1, 1, 1)):
    jo = jsc.downsample_coords(jst, K, S, pad, out_cap)
    to = tsc.downsample_coords(tst, K, S, pad, out_cap)
    return jo, to


def test_subm_rulebook_rows_exact():
    jst, tst = _active_set(0, 8)
    rows = tsc.build_subm_rulebook(tst)
    _eq(rows, jsc.build_subm_rulebook(jst).rows)
    hits = rows < tst.capacity
    assert hits[13].sum() == tst.valid.sum() and hits.sum() > 2 * tst.valid.sum()


@pytest.mark.parametrize("pad", [(1, 1, 1), (1, 1, 0)])
def test_downsample_coords_and_pair_rows_exact(pad):
    jst, tst = _active_set(1, 8)
    (jc, jb, jv, jdims), (tc, tb, tv, tdims) = _strided(jst, tst, 256, pad)
    assert tdims == jdims
    _eq(tc, jc), _eq(tb, jb), _eq(tv, jv)
    assert 50 < int(tv.sum()) < 256
    mul = tsc.pair_query_rows(tc, tb, tv, tst.coords, tst.batch, tst.valid, tst.dims,
                              K, S, pad, "mul")
    _eq(mul, jsc._pair_query_rows(jc, jb, jv, jst.coords, jst.batch, jst.valid, jst.dims,
                                  jst.batch_size, K, S, pad, "mul"))
    div = tsc.pair_query_rows(tst.coords, tst.batch, tst.valid, tc, tb, tv, tdims,
                              K, S, pad, "div")
    _eq(div, jsc._pair_query_rows(jst.coords, jst.batch, jst.valid, jc, jb, jv, jdims,
                                  jst.batch_size, K, S, pad, "div"))
    assert (mul < tst.capacity).any() and (div < 256).any()


def test_downsample_coords_overflow_keeps_lowest_keys():
    jst, tst = _active_set(2, 8)
    (jc, jb, jv, _), (tc, tb, tv, _) = _strided(jst, tst, 40)
    _eq(tc, jc), _eq(tb, jb), _eq(tv, jv)
    assert bool(tv.all())


def _rulebooks(seed, cin):
    """(name, jax feats, port feats, rows) for subm, strided and inverse convs."""
    jst, tst = _active_set(seed, cin)
    (jc, jb, jv, jdims), (tc, tb, tv, tdims) = _strided(jst, tst)
    coarse = np.random.default_rng(seed + 7).normal(size=(256, cin)).astype(jnp.bfloat16)
    return [
        ("subm", jst.feats, tst.feats, tsc.build_subm_rulebook(tst)),
        ("strided", jst.feats, tst.feats,
         tsc.pair_query_rows(tc, tb, tv, tst.coords, tst.batch, tst.valid, tst.dims,
                             K, S, (1, 1, 1), "mul")),
        ("inverse", jnp.asarray(coarse), _bf16(coarse),
         tsc.pair_query_rows(tst.coords, tst.batch, tst.valid, tc, tb, tv, tdims,
                             K, S, (1, 1, 1), "div")),
    ]


@pytest.mark.parametrize("cin,cout", [(64, 64), (128, 64)])
def test_gather_conv_plain_matches_jax_gather_conv(cin, cout):
    w = _weights(cin, cin, cout)
    for name, jf, tf, rows in _rulebooks(3, cin):
        got = tsc.gather_conv(tf, rows, _bf16(w))      # CPU tensors: the plain version
        assert got.dtype == torch.float32 and got.shape == (rows.shape[1], cout)
        ref = jsc._gather_conv(jsc._append_zero_row(jf), jnp.asarray(rows.numpy()),
                               jnp.asarray(w))
        _close(got, ref, K1_TOL)


@pytest.mark.parametrize("cin", [64, 128])
def test_gather_conv_plain_matches_window_kernel_interpret(cin):
    jst, tst = _active_set(4, cin)
    rows = tsc.build_subm_rulebook(tst)
    w = _weights(5, cin, 64)
    got = tsc.gather_conv_plain(tst.feats, rows, _bf16(w))
    ref = window_gather_conv(jst.feats, jnp.asarray(rows.numpy()), jnp.asarray(w),
                             w_size=256, blk=128, interpret=True)
    _close(got, ref, K1_TOL)


def test_gather_conv_all_miss_tile_is_zero():
    _, tst = _active_set(6, 64)
    rows = tsc.build_subm_rulebook(tst)
    rows[:, 64:128] = tst.capacity                   # one 64-row tile with no hit at all
    w = _weights(6, 64, 32)
    got = tsc.gather_conv(tst.feats, rows, _bf16(w))
    assert not got[64:128].any() and got[:64].abs().sum() > 0
    ref = jsc._gather_conv(jsc._append_zero_row(jnp.asarray(tst.feats.float().numpy())
                                                .astype(jnp.bfloat16)),
                           jnp.asarray(rows.numpy()), jnp.asarray(w))
    _close(got, ref, K1_TOL)


def _np_masks(rows, n_src):
    hit = np.asarray(rows) < n_src
    return (hit.astype(np.int64) << np.arange(hit.shape[0])[:, None]).sum(0)


@pytest.mark.parametrize("kind", ["subm", "inverse"])
def test_plan_rulebook_sorts_rows_into_tiles_by_hit_mask(kind):
    """The K1 plan on a subm and an inverse rulebook with 340 rows of capacity
    padding: the order is a permutation sorting the numpy bitmasks stably;
    every tile's OR covers its rows' hits; the padding fills all-miss tiles;
    and the conv over the permuted rows, written back through the order,
    equals the conv over the rows and the Pallas window kernel."""
    cin, cout = 64, 32
    jst, tst = _active_set(10, cin, n=300, cap=640)
    if kind == "subm":
        jf, tf, n_src = jst.feats, tst.feats, tst.capacity
        rows = tsc.build_subm_rulebook(tst)
    else:
        _, (tc, tb, tv, tdims) = _strided(jst, tst)
        n_src = 256
        coarse = np.random.default_rng(11).normal(size=(n_src, cin)).astype(jnp.bfloat16)
        jf, tf = jnp.asarray(coarse), _bf16(coarse)
        rows = tsc.pair_query_rows(tst.coords, tst.batch, tst.valid, tc, tb, tv, tdims,
                                   K, S, (1, 1, 1), "div")
    n_out = rows.shape[1]
    plan = tsc.plan_rulebook(rows, n_src)
    assert plan.masks.dtype == plan.order.dtype == torch.int32
    masks, order = plan.masks.numpy(), plan.order.numpy()
    np.testing.assert_array_equal(masks, _np_masks(rows, n_src))
    np.testing.assert_array_equal(order, np.argsort(masks, kind="stable"))
    np.testing.assert_array_equal(np.sort(order), np.arange(n_out))

    tiles = masks[order].reshape(-1, tsc.TILE_ROWS)        # 640 rows: 5 whole tiles
    tile_or = np.bitwise_or.reduce(tiles, axis=1)
    assert not (tiles & ~tile_or[:, None]).any()
    n_pad = int((~tst.valid).sum())
    assert not masks[~tst.valid.numpy()].any()
    assert (tile_or == 0).sum() == n_pad // tsc.TILE_ROWS == 2 and tile_or[2:].all()

    w = _weights(12, cin, cout)
    direct = tsc.gather_conv_plain(tf, rows, _bf16(w))
    permuted = tsc.gather_conv_plain(tf, rows[:, plan.order.long()], _bf16(w))
    back = torch.empty_like(permuted)
    back[plan.order.long()] = permuted
    _close(back, direct.numpy(), K1_TOL)
    ref = window_gather_conv(jf, jnp.asarray(rows.numpy()), jnp.asarray(w), w_size=256, blk=128,
                             interpret=True)
    _close(back, ref, K1_TOL)
    assert direct.abs().sum() > 0


def test_strided_and_inverse_convs_match_jax():
    cin, cout = 64, 32
    jst, tst = _active_set(7, cin)
    w = _weights(7, cin, cout)
    got = tsc.sparse_conv3d(tst, _bf16(w), K, S, (1, 1, 1), 256)
    ref = jsc.sparse_conv3d(jst, jnp.asarray(w), None, K, S, (1, 1, 1), 256,
                            compute_dtype=jnp.bfloat16)
    _eq(got.coords, ref.coords), _eq(got.valid, ref.valid)
    _close(got.feats, ref.feats, K1_TOL)
    w2 = _weights(8, cout, cin)
    coarse_t = got.replace(feats=got.feats.to(torch.bfloat16))
    coarse_j = ref.replace(feats=ref.feats.astype(jnp.bfloat16))
    up = tsc.sparse_inverse_conv3d(coarse_t, tst, _bf16(w2), K, S, (1, 1, 1))
    rup = jsc.sparse_inverse_conv3d(coarse_j, jst.coords, jst.batch, jst.valid, jst.dims,
                                    jnp.asarray(w2), None, K, S, (1, 1, 1),
                                    compute_dtype=jnp.bfloat16)
    _close(up.feats, rup.feats, K1_TOL)
    assert up.feats.abs().sum() > 0


def test_dense_path_matches_jax():
    jst, tst = _active_set(9, 16, dims=(8, 8, 4), n=300, cap=320)
    assert tsc.use_dense_conv(tst, 16) and jsc.use_dense_conv(jst, 16)
    w = _weights(9, 16, 16)
    _close(tsc.subm_conv_dense(tst, _bf16(w)), jsc.subm_conv_dense(jst, jnp.asarray(w)),
           BF16_TOL)
    got = tsc.sparse_conv3d_dense(tst, _bf16(w), K, S, (1, 1, 0), 64)
    ref = jsc.sparse_conv3d_dense(jst, jnp.asarray(w), None, K, S, (1, 1, 0), 64)
    _eq(got.coords, ref.coords), _eq(got.valid, ref.valid)
    _close(got.feats, ref.feats, BF16_TOL)


@pytest.mark.parametrize("dims,cap,dense", [
    ((512, 512, 40), 57344, False), ((256, 256, 20), 40960, False),
    ((128, 128, 10), 24576, True), ((64, 64, 4), 8192, True), ((32, 32, 2), 2560, True),
    ((64, 64, 16), 2048, False), ((32, 32, 8), 2048, False), ((16, 16, 4), 1024, True)])
def test_dense_or_gather_dispatch_matches_jax(dims, cap, dense):
    """Bench stages 0-4 (capacities 57344 … 2560 on the nuScenes grid), then
    the tiny config's three stages (batch 2): at bench scale stages 0 and 1
    take the gather path and stage 2 sits exactly at the 0.15 occupancy
    threshold and goes dense, as do stages 3 and 4."""
    b = 1 if cap > 2048 else 2
    j = jsc.SparseTensor(feats=jnp.zeros((cap, 1)), coords=jnp.zeros((cap, 3), jnp.int32),
                         batch=jnp.zeros(cap, jnp.int32), valid=jnp.zeros(cap, bool),
                         dims=dims, batch_size=b)
    p = tsc.SparseTensor(feats=torch.zeros(cap, 1), coords=torch.zeros(cap, 3, dtype=torch.int32),
                         batch=torch.zeros(cap, dtype=torch.int32),
                         valid=torch.zeros(cap, dtype=torch.bool), dims=dims, batch_size=b)
    assert tsc.use_dense_conv(p, 128) == jsc.use_dense_conv(j, 128) == dense
