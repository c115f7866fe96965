"""K1's plain version against the window kernel in interpret mode, the rulebook
plans and the dense path against the JAX package on the CPU: tests of
``test_torch_sparse_conv.py``, at its tolerances. A file of at most five
tests, so that xdist's ``--dist loadfile`` (files with more tests first)
queues it behind ``tests/test_train.py``, the run's longest file.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullysparsefusion_tpu.ops import sparse_conv as jsc
from fullysparsefusion_tpu.ops.pallas_kernels import window_gather_conv
from fullysparsefusion_tpu_torch.ops import sparse_conv as tsc
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)
from test_torch_sparse_conv import (BF16_TOL, K, K1_TOL, S, _active_set, _bf16, _close, _eq,
                                    _np_masks, _strided, _weights)


@pytest.mark.parametrize("cin", [64, 128])
def test_gather_conv_plain_matches_window_kernel_interpret(cin):
    jst, tst = _active_set(4, cin)
    rows = tsc.build_subm_rulebook(tst)
    w = _weights(5, cin, 64)
    got = tsc.gather_conv_plain(tst.feats, rows, _bf16(w))
    ref = window_gather_conv(jst.feats, jnp.asarray(rows.numpy()), jnp.asarray(w),
                             w_size=256, blk=128, interpret=True)
    _close(got, ref, K1_TOL)


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
