"""The weight-gradient kernel's work list (``ops/sparse_conv.dw_work_list``
on the CPU: the torch glue that is the plain version of the list kernels)
against a numpy reference, and the
structured CCL problem of ``synthetic.ccl_known_components`` against the
plain union of the distance graph.

The work list is held exactly: each 128-row tile's OR of hit masks, each
tap's ascending list of hit tiles, and the chunks cut from those lists.
Summing each chunk's tiles with the plain per-tile product, then each tap's
chunks in order, must give ``dw_per_tap_plain`` (1e-5 relative: the same
f32 products summed in another order), so every hit is counted once.
Imports torch, numpy and the port only, like ``test_torch_kernels.py``.
"""
import numpy as np
import pytest
import torch

from fullysparsefusion_tpu_torch.ops import ccl, sparse_conv
from fullysparsefusion_tpu_torch.synthetic import ccl_known_components
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)

K3 = 27


def _rulebook(case, n_src=700, n_out=1000, seed=0):
    """rows [27, n_out] (miss → n_src) for the work list's edge cases."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 3 * n_src, (K3, n_out))
    rows = np.where(rows < n_src, rows, n_src)
    if case == "all_miss":
        rows[:] = n_src
    elif case == "hits_in_one_tile":          # 100 rows hit: one tile of the sorted order
        hit = rng.choice(n_out, 100, replace=False)
        keep = rows[:, hit]
        rows[:] = n_src
        rows[:, hit] = keep
    elif case == "padding_heavy":             # 900 rows with no hit: 7 padding tiles
        rows[:, 50:950] = n_src
    return rows.astype(np.int32), n_src


def _reference(rows, n_src, n_chunks):
    """(tile masks, per-tap hit tiles, chunks, each tap's (first chunk,
    chunks)) in numpy."""
    k3, n_out = rows.shape
    masks = ((rows < n_src).astype(np.int64) << np.arange(k3)[:, None]).sum(0)
    order = np.argsort(masks, kind="stable")
    n_tiles = -(-n_out // sparse_conv.TILE_ROWS)
    tile_mask = np.array([np.bitwise_or.reduce(masks[order[t * 128:(t + 1) * 128]])
                          for t in range(n_tiles)], np.int64)
    lists = [[t for t in range(n_tiles) if (tile_mask[t] >> k) & 1] for k in range(k3)]
    per = next(p for p in range(1, n_tiles + 2)
               if sum(-(-len(lst) // p) for lst in lists) <= n_chunks)
    chunks, tap_chunks, start = [], [], 0
    for k, lst in enumerate(lists):
        n_ck = -(-len(lst) // per)
        tap_chunks.append((len(chunks), n_ck))
        chunks += [(k, start + c * per, min(per, len(lst) - c * per)) for c in range(n_ck)]
        start += len(lst)
    return tile_mask, lists, chunks, tap_chunks


@pytest.mark.parametrize("n_chunks", [27, 40, 132])
@pytest.mark.parametrize("case", ["random", "all_miss", "hits_in_one_tile", "padding_heavy"])
def test_dw_work_list_matches_numpy(case, n_chunks):
    rows_np, n_src = _rulebook(case)
    rows = torch.from_numpy(rows_np)
    plan = sparse_conv.plan_rulebook(rows, n_src)
    work = sparse_conv.dw_work_list(plan, K3, n_chunks)
    tile_mask, lists, chunks, tap_chunks = _reference(rows_np, n_src, n_chunks)

    assert work.tile_mask.tolist() == tile_mask.tolist()
    assert work.tap_tiles.tolist() == [len(lst) for lst in lists]
    flat = [t for lst in lists for t in lst]
    assert work.tiles.tolist() == flat + [-1] * (K3 * len(tile_mask) - len(flat))
    assert work.chunks.shape == (n_chunks, 3)
    got = work.chunks.tolist()
    assert got == [list(c) for c in chunks] + [[0, 0, 0]] * (n_chunks - len(chunks))
    assert work.tap_chunks.tolist() == [list(c) for c in tap_chunks]
    if case == "hits_in_one_tile":
        assert all(len(lst) <= 1 for lst in lists) and sum(map(len, lists)) > 0
    if case == "all_miss":
        assert not flat and not chunks
    else:                                         # the least length that fits the slots
        per = max(c[2] for c in chunks)
        assert len(chunks) <= n_chunks
        assert per == 1 or sum(-(-len(lst) // (per - 1)) for lst in lists) > n_chunks

    # every hit is summed once: chunk sums, then each tap's chunks in order
    gen = torch.Generator().manual_seed(1)
    feats = torch.randn(n_src, 16, generator=gen).to(torch.bfloat16)
    g = torch.randn(rows.shape[1], 24, generator=gen).to(torch.bfloat16)
    f_z = torch.cat([feats, feats.new_zeros(1, 16)]).float()
    part = torch.zeros(len(got), 16, 24)
    for j, (tap, begin, count) in enumerate(got):
        for tile in work.tiles[begin:begin + count].tolist():
            r = plan.order[tile * 128:(tile + 1) * 128].long()
            part[j] += f_z[rows[tap, r].long()].T @ g[r].float()
    dw = torch.stack([part[f:f + c].sum(0) for f, c in work.tap_chunks.tolist()])
    ref = sparse_conv.dw_per_tap_plain(feats, rows, g)
    assert float((dw - ref).abs().max()) <= 1e-5 * max(1.0, float(ref.abs().max()))


def test_dw_chunk_slots_fill_the_card_once():
    """Chunk slots times the blocks of one chunk fit 132 SMs at once (two
    blocks an SM at a Cout tile of 64 or 128, one at 256), with a slot per tap
    at least; the chunks' scratch stays within 10x d_w."""
    for cin, cout, want in ((64, 64, 264), (128, 128, 264), (256, 128, 132), (512, 256, 33),
                            (16, 48, 264), (1024, 256, 27)):
        assert sparse_conv.dw_chunk_slots(cin, cout, 132, K3) == want
        assert want * cin * cout <= 10 * K3 * cin * cout


def test_ccl_known_components_match_plain():
    xy, batch, valid, roots = ccl_known_components(2000, seed=3)
    got = ccl.ccl_roots(torch.from_numpy(xy), torch.from_numpy(batch), torch.from_numpy(valid))
    assert torch.equal(got, torch.from_numpy(roots))
    n_comp = int(((roots[0] == np.arange(2000)) & valid[0]).sum())
    assert n_comp > 10 and int((roots < 0).sum()) == 200
