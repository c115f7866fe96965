"""Connected components over a BEV distance graph (port of ``ops/ccl.py``).

Two nodes connect iff both are valid, share a batch id and their xy
distance is below the threshold. Labels are compact and ordered by each
component's minimum node index. :func:`ccl_roots` is the plain min-label
propagation (the benchmark's frozen copy); the compact relabelling stays
in torch.
"""
from __future__ import annotations

import torch



def ccl_roots_plain(xy: torch.Tensor, batch: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`ccl_roots`: dense [G, N, N] adjacency, then
    min-label propagation with pointer jumping until nothing changes. The
    sweeps the last call took are left in ``ccl_roots_plain.sweeps``."""
    g, n = valid.shape
    d2 = ((xy[:, :, None, :] - xy[:, None, :, :]) ** 2).sum(-1)
    adj = (d2 < 1.0) & (batch[:, :, None] == batch[:, None, :]) \
        & valid[:, :, None] & valid[:, None, :]
    adj |= torch.eye(n, dtype=torch.bool, device=xy.device)[None] & valid[:, :, None]
    big = torch.tensor(n, dtype=torch.int64, device=xy.device)
    ar = torch.arange(n, device=xy.device).expand(g, n)
    labels = torch.where(valid, ar, big)
    ccl_roots_plain.sweeps = 0
    while True:
        ccl_roots_plain.sweeps += 1
        new = torch.where(adj, labels[:, None, :], big).amin(dim=2)
        new = torch.minimum(new, labels)
        jumped = torch.gather(labels, 1, new.clamp(max=n - 1))
        new = torch.where(new < big, torch.minimum(new, jumped), big)
        if torch.equal(new, labels):
            break
        labels = new
    return torch.where(valid, labels, torch.full_like(labels, -1)).to(torch.int32)


ccl_roots_plain.sweeps = 0


def ccl_roots(xy: torch.Tensor, batch: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per problem g and node i, the minimum node index reachable from i
    over the graph "dx² + dy² < 1, same batch, both valid" (plus self
    loops), or -1 for an invalid node → [G, N] i32.

    xy [G, N, 2] f32 (pre-scaled so the threshold is 1), batch [G, N] i32
    (≥ 0), valid [G, N] bool. On a CUDA tensor the kernel takes any N whose
    adjacency bitmask, ``G · N² / 8`` bytes of scratch, fits on the card
    (the union-find keeps ``parent[N]`` in shared memory up to ~46k nodes
    on an H100 and in a ``G · N`` i32 scratch beyond).
    """
    if xy.dtype != torch.float32 or batch.dtype != torch.int32 or valid.dtype != torch.bool:
        raise TypeError("ccl_roots takes f32 xy, int32 batch, bool valid")
    if xy.dim() != 3 or xy.shape[2] != 2 or batch.shape != xy.shape[:2] \
            or valid.shape != xy.shape[:2]:
        raise ValueError("ccl_roots: xy [G, N, 2], batch and valid [G, N]")
    if xy.device.type not in ("cpu", "cuda") or batch.device != xy.device \
            or valid.device != xy.device:
        raise ValueError("ccl_roots: all tensors on one CUDA device (or the CPU)")
    return ccl_roots_plain(xy, batch, valid)




def connected_components_bev_batched(xy: torch.Tensor, batch_idx: torch.Tensor,
                                     valid: torch.Tensor) -> torch.Tensor:
    """Compact labels [G, N] (-1 invalid) for G independent problems whose
    coordinates are pre-scaled so connectivity is ``dist < 1``: a component's
    label is the rank of its root (its minimum node index) among the
    problem's roots, all problems in one pass and no sort."""
    roots = ccl_roots(xy.contiguous(), batch_idx.to(torch.int32).contiguous(),
                      valid.contiguous()).long()
    n = roots.shape[1]
    is_root = valid & (roots == torch.arange(n, device=roots.device))
    rank = torch.cumsum(is_root, dim=1) - is_root.long()
    labels = torch.gather(rank, 1, roots.clamp(min=0))
    return torch.where(valid, labels, -1).to(torch.int32)


def connected_components_bev(xy: torch.Tensor, batch_idx: torch.Tensor, valid: torch.Tensor,
                             dist: float) -> torch.Tensor:
    """One problem: compact component ids [N] i32 (-1 invalid) of the graph
    "xy distance < ``dist``, same batch id, both valid", in ascending order
    of each component's minimum node index. ``xy`` [N, 2+] (extra columns
    ignored); the coordinates are scaled by ``1 / dist`` and run through
    :func:`connected_components_bev_batched` as one problem of K2. Exact for
    any component diameter."""
    batch = torch.where(valid, batch_idx.to(torch.int32), torch.zeros_like(batch_idx,
                                                                         dtype=torch.int32))
    return connected_components_bev_batched((xy[:, :2] / dist)[None], batch[None],
                                            valid[None])[0]
