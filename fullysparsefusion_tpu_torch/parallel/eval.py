"""Sharded evaluation (port of ``parallel/eval.py``).

Each rank runs inference on its shard of the dataset (``idx % world ==
rank``, the split the reference uses), and the results merge either by an
all-gather of the ranks' result lists (small payloads) or through one
shard file per rank that rank 0 merges (large payloads); both come back
into dataset order by one round-robin :func:`interleave`. The shard files and their merge are the JAX package's, so a
directory written by either package merges the same way in the other.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch.distributed as dist


def _rank_world(group=None):
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(group), dist.get_world_size(group)
    return 0, 1


def shard_indices(n: int, rank: Optional[int] = None, world: Optional[int] = None
                  ) -> np.ndarray:
    """Dataset indices owned by ``rank`` (idx % world == rank); by default
    this process's rank in the default group (0 of 1 without one)."""
    r, w = _rank_world()
    return np.arange(r if rank is None else rank, n, w if world is None else world)


def _gather(local: List[Any], world: int, group=None) -> List[List[Any]]:
    gathered: List[Any] = [None] * world
    dist.all_gather_object(gathered, local, group=group)
    return gathered


def allgather_results(local_results: List[Any], group=None) -> List[Any]:
    """Every rank's result list, concatenated in rank order, on every rank
    (``all_gather_object``; the list itself at world size 1)."""
    _, world = _rank_world(group)
    if world == 1:
        return local_results
    return [r for part in _gather(local_results, world, group) for r in part]


def allgather_in_dataset_order(local_results: List[Any], group=None) -> List[Any]:
    """Every rank's list of its ``idx % world`` shard, interleaved back to
    dataset order (:func:`interleave`), on every rank (the list itself at
    world size 1)."""
    _, world = _rank_world(group)
    if world == 1:
        return local_results
    return interleave(_gather(local_results, world, group))


def interleave(shards: List[List[Any]]) -> List[Any]:
    """The ranks' shard lists, in rank order, back in dataset order: round
    robin, the inverse of the ``idx % world`` split."""
    n = max(map(len, shards), default=0)
    return [s[i] for i in range(n) for s in shards if i < len(s)]


def write_shard_results(results: List[Dict[str, Any]], tmpdir: str,
                        rank: Optional[int] = None) -> str:
    """Large-payload path: each rank writes ``results_rank{rank:03d}.json``."""
    r = _rank_world()[0] if rank is None else rank
    os.makedirs(tmpdir, exist_ok=True)
    path = os.path.join(tmpdir, f"results_rank{r:03d}.json")
    with open(path, "w") as f:
        json.dump(results, f)
    return path


def merge_shard_results(tmpdir: str) -> List[Dict[str, Any]]:
    """Rank 0's merge of all shard files, back in dataset order
    (:func:`interleave`)."""
    shards = []
    for fname in sorted(os.listdir(tmpdir)):
        if fname.startswith("results_rank"):
            with open(os.path.join(tmpdir, fname)) as f:
                shards.append(json.load(f))
    return interleave(shards)
