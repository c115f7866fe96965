"""Process groups for data-parallel runs: one rank per process.

``init_group`` joins a ``torch.distributed`` group through a ``file://``
rendezvous (a file that no other run uses, so parallel runs cannot collide
on a port); ``spawn_ranks`` starts ``world_size`` processes with the spawn
method, runs ``fn(rank, world_size, group, *args)`` in each under a group,
and returns every rank's result, moved to the host. ``env_group`` joins the
group that ``python -m torch.distributed.run`` describes in the environment
(``env://``: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``), one process per card on every node, for the entry points'
``--multihost``. The default is NCCL on the card; the CPU is used only when
asked for (``backend="gloo"``, ``device="cpu"``). Spawned processes import
the module that holds ``fn`` again, so it must import nothing heavy at top
level.
"""
from __future__ import annotations

import contextlib
import os
import queue
import traceback
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def init_group(rank: int, world_size: int, init_file: str, backend: str = "nccl",
               device: str = "cuda"):
    """Join the default process group as ``rank`` of ``world_size`` through
    the rendezvous file ``init_file`` and return it. With ``device="cuda"``
    the rank's card is ``cuda:rank`` modulo the cards present."""
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                            world_size=world_size)
    return dist.group.WORLD


ENV_KEYS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@contextlib.contextmanager
def env_group(cpu: bool):
    """The default process group joined through ``env://`` from the
    variables ``torch.distributed.run`` sets, for the block: NCCL with this
    process on card ``LOCAL_RANK`` modulo the cards present, or gloo on the
    host with ``cpu``; destroyed when the block ends. Raises when a
    variable is missing (the process was not started by
    ``torch.distributed.run``)."""
    missing = [k for k in ENV_KEYS if k not in os.environ]
    if missing:
        raise RuntimeError(f"--multihost: {', '.join(missing)} not set; start the processes with "
                           "python -m torch.distributed.run (tools/launch_train_torch.sh, "
                           "tools/launch_test_torch.sh)")
    if not cpu:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]) % torch.cuda.device_count())
    dist.init_process_group("gloo" if cpu else "nccl", init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def to_host(obj):
    """``obj`` with every tensor replaced by a NumPy copy of it (containers
    walked), so that it pickles by value."""
    if torch.is_tensor(obj):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(v) for v in obj)
    return obj


def _rank_main(rank, fn, world_size, init_file, backend, device, args, results):
    torch.set_num_threads(1)
    try:
        group = init_group(rank, world_size, init_file, backend, device)
        try:
            out = ("ok", to_host(fn(rank, world_size, group, *args)))
        finally:
            dist.destroy_process_group()
    except Exception:  # reported to the parent, which raises it
        out = ("error", traceback.format_exc())
    results.put((rank, out))


def spawn_ranks(fn: Callable, world_size: int, init_file: str, args: Sequence[Any] = (),
                backend: str = "nccl", device: str = "cuda",
                timeout: float = 600.0) -> List[Any]:
    """Run ``fn(rank, world_size, group, *args)`` in ``world_size`` spawned
    processes (one CPU thread each) and return the
    results by rank, tensors as NumPy arrays. Raises if a rank raises, or
    if the ranks have not all finished within ``timeout`` seconds (a
    collective that some rank never issued), after ending them all."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(r, fn, world_size, init_file, backend,
                                                  device, tuple(args), results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    got, errors = {}, []
    try:
        while len(got) < world_size:
            rank, (status, value) = results.get(timeout=timeout)
            if status == "error":
                errors.append(f"rank {rank}:\n{value}")
                break
            got[rank] = value
    except queue.Empty:
        errors.append(f"ranks {sorted(set(range(world_size)) - set(got))} did not finish "
                      f"within {timeout} s")
    finally:
        for p in procs:
            p.join(timeout=0 if errors else 30)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("spawn_ranks: " + "\n".join(errors))
    return [got[r] for r in range(world_size)]

