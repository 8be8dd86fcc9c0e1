"""Process groups and batch sharding (port of ``deepmimic_mujoco_tpu/
parallel/mesh.py``).

JAX replaces the reference's ``mpirun -np 8`` with a device mesh whose
``env`` axis shards the env batch.  The port runs one process per rank
instead: :func:`launch` spawns them on one machine (or ``torchrun`` starts
them and :func:`initialize_distributed` reads its variables), each rank
takes its contiguous slice of the global env batch (:func:`shard_batch`),
and the parameters are replicated (:func:`replicate`)."""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
import pickle
import queue as queue_lib
import tempfile
import time
import traceback
from typing import Callable, Optional

import torch
import torch.distributed as dist

from deepmimic_mujoco_torch.parallel.collectives import _record


def initialize_distributed(backend: Optional[str] = None,
                           init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None) -> int:
    """Join the default process group; return this process's rank.

    Arguments left out are read from torchrun's variables (``RANK``,
    ``WORLD_SIZE``, and ``MASTER_ADDR``/``MASTER_PORT`` for ``env://``).
    With neither arguments nor variables it is a no-op that returns 0 (one
    process).  ``backend`` ("nccl" or "gloo") must be named whenever a
    group is formed: no backend is chosen for the caller."""
    if dist.is_initialized():
        return dist.get_rank()
    env = os.environ
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if init_method is None and {"MASTER_ADDR", "MASTER_PORT"} <= set(env):
        init_method = "env://"
    if world_size is None and rank is None and init_method is None:
        return 0
    if world_size is None or rank is None or init_method is None:
        raise ValueError(
            f"incomplete process group: world_size={world_size}, "
            f"rank={rank}, init_method={init_method!r}")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"name the backend, 'nccl' or 'gloo'; got "
                         f"{backend!r}")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return dist.get_rank()


def rank_slice(n_global: int, rank: int, world: int) -> slice:
    """Rank ``rank``'s contiguous rows of a batch of ``n_global`` split
    evenly over ``world`` ranks."""
    if n_global % world:
        raise ValueError(f"{n_global} rows do not split evenly over "
                         f"{world} ranks")
    n = n_global // world
    return slice(rank * n, (rank + 1) * n)


def tree_map(fn: Callable, tree):
    """``fn`` applied to every tensor of a tree of dicts, lists, tuples,
    named tuples and dataclasses (``EnvState`` included); other leaves are
    kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return tree


def shard_batch(tree, rank: int, world: int):
    """Rank ``rank``'s rows of every tensor of ``tree``, each of which has
    the global batch on its leading axis."""
    def take(x):
        return x[rank_slice(x.shape[0], rank, world)]
    return tree_map(take, tree)


def replicate(tree, group):
    """Every tensor of ``tree`` overwritten with rank 0's (a broadcast, in
    place); ``tree`` is returned.  Without a group, ``tree`` itself."""
    if group is None:
        return tree
    src = dist.get_global_rank(group, 0)

    def bcast(x):
        _record(lambda: dist.broadcast(x, src=src, group=group), x)
        return x
    return tree_map(bcast, tree)


def rank_device(device: str) -> torch.device:
    """This rank's device: its card (``cuda:<current>``) or the host."""
    if device == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def run_many(rank: int, world: int, calls: list) -> list:
    """Several rank functions in one launch, sharing its group: ``calls``
    is a list of ``(fn, args)``; returns ``[fn(rank, world, *args), ...]``
    (for :func:`launch`, which spawns ranks once for all of them)."""
    return [fn(rank, world, *args) for fn, args in calls]


def _run_rank(fn, rank, world, backend, init_method, device, args, results):
    """One spawned rank: join the group, run ``fn(rank, world, *args)``
    (``args`` pickled), send ``(rank, True, pickled result)`` or ``(rank,
    False, traceback)`` and re-raise, so the process exits non-zero.
    Arguments and results travel as plain pickles (copies): multiprocessing's
    own pickler would pass tensors in shared memory that a rank which has
    exited can no longer hand over."""
    torch.set_num_threads(1)
    try:
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world, rank=rank)
        out = pickle.dumps(fn(rank, world, *pickle.loads(args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, out))
    dist.destroy_process_group()


def launch(fn: Callable, nproc: int, backend: str, args: tuple = (),
           device: str = "cpu", timeout: float = 900.0) -> list:
    """Run ``fn(rank, world, *args)`` in ``nproc`` spawned processes that
    form one ``backend`` group (a ``file://`` store in a fresh temporary
    directory, so concurrent launches never share a port); return the
    ranks' results in rank order.  ``fn`` must be a module-level function
    (the ``spawn`` start method imports it by name) and its results must
    pickle.  On the card (``device`` "cuda") rank r uses card r modulo the
    card count.

    The first rank that raises, or dies, or a deadline of ``timeout``
    seconds, ends the launch: every other rank is terminated (one waiting
    in a collective would wait forever) and ``RuntimeError`` is raised with
    the failing rank's traceback."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    got, failure = {}, None
    deadline = time.monotonic() + timeout
    with tempfile.TemporaryDirectory() as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        blob = pickle.dumps(args)
        procs = [ctx.Process(target=_run_rank, args=(
            fn, r, nproc, backend, init_method, device, blob, results))
            for r in range(nproc)]
        for p in procs:
            p.start()
        try:
            while len(got) < nproc and failure is None:
                if time.monotonic() > deadline:
                    failure = f"no result from every rank in {timeout} s"
                    break
                try:
                    rank, ok, payload = results.get(timeout=0.5)
                except queue_lib.Empty:
                    # a rank that exits 0 has sent its result first
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0)]
                    if dead:
                        failure = (f"rank {dead[0]} exited with code "
                                   f"{procs[dead[0]].exitcode}")
                    continue
                if ok:
                    got[rank] = pickle.loads(payload)
                else:
                    failure = f"rank {rank} raised:\n{payload}"
            for p in procs:
                p.join(timeout=max(1.0, deadline - time.monotonic())
                       if failure is None else 1.0)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(10.0)
            results.close()
    if failure is None:
        codes = [p.exitcode for p in procs]
        if any(c != 0 for c in codes):
            failure = f"ranks exited with codes {codes}"
    if failure is not None:
        raise RuntimeError(f"launch of {nproc} ranks failed: {failure}")
    return [got[r] for r in range(nproc)]
