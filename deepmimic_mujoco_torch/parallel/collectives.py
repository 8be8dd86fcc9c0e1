"""Collectives over a ``torch.distributed`` process group (port of
``deepmimic_mujoco_tpu/parallel/collectives.py``).

The reference's MPI vocabulary, as JAX's ``lax`` collectives map it, maps
onto one process per rank:

  MPI.Allreduce(SUM)/nworkers  →  all_reduce(SUM) / world size  (maybe_pmean)
  MPI.Bcast(root=0)            →  broadcast from rank 0         (share_bytes)
  MPI.allgather                →  all_gather                    (sync_check)

Every learner helper is the identity when ``group`` is None, so the same
learner code runs in one process and across ranks.  Averages are sums
divided by the world size (gloo has no ``ReduceOp.AVG``); the tensors of
one call are flattened into one buffer and reduced by one collective.
Every collective goes through :func:`_record`, which counts it in
:data:`tally`."""

from __future__ import annotations

import os
import time
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

Tensors = Union[torch.Tensor, Sequence[torch.Tensor]]


class Tally:
    """The collectives this process made: ``calls``, and, while ``timing``
    is on, the wall ``seconds`` spent in them, the device synchronized
    before and after each (so the seconds hold no earlier queued work)."""

    def __init__(self):
        self.calls = 0
        self.seconds = 0.0
        self.timing = False

    def reset(self) -> None:
        self.calls, self.seconds = 0, 0.0


tally = Tally()


def _record(op, buf: torch.Tensor) -> None:
    """Run the collective ``op()`` on ``buf`` and count it."""
    tally.calls += 1
    if not tally.timing:
        op()
        return
    if buf.is_cuda:
        torch.cuda.synchronize(buf.device)
    t0 = time.perf_counter()
    op()
    if buf.is_cuda:
        torch.cuda.synchronize(buf.device)
    tally.seconds += time.perf_counter() - t0


def _all_reduce(x: Tensors, group, mean: bool) -> Tensors:
    """The elementwise sum (or mean) over the group of a tensor or of a
    sequence of tensors, returned in the same structure; the inputs are
    not modified."""
    xs = [x] if isinstance(x, torch.Tensor) else list(x)
    flat = torch.cat([t.detach().reshape(-1) for t in xs])
    _record(lambda: dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group),
            flat)
    if mean:
        flat = flat / dist.get_world_size(group)
    out, off = [], 0
    for t in xs:
        out.append(flat[off:off + t.numel()].view(t.shape).to(t.dtype))
        off += t.numel()
    return out[0] if isinstance(x, torch.Tensor) else type(x)(out)


def maybe_pmean(x: Tensors, group) -> Tensors:
    """The mean over the group's ranks (JAX's ``lax.pmean``); identity
    without a group."""
    return x if group is None else _all_reduce(x, group, mean=True)


def maybe_psum(x: Tensors, group) -> Tensors:
    """The sum over the group's ranks (JAX's ``lax.psum``); identity
    without a group."""
    return x if group is None else _all_reduce(x, group, mean=False)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(world, *x.shape): every rank's ``x``, in rank order; ``x[None]``
    without a group."""
    if group is None:
        return x[None]
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    _record(lambda: dist.all_gather(parts, x.contiguous(), group=group), x)
    return torch.stack(parts)


def sync_check(flat_params: torch.Tensor, flat_opt: torch.Tensor,
               group) -> bool:
    """Replica-divergence tripwire (the reference asserts that all ranks
    hold the same policy sum and vf-Adam sum): True iff this rank's sums of
    ``flat_params`` and ``flat_opt`` lie within 1e-4·(1 + |x|) of rank
    0's.  True without a group."""
    if group is None:
        return True
    sums = torch.stack([torch.sum(flat_params), torch.sum(flat_opt)])
    every = all_gather(sums, group)
    return bool(torch.all(torch.abs(every - every[0])
                          <= 1e-4 * (1.0 + torch.abs(every[0]))))


def _comm_device(group) -> torch.device:
    """Where a buffer for the group's collectives lives: the current card
    under NCCL, the host otherwise."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def share_bytes(data: Optional[bytes], group=None) -> bytes:
    """Rank 0's byte blob on every rank (the reference's ``share_file``
    transport: a length, then the bytes, each broadcast from rank 0).
    ``group`` None is the default group; a single process returns ``data``
    itself.  Ranks other than 0 may pass None."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        if data is None:
            raise ValueError("share_bytes: the only rank passed no data")
        return data
    dev = _comm_device(group)
    src = 0 if group is None else dist.get_global_rank(group, 0)
    is_src = dist.get_rank(group) == 0
    if is_src and data is None:
        raise ValueError("share_bytes: rank 0 passed no data")
    length = torch.tensor([len(data) if is_src else 0], dtype=torch.int64,
                          device=dev)
    _record(lambda: dist.broadcast(length, src=src, group=group), length)
    if is_src:
        buf = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(dev)
    else:
        buf = torch.empty(int(length), dtype=torch.uint8, device=dev)
    _record(lambda: dist.broadcast(buf, src=src, group=group), buf)
    return bytes(buf.cpu().numpy())


def share_file(path: str, group=None) -> None:
    """Rank 0's file at ``path`` written at the same path on every other
    rank (no shared filesystem needed)."""
    is_src = not dist.is_initialized() or dist.get_rank(group) == 0
    data = None
    if is_src:
        with open(path, "rb") as fh:
            data = fh.read()
    data = share_bytes(data, group)
    if not is_src:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as fh:
            fh.write(data)
