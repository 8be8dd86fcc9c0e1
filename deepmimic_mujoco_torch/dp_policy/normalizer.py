"""Group-indexed normalizer (port of ``deepmimic_mujoco_tpu/dp_policy/
normalizer.py``).

Each dimension belongs to a group; NONE-group dimensions bypass
normalization.  Updates fold a batch's (count, sum, sum of squares) into
the running statistics.  JAX's ``axis_name`` psum over a device mesh and
``check_synced`` are collectives of the multi-device stack and are not
ported (ROADMAP.md, queue A, item 8)."""

from __future__ import annotations

import math
import types
from typing import NamedTuple, Optional

import numpy as np
import torch


class Groups:
    NONE = -1
    MAIN = 0


class NormalizerState(NamedTuple):
    mean: torch.Tensor
    std: torch.Tensor
    count: torch.Tensor
    mean_sq: torch.Tensor


def init(size: int, init_mean=None, init_std=None,
         device: torch.device | str = "cpu") -> NormalizerState:
    """Mean 0 (or ``init_mean``), std 1 (or ``init_std``), count 0."""
    def f32(x, fill):
        if x is None:
            return torch.full((size,), fill, dtype=torch.float32,
                              device=device)
        if isinstance(x, torch.Tensor):
            return x.to(device=device, dtype=torch.float32)
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    mean, std = f32(init_mean, 0.0), f32(init_std, 1.0)
    return NormalizerState(mean=mean, std=std,
                           count=torch.zeros((), device=device),
                           mean_sq=mean * mean + std * std)


def make(size: int, groups_ids=None, eps: float = 0.02,
         clip: float = math.inf) -> types.SimpleNamespace:
    """A namespace of ``update``, ``normalize`` and ``unnormalize`` bound
    to the group structure."""
    if groups_ids is None:
        groups_ids = np.zeros(size, np.int32)
    groups_ids = np.asarray(groups_ids, np.int32)
    active_np = groups_ids != Groups.NONE
    active_on: dict = {}

    def active(like: torch.Tensor) -> torch.Tensor:
        if like.device not in active_on:
            active_on[like.device] = torch.as_tensor(active_np,
                                                     device=like.device)
        return active_on[like.device]

    def update(state: NormalizerState, batch: torch.Tensor,
               weights: Optional[torch.Tensor] = None) -> NormalizerState:
        """``weights`` (0/1 per row) leave padding rows out of the
        statistics."""
        batch = batch.reshape(-1, state.mean.shape[0])
        if weights is None:
            n = torch.tensor(float(batch.shape[0]), device=batch.device)
            s = torch.sum(batch, dim=0)
            sq = torch.sum(batch * batch, dim=0)
        else:
            w = weights.reshape(-1, 1).to(batch.dtype)
            n = torch.sum(w)
            s = torch.sum(batch * w, dim=0)
            sq = torch.sum(batch * batch * w, dim=0)
        tot = state.count + n
        new_mean = (state.mean * state.count + s) / tot
        new_mean_sq = (state.mean_sq * state.count + sq) / tot
        var = torch.clamp(new_mean_sq - new_mean * new_mean, min=0.0)
        new_std = torch.sqrt(var + eps * eps)
        on = active(batch)
        return NormalizerState(
            mean=torch.where(on, new_mean, state.mean),
            std=torch.where(on, new_std, state.std),
            count=tot,
            mean_sq=torch.where(on, new_mean_sq, state.mean_sq))

    def normalize(state: NormalizerState, x: torch.Tensor) -> torch.Tensor:
        out = torch.clamp((x - state.mean) / state.std, -clip, clip)
        return torch.where(active(x), out, x)

    def unnormalize(state: NormalizerState, x: torch.Tensor) -> torch.Tensor:
        return torch.where(active(x), x * state.std + state.mean, x)

    return types.SimpleNamespace(update=update, normalize=normalize,
                                 unnormalize=unnormalize,
                                 groups_ids=groups_ids)
