"""Environment state of a batch of envs (port of ``deepmimic_mujoco_tpu/
envs/types.py:EnvState``).  Every field has a leading env axis.  The JAX
state's per-env PRNG ``key`` has no counterpart: the port draws its noise
from ``torch.Generator``s that callers pass explicitly."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class EnvState:
    qpos: torch.Tensor        # (B, nq) float32
    qvel: torch.Tensor        # (B, nv) float32
    obs: torch.Tensor         # (B, obs_dim) observation after the last transition
    reward: torch.Tensor      # (B,) float32 reward of the last transition
    done: torch.Tensor        # (B,) bool termination flag of the last transition
    mocap_idx: torch.Tensor   # (B,) int64 mocap cursor
    init_idx: torch.Tensor    # (B,) int64 episode start frame
    step_count: torch.Tensor  # (B,) int64 steps since episode start
    # multi-clip envs: (B,) int64 index of each env's clip; None elsewhere
    clip_id: Optional[torch.Tensor] = None

    def map(self, fn) -> "EnvState":
        """``fn`` applied to every tensor field (None stays None)."""
        return EnvState(**{f.name: (None if getattr(self, f.name) is None
                                    else fn(getattr(self, f.name)))
                           for f in dataclasses.fields(self)})

    def where(self, keep_new: torch.Tensor, old: "EnvState") -> "EnvState":
        """Per env, this state where ``keep_new`` (B,) is true, else ``old``.
        A field that is None in both stays None."""
        def pick(new, prev):
            if new is None and prev is None:
                return None
            mask = keep_new.reshape((-1,) + (1,) * (new.dim() - 1))
            return torch.where(mask, new, prev)
        return EnvState(**{f.name: pick(getattr(self, f.name),
                                        getattr(old, f.name))
                           for f in dataclasses.fields(self)})

    @staticmethod
    def cat(states: list["EnvState"]) -> "EnvState":
        """The states' envs, concatenated in order."""
        return EnvState(**{
            f.name: (None if getattr(states[0], f.name) is None else
                     torch.cat([getattr(s, f.name) for s in states]))
            for f in dataclasses.fields(EnvState)})
