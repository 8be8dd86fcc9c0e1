"""DPEnv v2, batched (port of ``deepmimic_mujoco_tpu/envs/dp_env_v2.py``):
the pose-reward imitation env.

* physics: ``build_humanoid(dt=0.002)``, ``n_substeps`` = 6 ``engine.step``
  substeps per control step (24 APGD solves)
* obs = qpos[2:] ‖ qvel (67-D; the root's x, y dropped)
* reward = exp(−2·Σ|qpos[3:] − ref[3:]|) − 0.1·Σaction²
* cursor: ``mocap_idx`` counts control steps from 0 after a reset; the
  reference frame is (mocap_idx + init_idx) mod T
* termination: root height qpos[2] outside (0.7, 2.0)
* reset: a random frame of the clip (RSI); the env has no ``reset_init``
"""

from __future__ import annotations

from typing import Optional

import torch

from deepmimic_mujoco_torch.envs import rewards
from deepmimic_mujoco_torch.envs.types import EnvState
from deepmimic_mujoco_torch.mocap.loader import MocapClip, load_clip
from deepmimic_mujoco_torch.physics import engine
from deepmimic_mujoco_torch.physics.humanoid import build_humanoid
from deepmimic_mujoco_torch.physics.model import PhysicsModel


def root_height_done(qpos: torch.Tensor) -> torch.Tensor:
    """(B,) true where the root height leaves (0.7, 2.0)."""
    return (qpos[:, 2] < 0.7) | (qpos[:, 2] > 2.0)


class DPEnvV2:
    """Batched functional environment; all per-env state is in
    :class:`EnvState`, on the model's device."""

    observation_size = 67
    action_size = 28

    def __init__(self, clip: str | MocapClip = "walk",
                 model: Optional[PhysicsModel] = None, n_substeps: int = 6,
                 device: torch.device | str | None = None):
        self.model = (model if model is not None
                      else build_humanoid(dt=0.002, device=device))
        self.device = dev = self.model.device
        if not isinstance(clip, MocapClip):
            clip = load_clip(clip)
        self.clip = clip
        self.clip_len = len(clip)
        self.clip_qpos = torch.as_tensor(clip.qpos, dtype=torch.float32,
                                         device=dev)
        self.clip_qvel = torch.as_tensor(clip.qvel, dtype=torch.float32,
                                         device=dev)
        self.n_substeps = n_substeps

    def _obs(self, qpos: torch.Tensor, qvel: torch.Tensor) -> torch.Tensor:
        return torch.cat([qpos[:, 2:], qvel], dim=1)

    def _start(self, idx: torch.Tensor, qvel_table: torch.Tensor) -> EnvState:
        qpos, qvel = self.clip_qpos[idx], qvel_table[idx]
        zero = torch.zeros_like(idx)
        return EnvState(
            qpos=qpos, qvel=qvel, obs=self._obs(qpos, qvel),
            reward=qpos.new_zeros(idx.shape[0]),
            done=torch.zeros(idx.shape[0], dtype=torch.bool,
                             device=self.device),
            mocap_idx=zero, init_idx=idx, step_count=zero)

    def reset(self, generator: torch.Generator, n: int) -> EnvState:
        """Each env starts at a random clip frame drawn from ``generator``
        (on the env's device)."""
        idx = torch.randint(0, self.clip_len, (n,), generator=generator,
                            device=self.device)
        return self.reset_at(idx)

    def reset_at(self, idx) -> EnvState:
        """Deterministic reset of env e to clip frame ``idx[e]``."""
        idx = torch.as_tensor(idx, dtype=torch.int64).to(self.device)
        return self._start(idx, self.clip_qvel)

    def step(self, state: EnvState, action: torch.Tensor) -> EnvState:
        qpos, qvel = engine.step(self.model, state.qpos, state.qvel, action,
                                 n_substeps=self.n_substeps)
        idx_curr = state.mocap_idx + 1
        ref = self.clip_qpos[torch.remainder(idx_curr + state.init_idx,
                                             self.clip_len)]
        err = rewards.config_l1_error(qpos[:, 3:], ref[:, 3:])
        reward_obs = torch.exp(
            -rewards.SCALE_ERR * rewards.SCALE_POSE * err)
        reward = reward_obs - 0.1 * torch.sum(torch.square(action), dim=1)
        return EnvState(
            qpos=qpos, qvel=qvel, obs=self._obs(qpos, qvel), reward=reward,
            done=root_height_done(qpos), mocap_idx=idx_curr,
            init_idx=state.init_idx, step_count=state.step_count + 1)
