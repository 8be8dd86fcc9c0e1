"""DPEnv v3, batched (port of ``deepmimic_mujoco_tpu/envs/dp_env_v3.py`` on
its default configuration):

* obs = qpos[7:] ‖ qvel[6:] (56-D, the legacy obs: root excluded)
* ``reset``: random mocap frame; ``reset_at``: a given frame;
  ``reset_init``: ±``reset_noise`` uniform noise around the standing qpos0
* step: torque control, ``n_substeps`` physics steps per control step
* reward: 1.0 alive bonus
* termination: whole-body CoM height outside (0.7, 2.0)

The imitation configurations (other ``reward_mode``s, PD control,
fall-contact termination, the root-aware obs) are ROADMAP.md queue A item
"Imitation recipe" and raise ``NotImplementedError`` here."""

from __future__ import annotations

from typing import Optional

import torch

from deepmimic_mujoco_torch.envs.types import EnvState
from deepmimic_mujoco_torch.mocap.loader import MocapClip, load_clip
from deepmimic_mujoco_torch.physics import engine, kinematics
from deepmimic_mujoco_torch.physics.humanoid import build_humanoid
from deepmimic_mujoco_torch.physics.model import PhysicsModel

_LATER = "is not ported yet (ROADMAP.md, queue A, item 'Imitation recipe')"


class DPEnvV3:
    """Batched functional environment; all per-env state is in
    :class:`EnvState`, on the model's device."""

    observation_size = 56
    action_size = 28

    def __init__(self, clip: str | MocapClip = "walk",
                 model: Optional[PhysicsModel] = None,
                 reward_mode: str = "alive", n_substeps: int = 1,
                 reset_noise: float = 0.01, control_mode: str = "torque",
                 max_episode_steps: int = 0, obs_mode: Optional[str] = None,
                 termination: Optional[str] = None,
                 device: torch.device | str | None = None):
        if reward_mode != "alive":
            raise NotImplementedError(f"reward_mode {reward_mode!r} {_LATER}")
        if control_mode != "torque":
            raise NotImplementedError(f"control_mode {control_mode!r} {_LATER}")
        if obs_mode not in (None, "legacy"):
            raise NotImplementedError(f"obs_mode {obs_mode!r} {_LATER}")
        if termination not in (None, "com"):
            raise NotImplementedError(f"termination {termination!r} {_LATER}")
        self.model = model if model is not None else build_humanoid(device=device)
        self.device = self.model.device
        self.reward_mode = reward_mode
        self.control_mode = control_mode
        self.n_substeps = n_substeps
        self.reset_noise = reset_noise
        self.max_episode_steps = max_episode_steps
        if not isinstance(clip, MocapClip):
            clip = load_clip(clip)
        self.clip = clip
        self.clip_len = len(clip)
        # integrator-consistent clip tracks (the reference env's default
        # clip_velocities='consistent')
        self.clip_qpos = torch.as_tensor(clip.qpos_cont, dtype=torch.float32,
                                         device=self.device)
        self.clip_qvel = torch.as_tensor(clip.qvel_fd, dtype=torch.float32,
                                         device=self.device)

    # ------------------------------------------------------------------
    @staticmethod
    def _obs(qpos: torch.Tensor, qvel: torch.Tensor) -> torch.Tensor:
        return torch.cat([qpos[:, 7:], qvel[:, 6:]], dim=1)

    def _state(self, qpos, qvel, init_idx, mocap_idx) -> EnvState:
        B = qpos.shape[0]
        return EnvState(
            qpos=qpos, qvel=qvel, obs=self._obs(qpos, qvel),
            reward=qpos.new_zeros(B),
            done=torch.zeros(B, dtype=torch.bool, device=self.device),
            mocap_idx=mocap_idx, init_idx=init_idx,
            step_count=torch.zeros(B, dtype=torch.int64, device=self.device))

    def reset(self, generator: torch.Generator, n: int) -> EnvState:
        """Reference-state initialization: each env starts at a random mocap
        frame drawn from ``generator`` (on the env's device)."""
        idx = torch.randint(0, self.clip_len, (n,), generator=generator,
                            device=self.device)
        return self.reset_at(idx)

    def reset_at(self, idx) -> EnvState:
        """Deterministic reset of env e to mocap frame ``idx[e]``."""
        if isinstance(idx, torch.Tensor):
            idx = idx.to(dtype=torch.int64, device=self.device)
        else:
            idx = torch.tensor(idx, dtype=torch.int64, device=self.device)
        return self._state(self.clip_qpos[idx], self.clip_qvel[idx], idx, idx)

    def reset_init(self, generator: torch.Generator, n: int) -> EnvState:
        """Noise reset around the standing pose: qpos0 + U(−c, c) and
        qvel = U(−c, c), c = ``reset_noise``, drawn from ``generator``."""
        c = self.reset_noise
        m = self.model
        u_q = torch.rand((n, m.nq), generator=generator, device=self.device)
        u_v = torch.rand((n, m.nv), generator=generator, device=self.device)
        qpos = m.qpos0 + (u_q * (2 * c) - c)
        qvel = u_v * (2 * c) - c
        zero = torch.zeros(n, dtype=torch.int64, device=self.device)
        return self._state(qpos, qvel, zero, zero)

    # ------------------------------------------------------------------
    def step(self, state: EnvState, action: torch.Tensor) -> EnvState:
        qpos, qvel = engine.step(self.model, state.qpos, state.qvel, action,
                                 n_substeps=self.n_substeps)
        com = kinematics.mass_center(self.model, kinematics.fk(self.model, qpos))
        done = (com[:, 2] < 0.7) | (com[:, 2] > 2.0)
        if self.max_episode_steps:
            done = done | (state.step_count + 1 >= self.max_episode_steps)
        return EnvState(
            qpos=qpos, qvel=qvel, obs=self._obs(qpos, qvel),
            reward=torch.ones_like(com[:, 2]), done=done,
            mocap_idx=state.mocap_idx, init_idx=state.init_idx,
            step_count=state.step_count + 1)
