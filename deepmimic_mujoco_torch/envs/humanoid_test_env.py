"""Gym-``Humanoid-v2``-style locomotion env over the DeepMimic humanoid,
batched (port of ``deepmimic_mujoco_tpu/envs/humanoid_test_env.py``).

* physics: ``build_humanoid()`` (dt 0.0166), ``n_substeps`` = 5
  ``engine.step`` substeps per control step
* obs = qpos[2:] ‖ qvel ‖ cinert ‖ cvel ‖ qfrc_actuator ‖ cfrc_ext
  (33 + 34 + 22·nbody + 34 = 387): cinert the per-body [mass, mass·COM,
  world inertia's upper triangle], cvel the per-body [ω, COM velocity],
  cfrc_ext the per-body [torque about the body's COM, force] of the floor
  contacts, from a cold ``engine.forward`` at the state (one more APGD
  solve, at ``model.iterations``)
* reward = 0.25·Δcom_x / ``model.dt`` − 0.1·Σaction² − min(0.5e-6·Σcfrc²,
  10) + 5 (the JAX version divides by the physics dt, not the control dt)
* termination: root height outside (0.8, 2.0)
* ``reset`` = ``reset_init``: qpos0 + U(−c, c), qvel = U(−c, c)
"""

from __future__ import annotations

from typing import Optional

import torch

from deepmimic_mujoco_torch.envs.types import EnvState
from deepmimic_mujoco_torch.physics import dynamics, engine, kinematics
from deepmimic_mujoco_torch.physics.humanoid import build_humanoid
from deepmimic_mujoco_torch.physics.model import PhysicsModel
from deepmimic_mujoco_torch.utils import quaternion as quat

# world inertia entries of cinert: (0,0) (1,1) (2,2) (0,1) (0,2) (1,2)
_I_ROWS, _I_COLS = [0, 1, 2, 0, 0, 1], [0, 1, 2, 1, 2, 2]


class HumanoidTestEnv:
    """Batched functional environment; all per-env state is in
    :class:`EnvState`, on the model's device."""

    action_size = 28

    def __init__(self, model: Optional[PhysicsModel] = None,
                 n_substeps: int = 5, reset_noise: float = 0.01,
                 device: torch.device | str | None = None):
        self.model = model if model is not None else build_humanoid(
            device=device)
        self.device = self.model.device
        self.n_substeps = n_substeps
        self.reset_noise = reset_noise
        nb = self.model.nbody
        self.observation_size = 33 + 34 + 10 * nb + 6 * nb + 34 + 6 * nb

    def _features(self, qpos: torch.Tensor, qvel: torch.Tensor,
                  ctrl: torch.Tensor):
        """(kin, com, obs) at the state under ``ctrl``."""
        m = self.model
        fwd = engine.forward(m, qpos, qvel, ctrl)
        kin = fwd.kin
        com = kinematics.mass_center(m, kin)
        iw = dynamics.world_inertia(m, kin)
        B = qpos.shape[0]
        mass = m.body_mass[None, :, None].expand(B, -1, 1)
        cinert = torch.cat([mass, mass * kin.xcom,
                            iw[:, :, _I_ROWS, _I_COLS]], dim=2)
        omega, v_com, _, _ = dynamics.body_velocities(m, kin, qvel)
        cvel = torch.cat([omega, v_com], dim=2)
        qfrc_act = dynamics.actuator_force(m, ctrl)
        # the floor candidates' forces, rows [z, x, y] → world (x, y, z)
        nc = m.ncand
        f = fwd.contact_force[:, :nc * 3].reshape(B, nc, 3)
        f_world = f[:, :, [1, 2, 0]]
        body = m.cand_body
        p_w = kin.xpos[:, body] + quat.rotate(kin.xquat[:, body], m.cand_pos)
        torque = torch.linalg.cross(p_w - kin.xcom[:, body], f_world)
        cfrc = qpos.new_zeros(B, m.nbody, 6)
        cfrc[:, :, 3:].index_add_(1, body, f_world)
        cfrc[:, :, :3].index_add_(1, body, torque)
        obs = torch.cat([qpos[:, 2:], qvel, cinert.reshape(B, -1),
                         cvel.reshape(B, -1), qfrc_act, cfrc.reshape(B, -1)],
                        dim=1)
        return com, obs, cfrc

    def reset_to(self, qpos: torch.Tensor, qvel: torch.Tensor) -> EnvState:
        """The episode start at the given (B, nq) qpos and (B, nv) qvel."""
        B = qpos.shape[0]
        _, obs, _ = self._features(qpos, qvel,
                                   qpos.new_zeros(B, self.model.nu))
        zero = torch.zeros(B, dtype=torch.int64, device=self.device)
        return EnvState(
            qpos=qpos, qvel=qvel, obs=obs, reward=qpos.new_zeros(B),
            done=torch.zeros(B, dtype=torch.bool, device=self.device),
            mocap_idx=zero, init_idx=zero, step_count=zero)

    def reset(self, generator: torch.Generator, n: int) -> EnvState:
        """Noise around the standing pose: qpos0 + U(−c, c) and qvel =
        U(−c, c), c = ``reset_noise``, drawn from ``generator``."""
        c, m = self.reset_noise, self.model
        u_q = torch.rand((n, m.nq), generator=generator, device=self.device)
        u_v = torch.rand((n, m.nv), generator=generator, device=self.device)
        return self.reset_to(m.qpos0 + (u_q * (2 * c) - c), u_v * (2 * c) - c)

    # the reference aliases the noise reset for this env
    reset_init = reset

    def step(self, state: EnvState, action: torch.Tensor) -> EnvState:
        m = self.model
        com_before = kinematics.mass_center(
            m, kinematics.fk(m, state.qpos))[:, 0]
        qpos, qvel = engine.step(m, state.qpos, state.qvel, action,
                                 n_substeps=self.n_substeps)
        com, obs, cfrc = self._features(qpos, qvel, action)
        lin_vel_cost = 0.25 * (com[:, 0] - com_before) / m.dt
        quad_ctrl_cost = 0.1 * torch.sum(torch.square(action), dim=1)
        quad_impact_cost = torch.clamp(
            0.5e-6 * torch.sum(torch.square(cfrc), dim=(1, 2)), max=10.0)
        reward = lin_vel_cost - quad_ctrl_cost - quad_impact_cost + 5.0
        done = (qpos[:, 2] < 0.8) | (qpos[:, 2] > 2.0)
        return EnvState(
            qpos=qpos, qvel=qvel, obs=obs, reward=reward, done=done,
            mocap_idx=state.mocap_idx, init_idx=state.init_idx,
            step_count=state.step_count + 1)
