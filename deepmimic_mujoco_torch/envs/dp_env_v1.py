"""DPEnv v1, batched (port of ``deepmimic_mujoco_tpu/envs/dp_env_v1.py``):
the legacy weighted quaternion-reward env.

* physics: ``build_humanoid(dt=0.002)``, 6 ``engine.step`` substeps per
  control step; obs = qpos[2:] ‖ qvel (67-D)
* the reward fires every ``update_interval = mocap_dt // (dt·n_substeps)``
  control steps (2 for walk) and is 0 between; the reference frame is
  (mocap_idx // update_interval + init_idx) mod T
* reward = 0.5·exp(−2·e_pose) + 0.05·exp(−0.1·e_vel) + 0.2·exp(−5·e_root)
  − 0.1·Σaction², with e_pose the JOINT_WEIGHT-weighted quaternion angles
  of the root and the joints, e_vel Σ|table qvel[3:] − qvel[3:]| and e_root
  Σ|Δroot xyz|
* reset: a random clip frame with the velocity of the velocity table
  ``_reset_qvel`` (finite differences between the neighbouring frames)
* termination: root height outside (0.7, 2.0)

The table keeps the reference's double alignment: its angular velocities
are rotated by Rx(90°), (x, y, z) → (x, −z, y).  It is computed once, in
f32 as in JAX, batched over the frames on the host."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deepmimic_mujoco_torch.envs import rewards
from deepmimic_mujoco_torch.envs.dp_env_v2 import DPEnvV2, root_height_done
from deepmimic_mujoco_torch.envs.types import EnvState
from deepmimic_mujoco_torch.mocap.constants import JOINT_WEIGHT
from deepmimic_mujoco_torch.mocap.loader import MocapClip
from deepmimic_mujoco_torch.physics import engine
from deepmimic_mujoco_torch.physics.model import PhysicsModel
from deepmimic_mujoco_torch.utils import quaternion as quat

_ROOT_W = float(JOINT_WEIGHT["root"])


def _double_aligned(v: torch.Tensor) -> torch.Tensor:
    """(…, 3) rotated by Rx(90°): (x, y, z) → (x, −z, y)."""
    return torch.stack([v[..., 0], -v[..., 2], v[..., 1]], dim=-1)


def reset_qvel_table(qpos: np.ndarray, mocap_dt: float) -> torch.Tensor:
    """(T, 34) f32 reset velocities of a clip's (T, 35) qpos (on the
    CPU): per frame the difference from the previous to the next frame (the
    last frame from the one before it to itself, the first from itself to
    the next) over ``mocap_dt``; the root and spherical joints through
    :func:`quat.angular_velocity` in f32, double-aligned."""
    qp = np.asarray(qpos, np.float64)
    nxt = np.roll(qp, -1, axis=0)
    nxt[-1] = qp[-1]
    prv = qp.copy()
    prv[-1] = qp[-2]
    table = np.zeros((qp.shape[0], qp.shape[1] - 1))
    table[:, :3] = (nxt[:, :3] - prv[:, :3]) / mocap_dt

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32)

    w = quat.angular_velocity(f32(prv[:, 3:7]), f32(nxt[:, 3:7]), mocap_dt)
    table[:, 3:6] = _double_aligned(w).numpy()
    sph = 7 + rewards._SPH_IDX                                 # (8, 3)
    w = quat.angular_velocity(quat.quat_from_euler_rxyz(f32(prv[:, sph])),
                              quat.quat_from_euler_rxyz(f32(nxt[:, sph])),
                              mocap_dt)
    table[:, sph - 1] = _double_aligned(w).numpy()
    one = 7 + rewards._ONE_OFF
    table[:, one - 1] = (nxt[:, one] - prv[:, one]) / mocap_dt
    return f32(table)


class DPEnvV1(DPEnvV2):
    """Batched functional environment; all per-env state is in
    :class:`EnvState`, on the model's device."""

    def __init__(self, clip: str | MocapClip = "walk",
                 model: Optional[PhysicsModel] = None, n_substeps: int = 6,
                 device: torch.device | str | None = None):
        super().__init__(clip, model, n_substeps, device)
        self.mocap_dt = float(self.clip.dt)
        # the reward's gating period, from Python floats
        self.update_interval = max(
            1, int(self.mocap_dt // (self.model.dt * n_substeps)))
        self._reset_qvel = reset_qvel_table(
            self.clip.qpos, self.mocap_dt).to(self.device)

    def reset_at(self, idx) -> EnvState:
        """Deterministic reset of env e to clip frame ``idx[e]``, with the
        table's velocity."""
        idx = torch.as_tensor(idx, dtype=torch.int64).to(self.device)
        return self._start(idx, self._reset_qvel)

    def _pose_error(self, qpos: torch.Tensor, ref_qpos: torch.Tensor
                    ) -> torch.Tensor:
        """Weighted quaternion-angle pose error, the root's orientation
        included, summed in JAX's order (root, spherical, 1-dof)."""
        err = _ROOT_W * torch.abs(quat.angle_between(qpos[:, 3:7],
                                                     ref_qpos[:, 3:7]))
        j, r = qpos[:, 7:], ref_qpos[:, 7:]
        ang = torch.abs(rewards._sph_angles(j, r))
        err = err + torch.sum(rewards._t("sph_w", j) * ang, dim=1)
        one = rewards._t("one", j)
        d1 = torch.abs(j[:, one] - r[:, one])
        return err + torch.sum(rewards._t("one_w", j) * d1, dim=1)

    def step(self, state: EnvState, action: torch.Tensor) -> EnvState:
        qpos, qvel = engine.step(self.model, state.qpos, state.qvel, action,
                                 n_substeps=self.n_substeps)
        idx_curr = state.mocap_idx + 1
        idx_mocap = torch.remainder(
            torch.div(idx_curr, self.update_interval, rounding_mode="floor")
            + state.init_idx, self.clip_len)
        ref_qp = self.clip_qpos[idx_mocap]
        e_pose = self._pose_error(qpos, ref_qp)
        e_vel = torch.sum(torch.abs(self._reset_qvel[idx_mocap][:, 3:]
                                    - qvel[:, 3:]), dim=1)
        e_root = torch.sum(torch.abs(qpos[:, :3] - ref_qp[:, :3]), dim=1)
        reward_obs = (0.5 * torch.exp(-2.0 * e_pose)
                      + 0.05 * torch.exp(-0.1 * e_vel)
                      + 0.2 * torch.exp(-5.0 * e_root))
        gated = torch.remainder(idx_curr, self.update_interval) == 0
        reward_obs = torch.where(gated, reward_obs, 0.0)
        reward = reward_obs - 0.1 * torch.sum(torch.square(action), dim=1)
        return EnvState(
            qpos=qpos, qvel=qvel, obs=self._obs(qpos, qvel), reward=reward,
            done=root_height_done(qpos), mocap_idx=idx_curr,
            init_idx=state.init_idx, step_count=state.step_count + 1)
