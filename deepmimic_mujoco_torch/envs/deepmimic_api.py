"""The DeepMimic core-API facade (port of ``deepmimic_mujoco_tpu/envs/
deepmimic_api.py``): the imperative single-env interface of the original
C++ ``DeepMimicCore`` — ``record_state``, ``set_action``, ``update``,
``calc_reward``, ``check_terminate`` and the normalization builders — over
a batch of one env on the device.

State layout (197-D): [phase, root's lateral coordinate (the reference's
quirk), 15 × (body pos − root pos, body quat), 15 × (ω, COM velocity)];
the phase is the sim-time mocap cursor's.  ``set_action`` turns 36-D
DP-order PD targets into stable-PD torques (on the host, as in JAX) and
writes them as the controls; ``update(dt)`` advances the physics by
round(dt / model.dt) ``engine.step`` substeps.  Reward, termination and the
clip tracks come from a :class:`DeepMimicSurfaceEnv` on the same model.

``reward_mode``: 'stub' is the reference's placeholder (uniform in [−0.5,
0.5) from ``np.random.RandomState(seed)``); 'imitation' the DeepMimic
reward against the sim-time cursor."""

from __future__ import annotations

import enum

import numpy as np
import torch

from deepmimic_mujoco_torch.envs import rewards
from deepmimic_mujoco_torch.envs.deepmimic_surface import (
    ACTION_SIZE,
    STATE_SIZE,
    DeepMimicSurfaceEnv,
    dp_action_slices,
)
from deepmimic_mujoco_torch.mocap.constants import (
    BODY_JOINTS,
    DOF_DEF,
    kp_kd_vectors,
)
from deepmimic_mujoco_torch.mocap.loader import MocapClip, load_clip
from deepmimic_mujoco_torch.physics import engine, kinematics
from deepmimic_mujoco_torch.physics.humanoid import build_humanoid
from deepmimic_mujoco_torch.utils import quaternion as quat

GOAL_SIZE = 0
_ACTION_SLICES = dp_action_slices()


class ActionSpace(enum.Enum):
    """Action-space kind of :meth:`DeepMimicEnv.get_action_space`."""

    Null = 0
    Continuous = 1
    Discrete = 2


class DeepMimicEnv:
    """Single-env facade; ``qpos`` (nq,), ``qvel`` (nv,) and ``ctrl`` (nu,)
    live on the model's device."""

    def __init__(self, clip: str | MocapClip = "walk", model=None,
                 reward_mode: str = "stub", seed: int = 0,
                 device: torch.device | str | None = None):
        self.model = model if model is not None else build_humanoid(
            device=device)
        self.device = self.model.device
        if not isinstance(clip, MocapClip):
            clip = load_clip(clip)
        self.mocap = clip
        self.reward_mode = reward_mode
        self.state_size = STATE_SIZE
        self.action_size = ACTION_SIZE
        kp, kd = kp_kd_vectors()
        self._kp = np.asarray(kp, np.float32)
        self._kd = np.asarray(kd, np.float32)
        self._gear = self.model.actuator_gear.cpu().numpy()
        self._rng = np.random.RandomState(seed)
        self.ctrl = torch.zeros(self.model.nu, device=self.device)
        self.reset()
        # reward, termination and clip tracks of the surface env; its state
        # builder writes the lateral coordinate and no phase, which
        # record_state then writes from the sim time
        self._surface = DeepMimicSurfaceEnv(
            clip=clip, model=self.model,
            reward_mode="imitation_dm" if reward_mode != "stub" else "alive",
            quirk_lateral=True, write_phase=False)

    # --- scene interface ---
    def init(self):
        pass

    def reset(self):
        self.qpos = self.model.qpos0.clone()
        self.qvel = torch.zeros(self.model.nv, device=self.device)
        self._sim_time = 0.0

    def update(self, timestep: float) -> None:
        n = max(1, int(round(timestep / self.model.dt)))
        qpos, qvel = engine.step(self.model, self.qpos[None],
                                 self.qvel[None], self.ctrl[None],
                                 n_substeps=n)
        self.qpos, self.qvel = qpos[0], qvel[0]
        self._sim_time += n * self.model.dt

    def shutdown(self):
        pass

    def is_done(self):
        return False

    @property
    def mocap_idx(self) -> int:
        """The mocap cursor of the accumulated sim time, rounded (the sim
        dt does not divide the clip dt exactly)."""
        return int(round(self._sim_time / self.mocap.dt))

    def get_num_update_substeps(self):
        """Sim substeps per 30 Hz control decision (the controller spec's
        UpdateRate and the sim dt)."""
        return max(1, int(round((1.0 / 30.0) / self.model.dt)))

    # --- rl interface ---
    def is_rl_scene(self):
        return True

    def get_num_agents(self):
        return 1

    def need_new_action(self, agent_id: int = 0):
        return True

    def record_state(self, agent_id: int = 0) -> np.ndarray:
        """The (197,) float64 state: built on the device, copied once."""
        zero = torch.zeros(1, dtype=torch.int64, device=self.device)
        state = self._surface.record_state(self.qpos[None], self.qvel[None],
                                           zero)[0]
        state = state.cpu().numpy().astype(np.float64)
        state[0] = (self.mocap_idx % len(self.mocap)) / len(self.mocap)
        return state

    def record_goal(self, agent_id: int = 0) -> np.ndarray:
        return np.array([1])

    def set_action(self, agent_id: int, action) -> None:
        """PD targets → torques → controls (torque / gear)."""
        torque = np.asarray(self.action2torque(np.asarray(action)))
        self.ctrl = torch.as_tensor(torque / self._gear, dtype=torch.float32,
                                    device=self.device)

    def action2torque(self, action: np.ndarray) -> np.ndarray:
        """Stable-PD torque of DP-order targets, on the host: per dof the
        position error p_err (a spherical joint's as the rotation vector
        from its current to its target orientation, in f32), vel =
        p_err / dt, τ = kp·p_err + kd·(vel − qvel)."""
        qpos = self.qpos.cpu().numpy()
        qvel = self.qvel.cpu().numpy()
        p_err = np.zeros(self.model.nu)
        off_pos, off_vel = 7, 0
        for j in BODY_JOINTS:
            a_off, _ = _ACTION_SLICES[j]
            if DOF_DEF[j] == 3:
                angle = action[a_off]
                axis = action[a_off + 1:a_off + 4]
                nrm = np.linalg.norm(axis)
                axis = axis / nrm if nrm > 1e-9 else np.array([1.0, 0, 0])
                q_tar = np.concatenate(
                    [[np.cos(angle / 2)], np.sin(angle / 2) * axis])
                q_cur = quat.quat_from_euler_rxyz(
                    torch.as_tensor(qpos[off_pos:off_pos + 3]))
                d = quat.log_map(quat.mul(
                    quat.conj(q_cur),
                    torch.as_tensor(q_tar, dtype=torch.float32)))
                p_err[off_vel:off_vel + 3] = d.numpy()
                off_pos += 3
                off_vel += 3
            else:
                p_err[off_vel] = action[a_off] - qpos[off_pos]
                off_pos += 1
                off_vel += 1
        vel = p_err / self.model.dt
        return self._kp * p_err + self._kd * (vel - qvel[6:])

    def get_state_size(self, agent_id: int = 0):
        return self.state_size

    def get_goal_size(self, agent_id: int = 0):
        return GOAL_SIZE

    def get_action_size(self, agent_id: int = 0):
        return self.action_size

    def get_action_space(self, agent_id: int = 0) -> ActionSpace:
        return ActionSpace.Continuous

    # --- normalization builders ---
    def build_state_offset(self, agent_id: int = 0):
        return np.zeros(self.state_size)

    def build_state_scale(self, agent_id: int = 0):
        return np.ones(self.state_size)

    def build_goal_offset(self, agent_id: int = 0):
        return np.array([])

    def build_goal_scale(self, agent_id: int = 0):
        return np.array([])

    def build_action_offset(self, agent_id: int = 0):
        return np.zeros(self.action_size)

    def build_action_scale(self, agent_id: int = 0):
        return np.ones(self.action_size)

    def build_action_bound_min(self, agent_id: int = 0):
        return -10 * np.ones(self.action_size)

    def build_action_bound_max(self, agent_id: int = 0):
        return 10 * np.ones(self.action_size)

    def build_state_norm_groups(self, agent_id: int = 0):
        tmp = np.zeros(self.state_size)
        tmp[-1] = 1
        return tmp

    def build_goal_norm_groups(self, agent_id: int = 0):
        return np.array([])

    def calc_reward(self, agent_id: int = 0) -> float:
        if self.reward_mode == "stub":
            return float(self._rng.rand() - 0.5)
        env, qp, qv = self._surface, self.qpos[None], self.qvel[None]
        kin = kinematics.fk(self.model, qp)
        cursor = torch.full((1,), self.mocap_idx, dtype=torch.int64,
                            device=self.device)
        i, cycles = env._clip_index(cursor, torch.zeros_like(cursor))
        offset = cycles[:, None] * env.cycle_offset
        ref_qp = env.clip_qpos[i]
        ref_qp = torch.cat([ref_qp[:, 0:3] + offset, ref_qp[:, 3:]], dim=1)
        ee = kinematics.geom_world_pos(self.model, kin)[:, env._ee_geoms]
        return float(rewards.deepmimic_reward(
            qp, qv, ref_qp, env.clip_qvel[i], ee_pos=ee,
            ref_ee_pos=env.clip_ee[i] + offset[:, None],
            com_vel=kinematics.com_velocity(self.model, kin, qv),
            ref_com_vel=env.clip_com_vel[i])[0])

    def is_episode_end(self):
        return False

    def check_terminate(self, agent_id: int = 0):
        """1 (FAIL) when a disallowed body touches the floor, else 0."""
        fell = self._surface.fall_contact(kinematics.fk(self.model,
                                                        self.qpos[None]))
        return 1 if bool(fell[0]) else 0

    def check_valid_episode(self):
        return True

    def log_val(self, agent_id, val):
        pass

    def set_sample_count(self, count):
        pass

    def set_mode(self, mode):
        pass
