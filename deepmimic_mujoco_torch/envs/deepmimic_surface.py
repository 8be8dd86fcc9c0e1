"""The original DeepMimic training surface, batched (port of
``deepmimic_mujoco_tpu/envs/deepmimic_surface.py``): the 197-D
``record_state`` observation and the 36-D DP-order PD-target action that
the original learning stack trains on.

* obs = [phase, root height, 15 × (body pos − root pos, body quat),
  15 × (ω, COM velocity)] = 197; the wrists (geoms of the elbow bodies)
  take their geom anchors.  ``write_phase=False`` leaves the phase at 0,
  ``quirk_lateral=True`` writes the root's lateral coordinate in place of
  its height (the reference's two quirks).
* action = 8 spherical joints as (angle, axis) 4-D slices and 4 revolute
  scalars in DP order = 36, turned into per-hinge targets
  (:func:`action_to_targets`) that a joint PD controller tracks at every
  RK4 stage (``engine.step_pd``, ``n_substeps`` substeps per control step).
* reward = the DeepMimic imitation reward against the clip cursor
  (``imitation_dm``) or 1 per step (``alive``).
* termination = fall contact (a disallowed body touches the floor), the
  end of a non-looping clip, and an optional step cap.

The cursor is ``DPEnvV3``'s: it counts control steps and maps them to clip
frames in f32, rounding half to even."""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from deepmimic_mujoco_torch.envs import rewards
from deepmimic_mujoco_torch.envs.dp_env_v3 import DPEnvV3
from deepmimic_mujoco_torch.envs.types import EnvState
from deepmimic_mujoco_torch.mocap.constants import (
    BODY_DEFS,
    BODY_JOINTS,
    BODY_JOINTS_IN_DP_ORDER,
    DOF_DEF,
    END_EFFECTORS,
    kp_kd_vectors,
)
from deepmimic_mujoco_torch.mocap.loader import MocapClip, load_clip
from deepmimic_mujoco_torch.physics import (
    collision,
    dynamics,
    engine,
    kinematics,
)
from deepmimic_mujoco_torch.physics.humanoid import build_humanoid
from deepmimic_mujoco_torch.physics.model import PhysicsModel
from deepmimic_mujoco_torch.utils import quaternion as quat

STATE_SIZE = 197
ACTION_SIZE = 36

# fall-contact body indices (into mocap.constants.BODY_DEFS) when no arg
# file exists: every body except the ankles (5, 11), the list carried by
# all train_humanoid3d_*_args.txt files
DEFAULT_FALL_CONTACT_BODIES = (0, 1, 2, 3, 4, 6, 7, 8, 9, 10, 12, 13, 14)

_ARGS_DIR = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "assets", "args"))


def dp_action_slices() -> dict:
    """DP-order action layout: joint → (offset, width), 4 per spherical
    joint (angle + axis) and 1 per revolute joint."""
    out, off = {}, 0
    for j in BODY_JOINTS_IN_DP_ORDER:
        n = 4 if DOF_DEF[j] == 3 else 1
        out[j] = (off, n)
        off += n
    if off != ACTION_SIZE:
        raise AssertionError(f"DP action layout has {off} entries")
    return out


_ACTION_SLICES = dp_action_slices()


def load_fall_contact_bodies(clip_name: str) -> tuple:
    """``--fall_contact_bodies`` of ``assets/args/train_humanoid3d_<clip>_
    args.txt``.  Precedence: ``--enable_char_contact_fall false`` gives
    ``()`` (the floor-borne skills); an arg file without a body list gives
    ``()``; a missing arg file gives :data:`DEFAULT_FALL_CONTACT_BODIES`."""
    short = clip_name.replace("humanoid3d_", "")
    path = os.path.join(_ARGS_DIR, f"train_humanoid3d_{short}_args.txt")
    try:
        with open(path) as f:
            toks = f.read().split()
    except OSError:
        return DEFAULT_FALL_CONTACT_BODIES
    if "--enable_char_contact_fall" in toks:
        i = toks.index("--enable_char_contact_fall")
        if i + 1 < len(toks) and toks[i + 1].lower() == "false":
            return ()
    if "--fall_contact_bodies" not in toks:
        return ()
    out = []
    for t in toks[toks.index("--fall_contact_bodies") + 1:]:
        if t.startswith("--"):
            break
        out.append(int(t))
    return tuple(out)


def action_to_targets(action: torch.Tensor) -> torch.Tensor:
    """(B, 36) DP-order PD actions → (B, 28) hinge targets in qpos[7:]
    order.  A spherical slice (angle, axis) becomes a quaternion about the
    normalised axis (the x axis where the axis' norm is ≤ 1e-9), then its
    euler-rxyz hinge triple; a revolute scalar passes through."""
    outs = []
    for j in BODY_JOINTS:
        off, n = _ACTION_SLICES[j]
        if n == 4:
            half = 0.5 * action[:, off]
            axis = action[:, off + 1:off + 4]
            nrm = torch.sqrt(torch.sum(axis * axis, dim=-1, keepdim=True))
            x_axis = axis.new_tensor([1.0, 0.0, 0.0]).expand_as(axis)
            axis = torch.where(nrm > 1e-9, axis / torch.clamp(nrm, min=1e-9),
                               x_axis)
            q = torch.cat([torch.cos(half)[:, None],
                           torch.sin(half)[:, None] * axis], dim=1)
            outs.append(quat.euler_rxyz_from_quat(q))
        else:
            outs.append(action[:, off:off + 1])
    return torch.cat(outs, dim=1)


def targets_to_action(targets: np.ndarray) -> np.ndarray:
    """Inverse of :func:`action_to_targets` for one (28,) target vector,
    host-side (f32 on the CPU, as JAX computes it): each hinge triple
    becomes (angle, axis), the x axis where the axis vanishes."""
    action = np.zeros(ACTION_SIZE, np.float32)
    off_t = 0
    for j in BODY_JOINTS:
        off, n = _ACTION_SLICES[j]
        if n == 4:
            e = torch.as_tensor(np.asarray(targets[off_t:off_t + 3],
                                           np.float32))
            axis, angle = quat.to_axis_angle(quat.quat_from_euler_rxyz(e))
            axis = axis.numpy()
            if np.linalg.norm(axis) < 1e-9:
                axis = np.array([1.0, 0.0, 0.0])
            action[off] = float(angle)
            action[off + 1:off + 4] = axis
            off_t += 3
        else:
            action[off] = targets[off_t]
            off_t += 1
    return action


class DeepMimicSurfaceEnv:
    """Batched functional env over the original DeepMimic RL surface; all
    per-env state is in :class:`EnvState`, on the model's device."""

    observation_size = STATE_SIZE
    action_size = ACTION_SIZE
    state_size = STATE_SIZE
    goal_size = 0

    # the cursor of DPEnvV3: f32 multiply, round half to even
    _clip_pos = DPEnvV3._clip_pos
    _clip_index = DPEnvV3._clip_index
    _clip_over = DPEnvV3._clip_over

    def __init__(self, clip: str | MocapClip = "walk",
                 model: Optional[PhysicsModel] = None,
                 reward_mode: str = "imitation_dm", n_substeps: int = 2,
                 max_episode_steps: int = 300, write_phase: bool = True,
                 quirk_lateral: bool = False,
                 fall_contact_bodies: Optional[Sequence[int]] = None,
                 clip_velocities: str = "consistent",
                 device: torch.device | str | None = None):
        if reward_mode not in ("imitation_dm", "alive"):
            raise ValueError(f"unknown reward_mode {reward_mode!r}")
        if clip_velocities not in ("consistent", "reference"):
            raise ValueError(f"unknown clip_velocities {clip_velocities!r}")
        self.model = model if model is not None else build_humanoid(
            device=device)
        self.device = dev = self.model.device
        clip_name = clip if isinstance(clip, str) else "walk"
        if not isinstance(clip, MocapClip):
            clip = load_clip(clip)
        self.clip = clip
        self.clip_len = len(clip)
        # 'consistent': the continuous pose track and integrator-consistent
        # velocities; 'reference': the verbatim conversion
        consistent = clip_velocities == "consistent"
        self.clip_qpos = torch.as_tensor(
            clip.qpos_cont if consistent else clip.qpos,
            dtype=torch.float32, device=dev)
        self.clip_qvel = torch.as_tensor(
            clip.qvel_fd if consistent else clip.qvel,
            dtype=torch.float32, device=dev)
        self.clip_wraps = clip.loop == "wrap"
        off = np.zeros(3)
        if self.clip_wraps:
            off = np.asarray(clip.qpos[-1, 0:3] - clip.qpos[0, 0:3])
            off[2] = 0.0
        self.cycle_offset = torch.as_tensor(off, dtype=torch.float32,
                                            device=dev)
        self.reward_mode = reward_mode
        self.n_substeps = n_substeps
        # clip frames advanced per control step, multiplied in f32
        self.cursor_scale = float((max(n_substeps, 1) * self.model.dt)
                                  / clip.dt)
        self._cursor_scale = torch.tensor(self.cursor_scale,
                                          dtype=torch.float32, device=dev)
        self.max_episode_steps = max_episode_steps
        self.write_phase = write_phase
        self.quirk_lateral = quirk_lateral

        kp, kd = kp_kd_vectors()
        self._kp = torch.as_tensor(kp, dtype=torch.float32, device=dev)
        self._kd = torch.as_tensor(kd, dtype=torch.float32, device=dev)
        self._dynamics = lambda qp, qv, target: engine.step_pd(
            self.model, qp, qv, target, self._kp, self._kd,
            n_substeps=self.n_substeps)

        # BODY_DEFS → body and geom indices (the wrists are geoms of the
        # elbow bodies)
        bodies, geoms = self.model.body_names, self.model.geom_names
        is_wrist = [n.endswith("wrist") for n in BODY_DEFS]
        body_idx = [bodies.index(n.replace("wrist", "elbow") if w else n)
                    for n, w in zip(BODY_DEFS, is_wrist)]

        def index(x):
            return torch.as_tensor(x, dtype=torch.int64, device=dev)

        self._bodydef_body = index(body_idx)
        self._bodydef_geom = index([geoms.index(n) for n in BODY_DEFS])
        self._is_wrist = torch.as_tensor(is_wrist, device=dev)[:, None]

        if fall_contact_bodies is None:
            fall_contact_bodies = load_fall_contact_bodies(clip_name)
        self.fall_contact_bodies = tuple(fall_contact_bodies)
        disallowed = np.zeros(self.model.nbody, bool)
        for i in self.fall_contact_bodies:
            disallowed[body_idx[i]] = True
        cand = self.model.cand_body.cpu().numpy()
        self._fall_cand = torch.as_tensor(disallowed[cand], device=dev)

        self._ee_geoms = index([geoms.index(n) for n in END_EFFECTORS])
        if reward_mode == "imitation_dm":
            # the clip's end-effector and COM-velocity tracks, every frame
            kin = kinematics.fk(self.model, self.clip_qpos)
            self.clip_ee = kinematics.geom_world_pos(
                self.model, kin)[:, self._ee_geoms]                 # (T, 4, 3)
            self.clip_com_vel = kinematics.com_velocity(
                self.model, kin, self.clip_qvel)                    # (T, 3)

    # --- normalizer bootstrap builders of the DeepMimic API -------------
    def build_state_offset(self):
        return np.zeros(self.state_size)

    def build_state_scale(self):
        return np.ones(self.state_size)

    def build_state_norm_groups(self):
        tmp = np.zeros(self.state_size)
        tmp[-1] = 1
        return tmp

    def build_action_offset(self):
        return np.zeros(self.action_size)

    def build_action_scale(self):
        return np.ones(self.action_size)

    def build_action_bound_min(self):
        return -10 * np.ones(self.action_size)

    def build_action_bound_max(self):
        return 10 * np.ones(self.action_size)

    # ------------------------------------------------------------------
    def record_state(self, qpos: torch.Tensor, qvel: torch.Tensor,
                     mocap_idx: torch.Tensor,
                     kin: Optional[kinematics.Kin] = None,
                     init_idx: torch.Tensor | int = 0) -> torch.Tensor:
        """The (B, 197) state."""
        if kin is None:
            kin = kinematics.fk(self.model, qpos)
        geom_pos = kinematics.geom_world_pos(self.model, kin)
        omega, v_com, _, _ = dynamics.body_velocities(self.model, kin, qvel)
        pos = torch.where(self._is_wrist, geom_pos[:, self._bodydef_geom],
                          kin.xpos[:, self._bodydef_body])
        xquat = kin.xquat[:, self._bodydef_body]
        cvel = torch.cat([omega, v_com], dim=2)[:, self._bodydef_body]
        root = pos[:, 0]
        B = qpos.shape[0]
        if self.write_phase:
            if not isinstance(init_idx, torch.Tensor):
                init_idx = torch.full_like(mocap_idx, init_idx)
            idx, _ = self._clip_index(mocap_idx, init_idx)
            phase = idx.to(torch.float32) / self.clip_len
        else:
            phase = qpos.new_zeros(B)
        coord = root[:, 1] if self.quirk_lateral else root[:, 2]
        body_block = torch.cat([pos - root[:, None], xquat], dim=2)
        return torch.cat([phase[:, None], coord[:, None],
                          body_block.reshape(B, -1), cvel.reshape(B, -1)],
                         dim=1)

    def _state(self, qpos, qvel, init_idx, mocap_idx) -> EnvState:
        B = qpos.shape[0]
        return EnvState(
            qpos=qpos, qvel=qvel,
            obs=self.record_state(qpos, qvel, mocap_idx, init_idx=init_idx),
            reward=qpos.new_zeros(B),
            done=torch.zeros(B, dtype=torch.bool, device=self.device),
            mocap_idx=mocap_idx, init_idx=init_idx,
            step_count=torch.zeros(B, dtype=torch.int64, device=self.device))

    def reset(self, generator: torch.Generator, n: int) -> EnvState:
        """Reference-state initialization: each env starts at a random
        clip frame drawn from ``generator`` (on the env's device)."""
        idx = torch.randint(0, self.clip_len, (n,), generator=generator,
                            device=self.device)
        return self.reset_at(idx)

    def reset_at(self, idx) -> EnvState:
        """Deterministic reset of env e to clip frame ``idx[e]``."""
        if not isinstance(idx, torch.Tensor):
            idx = torch.tensor(np.asarray(idx))
        idx = idx.to(dtype=torch.int64, device=self.device)
        return self._state(self.clip_qpos[idx], self.clip_qvel[idx], idx, idx)

    def fall_contact(self, kin: kinematics.Kin) -> torch.Tensor:
        """(B,) true where a disallowed body touches the floor (the full
        candidate set, not the top-k the solver keeps)."""
        active = collision.floor_contacts(self.model, kin).active
        return torch.any(active & self._fall_cand, dim=1)

    # ------------------------------------------------------------------
    def step(self, state: EnvState, action: torch.Tensor) -> EnvState:
        targets = action_to_targets(action)
        qpos, qvel = self._dynamics(state.qpos, state.qvel, targets)
        kin = kinematics.fk(self.model, qpos)

        done = self.fall_contact(kin)
        if self.max_episode_steps:
            done = done | (state.step_count + 1 >= self.max_episode_steps)

        mocap_idx = state.mocap_idx + 1
        if self.reward_mode == "imitation_dm":
            idx, cycles = self._clip_index(mocap_idx, state.init_idx)
            offset = cycles[:, None] * self.cycle_offset  # root re-basing
            ref_qp = self.clip_qpos[idx]
            ref_qp = torch.cat([ref_qp[:, 0:3] + offset, ref_qp[:, 3:]], dim=1)
            ee = kinematics.geom_world_pos(self.model, kin)[:, self._ee_geoms]
            reward = rewards.deepmimic_reward(
                qpos, qvel, ref_qp, self.clip_qvel[idx], ee_pos=ee,
                ref_ee_pos=self.clip_ee[idx] + offset[:, None],
                com_vel=kinematics.com_velocity(self.model, kin, qvel),
                ref_com_vel=self.clip_com_vel[idx])
        else:
            reward = qpos.new_ones(qpos.shape[0])
        if not self.clip_wraps:
            done = done | self._clip_over(mocap_idx, state.init_idx)

        return EnvState(
            qpos=qpos, qvel=qvel,
            obs=self.record_state(qpos, qvel, mocap_idx, kin,
                                  init_idx=state.init_idx),
            reward=reward, done=done,
            mocap_idx=mocap_idx, init_idx=state.init_idx,
            step_count=state.step_count + 1)
