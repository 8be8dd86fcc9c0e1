"""DPEnv v3, batched (port of ``deepmimic_mujoco_tpu/envs/dp_env_v3.py``).

Defaults, the reference's standup task:

* obs = qpos[7:] ‖ qvel[6:] (56-D, the legacy obs: root excluded)
* ``reset``: random mocap frame; ``reset_at``: a given frame;
  ``reset_init``: ±``reset_noise`` uniform noise around the standing qpos0
* step: torque control, ``n_substeps`` physics steps per control step
* reward: 1.0 alive bonus
* termination: whole-body CoM height outside (0.7, 2.0)

The imitation recipe (README "Quick start"): ``reward_mode`` 'imitation'
or 'imitation_dm' default to the root-aware 'full' obs with the clip phase
prepended (68-D) and to 'fall_contact' termination; ``control_mode``
'pd_residual' tracks the clip pose plus the action with a joint PD
controller (``engine.step_pd``), stepping the clip target once per substep
(``pd_target_interp``).  The mocap cursor counts control steps and maps to
clip frames through ``_clip_index`` (``cursor_scale`` frames per control
step; looping clips wrap and re-base the root per cycle, the others clamp
and end the episode at the last frame).

``dynamics="mujoco"`` (the JAX package's host-MuJoCo A/B backend) is not
ported and raises, naming ROADMAP.md."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deepmimic_mujoco_torch.envs import rewards
from deepmimic_mujoco_torch.envs.types import EnvState
from deepmimic_mujoco_torch.mocap.constants import (
    BODY_DEFS,
    END_EFFECTORS,
    kp_kd_vectors,
)
from deepmimic_mujoco_torch.mocap.loader import MocapClip, load_clip
from deepmimic_mujoco_torch.physics import collision, engine, kinematics
from deepmimic_mujoco_torch.physics.humanoid import build_humanoid
from deepmimic_mujoco_torch.physics.model import PhysicsModel
from deepmimic_mujoco_torch.utils import quaternion as quat

_IMITATION = ("imitation", "imitation_dm")


def root_obs(qpos: torch.Tensor, qvel: torch.Tensor) -> torch.Tensor:
    """Heading-invariant root features (B, 11) of the 'full' obs: root
    height, the root quaternion with its heading removed (w ≥ 0), the
    heading-local root linear velocity and the body-local root angular
    velocity.  q is flipped to w ≥ 0 twice: before and after the heading
    is removed."""
    q = qpos[:, 3:7]
    q = torch.where(q[:, :1] < 0, -q, q)
    hq = quat.heading_inverse(q)
    q_local = quat.mul(hq, q)
    q_local = torch.where(q_local[:, :1] < 0, -q_local, q_local)
    v_local = quat.rotate(hq, qvel[:, 0:3])
    return torch.cat([qpos[:, 2:3], q_local, v_local, qvel[:, 3:6]], dim=1)


class DPEnvV3:
    """Batched functional environment; all per-env state is in
    :class:`EnvState`, on the model's device."""

    observation_size = 56
    action_size = 28

    def __init__(self, clip: str | MocapClip = "walk",
                 model: Optional[PhysicsModel] = None,
                 reward_mode: str = "alive", n_substeps: int = 1,
                 reset_noise: float = 0.01, dynamics: str = "torch",
                 control_mode: str = "torque",
                 include_phase: Optional[bool] = None,
                 max_episode_steps: int = 0, obs_mode: Optional[str] = None,
                 termination: Optional[str] = None,
                 pd_target_interp: bool = True,
                 clip_velocities: str = "consistent",
                 device: torch.device | str | None = None):
        if dynamics == "mujoco":
            raise NotImplementedError(
                "dynamics 'mujoco' (the host-MuJoCo A/B backend) is not "
                "ported (ROADMAP.md, queue A, item 'Parity modes and tools')")
        if dynamics != "torch":
            raise ValueError(f"unknown dynamics backend {dynamics!r}")
        if reward_mode not in ("alive", "mocap") + _IMITATION:
            raise ValueError(f"unknown reward_mode {reward_mode!r}")
        if control_mode not in ("torque", "pd", "pd_residual"):
            raise ValueError(f"unknown control_mode {control_mode!r}")
        imit = reward_mode in _IMITATION
        if obs_mode is None:
            obs_mode = "full" if imit else "legacy"
        if obs_mode not in ("legacy", "full"):
            raise ValueError(f"unknown obs_mode {obs_mode!r}")
        if termination is None:
            termination = "fall_contact" if imit else "com"
        if termination not in ("com", "fall_contact"):
            raise ValueError(f"unknown termination {termination!r}")
        if clip_velocities not in ("consistent", "reference"):
            raise ValueError(f"unknown clip_velocities {clip_velocities!r}")
        self.model = model if model is not None else build_humanoid(device=device)
        self.device = dev = self.model.device
        self.reward_mode = reward_mode
        self.control_mode = control_mode
        self.n_substeps = n_substeps
        self.reset_noise = reset_noise
        self.max_episode_steps = max_episode_steps
        self.pd_target_interp = pd_target_interp
        self.include_phase = imit if include_phase is None else include_phase
        self.obs_mode = obs_mode
        self.observation_size = (56 + (11 if obs_mode == "full" else 0)
                                 + (1 if self.include_phase else 0))
        self.termination = termination
        self.clip_velocities = clip_velocities
        clip_name = clip if isinstance(clip, str) else "walk"
        if not isinstance(clip, MocapClip):
            clip = load_clip(clip)
        self.clip = clip
        self.clip_len = len(clip)
        # 'consistent': integrator-consistent FD velocities (what RSI resets
        # and velocity targets use); 'reference': the reference's arrays
        consistent = clip_velocities == "consistent"
        self.clip_qpos = torch.as_tensor(
            clip.qpos_cont if consistent else clip.qpos,
            dtype=torch.float32, device=dev)
        self.clip_qvel = torch.as_tensor(
            clip.qvel_fd if consistent else clip.qvel,
            dtype=torch.float32, device=dev)
        # clip frames advanced per control step (clips run at 16-60 fps,
        # control at n_substeps·dt), kept as an f32 tensor: _clip_index
        # multiplies in f32, as JAX does
        self.cursor_scale = float((max(n_substeps, 1) * self.model.dt)
                                  / clip.dt)
        self._cursor_scale = torch.tensor(self.cursor_scale,
                                          dtype=torch.float32, device=dev)
        self.clip_wraps = clip.loop == "wrap"
        off = np.zeros(3)
        if self.clip_wraps:
            off = np.asarray(clip.qpos[-1, 0:3] - clip.qpos[0, 0:3])
            off[2] = 0.0
        self.cycle_offset = torch.as_tensor(off, dtype=torch.float32,
                                            device=dev)
        names = self.model.geom_names
        self._ee_geoms = torch.tensor([names.index(n) for n in END_EFFECTORS],
                                      dtype=torch.int64, device=dev)
        if termination == "fall_contact":
            from deepmimic_mujoco_torch.envs.deepmimic_surface import (
                load_fall_contact_bodies,
            )

            # the wrists are geoms of the elbow bodies in this model
            disallowed = np.zeros(self.model.nbody, bool)
            for i in load_fall_contact_bodies(clip_name):
                name = BODY_DEFS[i]
                if name.endswith("wrist"):
                    name = name.replace("wrist", "elbow")
                disallowed[self.model.body_names.index(name)] = True
            cand = self.model.cand_body.cpu().numpy()
            self._fall_cand = torch.as_tensor(disallowed[cand], device=dev)
        if control_mode in ("pd", "pd_residual"):
            # 'pd': the action is the joint target; 'pd_residual': the
            # target is the clip pose plus the action (_pd_targets)
            kp, kd = kp_kd_vectors()
            self._kp = torch.as_tensor(kp, device=dev)
            self._kd = torch.as_tensor(kd, device=dev)
            self._dynamics = lambda qp, qv, target: engine.step_pd(
                self.model, qp, qv, target, self._kp, self._kd,
                n_substeps=self.n_substeps)
        else:
            self._dynamics = lambda qp, qv, ctrl: engine.step(
                self.model, qp, qv, ctrl, n_substeps=self.n_substeps)
        if imit:
            # the clip's end-effector, COM and COM-velocity tracks by FK of
            # every frame at once
            kin = kinematics.fk(self.model, self.clip_qpos)
            self.clip_ee = self._ee_pos(kin)                          # (T, 4, 3)
            self.clip_com = kinematics.mass_center(self.model, kin)  # (T, 3)
            self.clip_com_vel = kinematics.com_velocity(
                self.model, kin, self.clip_qvel)                      # (T, 3)

    # ------------------------------------------------------------------
    def _ee_pos(self, kin: kinematics.Kin) -> torch.Tensor:
        return kinematics.geom_world_pos(self.model, kin)[:, self._ee_geoms]

    def _clip_pos(self, mocap_idx: torch.Tensor, init_idx: torch.Tensor
                  ) -> torch.Tensor:
        """Frame position init + (cursor − init)·cursor_scale, in f32."""
        return (init_idx.to(torch.float32)
                + (mocap_idx - init_idx).to(torch.float32) * self._cursor_scale)

    def _clip_index(self, mocap_idx: torch.Tensor, init_idx: torch.Tensor):
        """(frame index int64, completed cycles f32) of an unbounded cursor
        (int or float) that counts control steps since the episode started
        at frame ``init_idx``.  Looping clips wrap; the others clamp at the
        last frame (0 cycles).  The position is rounded half to even
        (``torch.round``, as ``jnp.round``), and index and cycles come from
        the same rounded value: at pos ∈ [T − 0.5, T) the index wraps to 0
        and the cycle count, which re-bases the root, must wrap with it."""
        idx_r = torch.round(self._clip_pos(mocap_idx, init_idx)).long()
        if self.clip_wraps:
            return (torch.remainder(idx_r, self.clip_len),
                    torch.div(idx_r, self.clip_len,
                              rounding_mode="floor").to(torch.float32))
        return (torch.clamp(idx_r, max=self.clip_len - 1),
                torch.zeros(idx_r.shape, device=idx_r.device))

    def _clip_over(self, mocap_idx: torch.Tensor, init_idx: torch.Tensor
                   ) -> torch.Tensor:
        """Non-looping clips: the motion ends when the frame position
        reaches the last frame."""
        return self._clip_pos(mocap_idx, init_idx) >= self.clip_len - 1

    def _obs(self, qpos, qvel, mocap_idx, init_idx) -> torch.Tensor:
        parts = [qpos[:, 7:], qvel[:, 6:]]
        if self.obs_mode == "full":
            parts.insert(0, root_obs(qpos, qvel))
        if self.include_phase:
            idx, _ = self._clip_index(mocap_idx, init_idx)
            parts.insert(0, (idx.to(torch.float32) / self.clip_len)[:, None])
        return torch.cat(parts, dim=1)

    def _state(self, qpos, qvel, init_idx, mocap_idx) -> EnvState:
        B = qpos.shape[0]
        return EnvState(
            qpos=qpos, qvel=qvel,
            obs=self._obs(qpos, qvel, mocap_idx, init_idx),
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
    def _pd_targets(self, state: EnvState, action: torch.Tensor
                    ) -> torch.Tensor:
        """'pd_residual': the clip pose plus the action.  The target is the
        frame the character should reach by the end of the control step
        (the advanced cursor, in the imitation modes); with
        ``pd_target_interp`` and several substeps, a (B, S, 28) schedule of
        the frames at cursor + s/S, s = 1..S (float cursors, through
        ``_clip_index``)."""
        imit = self.reward_mode in _IMITATION
        if imit and self.pd_target_interp and self.n_substeps > 1:
            fracs = torch.arange(1, self.n_substeps + 1, dtype=torch.float32,
                                 device=self.device) / self.n_substeps
            cursor = state.mocap_idx.to(torch.float32)[:, None] + fracs
            idx_s, _ = self._clip_index(cursor, state.init_idx[:, None])
            return self.clip_qpos[idx_s][..., 7:] + action[:, None, :]
        ref_idx, _ = self._clip_index(state.mocap_idx + (1 if imit else 0),
                                      state.init_idx)
        return self.clip_qpos[ref_idx][:, 7:] + action

    def step(self, state: EnvState, action: torch.Tensor) -> EnvState:
        if self.control_mode == "pd_residual":
            action = self._pd_targets(state, action)
        qpos, qvel = self._dynamics(state.qpos, state.qvel, action)
        kin = kinematics.fk(self.model, qpos)
        com = kinematics.mass_center(self.model, kin)
        if self.termination == "fall_contact":
            # the full candidate set, not the top-k the solver keeps
            active = collision.floor_contacts(self.model, kin).active
            done = torch.any(active & self._fall_cand, dim=1)
        else:
            done = (com[:, 2] < 0.7) | (com[:, 2] > 2.0)
        if self.max_episode_steps:
            done = done | (state.step_count + 1 >= self.max_episode_steps)

        mocap_idx = state.mocap_idx
        if self.reward_mode == "alive":
            reward = torch.ones_like(com[:, 2])
        elif self.reward_mode == "mocap":
            ref = self.clip_qpos[torch.remainder(mocap_idx, self.clip_len)]
            reward = torch.exp(-rewards.config_l1_error(qpos[:, 7:],
                                                        ref[:, 7:]))
            mocap_idx = torch.remainder(mocap_idx + 1, self.clip_len)
        else:
            # the imitation modes advance the cursor BEFORE the reward: the
            # post-step pose is held against the post-step clip frame
            mocap_idx = mocap_idx + 1
            idx, cycles = self._clip_index(mocap_idx, state.init_idx)
            offset = cycles[:, None] * self.cycle_offset  # root re-basing
            ref_qp, ref_qv = self.clip_qpos[idx], self.clip_qvel[idx]
            ee = self._ee_pos(kin)
            ref_ee = self.clip_ee[idx] + offset[:, None]
            if self.reward_mode == "imitation":
                reward = rewards.imitation_reward(
                    qpos[:, 7:], ref_qp[:, 7:], qvel, ref_qv, qpos[:, 0:3],
                    ref_qp[:, 0:3] + offset, ee_pos=ee, ref_ee_pos=ref_ee,
                    com=com, ref_com=self.clip_com[idx] + offset)
            else:
                ref_qp = torch.cat([ref_qp[:, 0:3] + offset, ref_qp[:, 3:]],
                                   dim=1)
                reward = rewards.deepmimic_reward(
                    qpos, qvel, ref_qp, ref_qv, ee_pos=ee, ref_ee_pos=ref_ee,
                    com_vel=kinematics.com_velocity(self.model, kin, qvel),
                    ref_com_vel=self.clip_com_vel[idx])
            if not self.clip_wraps:
                # the motion is over: the episode ends
                done = done | self._clip_over(mocap_idx, state.init_idx)

        return EnvState(
            qpos=qpos, qvel=qvel,
            obs=self._obs(qpos, qvel, mocap_idx, state.init_idx),
            reward=reward, done=done,
            mocap_idx=mocap_idx, init_idx=state.init_idx,
            step_count=state.step_count + 1)
