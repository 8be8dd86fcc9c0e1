"""Multi-skill imitation env, batched (port of ``deepmimic_mujoco_tpu/envs/
multi_clip.py:DPEnvV3Multi``): one policy over several mocap clips.

The clips are stacked into padded ``(K, Tmax, ·)`` tables (each padded with
its last frame), and env e imitates clip ``state.clip_id[e]``, whose one-hot
code and phase lead the observation:

    obs = [one_hot(K) ‖ phase ‖ root_obs(11) ‖ qpos[7:] ‖ qvel[6:]]

(``obs_mode="legacy"`` drops ``root_obs``).  Control is PD on the joints
(``pd``: the action is the target; ``pd_residual``: the clip pose plus the
action, stepped once per substep with ``pd_target_interp``), the reward
``imitation`` or ``imitation_dm`` against each env's own clip (the root and
end effectors re-based by the clip's cycle offset), and termination
``fall_contact`` with each clip's own list of bodies that may not touch the
floor, or ``com``.  A clip that does not loop ends its episode at its last
frame.

As in the port's ``DPEnvV3``, the physics is one attribute,
``_dynamics(qpos, qvel, target)`` (``engine.step_pd``), so tests can swap
it."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from deepmimic_mujoco_torch.envs import rewards
from deepmimic_mujoco_torch.envs.dp_env_v3 import root_obs
from deepmimic_mujoco_torch.envs.types import EnvState
from deepmimic_mujoco_torch.mocap.constants import (
    BODY_DEFS,
    END_EFFECTORS,
    kp_kd_vectors,
)
from deepmimic_mujoco_torch.mocap.loader import load_clip
from deepmimic_mujoco_torch.physics import collision, engine, kinematics
from deepmimic_mujoco_torch.physics.humanoid import build_humanoid
from deepmimic_mujoco_torch.physics.model import PhysicsModel


class DPEnvV3Multi:
    """Batched skill-conditioned imitation env; all per-env state is in
    :class:`EnvState` (with ``clip_id``), on the model's device."""

    action_size = 28

    def __init__(self, clips: Sequence[str] = ("walk", "run", "spinkick"),
                 model: Optional[PhysicsModel] = None,
                 control_mode: str = "pd_residual", n_substeps: int = 2,
                 max_episode_steps: int = 300,
                 reward_mode: str = "imitation_dm", obs_mode: str = "full",
                 clip_weights: Optional[Sequence[float]] = None,
                 termination: str = "fall_contact",
                 clip_velocities: str = "consistent",
                 pd_target_interp: bool = True,
                 device: torch.device | str | None = None):
        """``clip_weights``: the probabilities with which ``reset`` draws a
        clip (uniform when None)."""
        if control_mode not in ("pd", "pd_residual"):
            raise ValueError(f"unknown control_mode {control_mode!r}")
        if reward_mode not in ("imitation", "imitation_dm"):
            raise ValueError(f"unknown reward_mode {reward_mode!r}")
        if obs_mode not in ("legacy", "full"):
            raise ValueError(f"unknown obs_mode {obs_mode!r}")
        if termination not in ("com", "fall_contact"):
            raise ValueError(f"unknown termination {termination!r}")
        if clip_velocities not in ("consistent", "reference"):
            raise ValueError(f"unknown clip_velocities {clip_velocities!r}")
        self.model = model if model is not None else build_humanoid(
            device=device)
        self.device = dev = self.model.device
        self.clip_names = list(clips)
        loaded = [load_clip(c) for c in clips]
        K = len(loaded)
        tmax = max(len(c) for c in loaded)
        nq, nv = self.model.nq, self.model.nv

        consistent = clip_velocities == "consistent"
        qpos = np.zeros((K, tmax, nq), np.float32)
        qvel = np.zeros((K, tmax, nv), np.float32)
        lens = np.zeros(K, np.int64)
        wraps = np.zeros(K, bool)
        cyc_off = np.zeros((K, 3), np.float32)
        for k, c in enumerate(loaded):
            T = len(c)
            cp = c.qpos_cont if consistent else c.qpos
            cv = c.qvel_fd if consistent else c.qvel
            lens[k] = T
            qpos[k, :T], qvel[k, :T] = cp, cv
            # padded with the last frame, so clamped indexing is trivial
            qpos[k, T:], qvel[k, T:] = cp[-1], cv[-1]
            wraps[k] = c.loop == "wrap"
            if wraps[k]:
                off = np.asarray(c.qpos[-1, 0:3] - c.qpos[0, 0:3])
                off[2] = 0.0
                cyc_off[k] = off
        self.num_clips = K
        self.n_substeps = n_substeps
        self.max_episode_steps = max_episode_steps
        self.control_mode = control_mode
        self.reward_mode = reward_mode
        self.obs_mode = obs_mode
        self.termination = termination
        self.clip_velocities = clip_velocities
        self.pd_target_interp = pd_target_interp
        self.observation_size = (K + 1 + (11 if obs_mode == "full" else 0)
                                 + (nq - 7) + (nv - 6))
        # clip frames advanced per control step, per clip (clips run at
        # 16-60 fps), f32: the cursor multiplies in f32, as JAX does
        control_dt = max(n_substeps, 1) * self.model.dt
        self.clip_scales = torch.tensor([control_dt / c.dt for c in loaded],
                                        dtype=torch.float32, device=dev)
        self.clip_qpos = torch.as_tensor(qpos, device=dev)
        self.clip_qvel = torch.as_tensor(qvel, device=dev)
        self.clip_lens = torch.as_tensor(lens, device=dev)
        self.clip_wraps = torch.as_tensor(wraps, device=dev)
        self.cycle_offset = torch.as_tensor(cyc_off, device=dev)
        if clip_weights is None:
            w = np.full(K, 1.0 / K, np.float32)
        else:
            w = np.asarray(clip_weights, np.float32)
            if w.shape != (K,) or (w < 0).any() or not w.sum() > 0:
                raise ValueError(f"clip_weights {clip_weights!r}: need {K} "
                                 "non-negative weights with a positive sum")
            w = w / w.sum()
        self.clip_weights = torch.as_tensor(w, device=dev)

        if termination == "fall_contact":
            from deepmimic_mujoco_torch.envs.deepmimic_surface import (
                load_fall_contact_bodies,
            )

            # one list per clip (the upstream arg files differ per skill:
            # getup and roll allow more contacts); the wrists are geoms of
            # the elbow bodies in this model
            cand = self.model.cand_body.cpu().numpy()
            fall_cand = np.zeros((K, len(cand)), bool)
            for k, name in enumerate(self.clip_names):
                disallowed = np.zeros(self.model.nbody, bool)
                for i in load_fall_contact_bodies(name):
                    body = BODY_DEFS[i]
                    if body.endswith("wrist"):
                        body = body.replace("wrist", "elbow")
                    disallowed[self.model.body_index(body)] = True
                fall_cand[k] = disallowed[cand]
            self._fall_cand = torch.as_tensor(fall_cand, device=dev)

        kp, kd = kp_kd_vectors()
        self._kp = torch.as_tensor(kp, device=dev)
        self._kd = torch.as_tensor(kd, device=dev)
        self._dynamics = lambda qp, qv, target: engine.step_pd(
            self.model, qp, qv, target, self._kp, self._kd,
            n_substeps=self.n_substeps)
        names = self.model.geom_names
        self._ee_geoms = torch.tensor([names.index(n) for n in END_EFFECTORS],
                                      dtype=torch.int64, device=dev)

        # every clip's end-effector, COM and COM-velocity tracks, by FK of
        # all K·Tmax frames at once
        kin = kinematics.fk(self.model, self.clip_qpos.reshape(-1, nq))
        self.clip_ee = self._ee_pos(kin).reshape(K, tmax, -1, 3)
        self.clip_com = kinematics.mass_center(self.model, kin).reshape(
            K, tmax, 3)
        self.clip_com_vel = kinematics.com_velocity(
            self.model, kin, self.clip_qvel.reshape(-1, nv)).reshape(
                K, tmax, 3)

    # ------------------------------------------------------------------
    def _ee_pos(self, kin: kinematics.Kin) -> torch.Tensor:
        return kinematics.geom_world_pos(self.model, kin)[:, self._ee_geoms]

    def _clip_pos(self, clip_id, mocap_idx, init_idx) -> torch.Tensor:
        """Frame position init + (cursor − init)·scale of the env's clip,
        in f32."""
        return (init_idx.to(torch.float32)
                + (mocap_idx - init_idx).to(torch.float32)
                * self.clip_scales[clip_id])

    def _clip_index(self, clip_id: torch.Tensor, mocap_idx: torch.Tensor,
                    init_idx: torch.Tensor):
        """(frame index int64, completed cycles f32) of each env's cursor
        (int or float) in its own clip: the position rounded half to even;
        looping clips wrap (index and cycles from the same rounded value),
        the others clamp at their last frame (0 cycles)."""
        T = self.clip_lens[clip_id]
        wraps = self.clip_wraps[clip_id]
        idx_r = torch.round(self._clip_pos(clip_id, mocap_idx,
                                           init_idx)).long()
        idx = torch.where(wraps, torch.remainder(idx_r, T),
                          torch.minimum(idx_r, T - 1))
        cycles = torch.where(
            wraps, torch.div(idx_r, T, rounding_mode="floor").to(
                torch.float32), 0.0)
        return idx, cycles

    def _clip_over(self, clip_id, mocap_idx, init_idx) -> torch.Tensor:
        """The frame position has reached the clip's last frame."""
        return (self._clip_pos(clip_id, mocap_idx, init_idx)
                >= self.clip_lens[clip_id] - 1)

    def _obs(self, qpos, qvel, clip_id, mocap_idx, init_idx) -> torch.Tensor:
        idx, _ = self._clip_index(clip_id, mocap_idx, init_idx)
        phase = idx.to(torch.float32) / self.clip_lens[clip_id]
        onehot = torch.nn.functional.one_hot(clip_id, self.num_clips).to(
            torch.float32)
        parts = [onehot, phase[:, None]]
        if self.obs_mode == "full":
            parts.append(root_obs(qpos, qvel))
        parts += [qpos[:, 7:], qvel[:, 6:]]
        return torch.cat(parts, dim=1)

    def _state(self, clip_id, idx) -> EnvState:
        qpos, qvel = self.clip_qpos[clip_id, idx], self.clip_qvel[clip_id, idx]
        B = qpos.shape[0]
        return EnvState(
            qpos=qpos, qvel=qvel,
            obs=self._obs(qpos, qvel, clip_id, idx, idx),
            reward=qpos.new_zeros(B),
            done=torch.zeros(B, dtype=torch.bool, device=self.device),
            mocap_idx=idx, init_idx=idx,
            step_count=torch.zeros(B, dtype=torch.int64, device=self.device),
            clip_id=clip_id)

    def rsi_frames(self, generator: torch.Generator, clip_id: torch.Tensor
                ) -> torch.Tensor:
        """A random frame of each env's clip, as JAX draws it:
        randint(0, 2³⁰) mod T."""
        r = torch.randint(0, 1 << 30, clip_id.shape, generator=generator,
                          device=self.device)
        return torch.remainder(r, self.clip_lens[clip_id])

    def reset(self, generator: torch.Generator, n: int) -> EnvState:
        """Reference-state initialization of ``n`` envs: each draws its clip
        from ``clip_weights`` (with replacement), then a frame of it."""
        clip_id = torch.multinomial(self.clip_weights, n, replacement=True,
                                    generator=generator)
        return self._state(clip_id, self.rsi_frames(generator, clip_id))

    def reset_at(self, clip_id, idx) -> EnvState:
        """Deterministic reset of env e to frame ``idx[e]`` of clip
        ``clip_id[e]`` (a single clip id applies to every env)."""
        idx = torch.as_tensor(idx, device=self.device).to(torch.int64)
        clip_id = torch.as_tensor(clip_id, device=self.device).to(
            torch.int64).expand(idx.shape).contiguous()
        return self._state(clip_id, idx)

    def reset_keep_clip(self, generator: torch.Generator,
                        state: EnvState) -> EnvState:
        """RSI over a random frame of the clip each env was running
        (``reset_mode="rsi_pinned"``): lanes of independent per-skill
        learners keep their own skill."""
        return self._state(state.clip_id,
                           self.rsi_frames(generator, state.clip_id))

    # ------------------------------------------------------------------
    def _pd_targets(self, state: EnvState, action: torch.Tensor
                    ) -> torch.Tensor:
        """'pd_residual': the clip pose at the advanced cursor plus the
        action; with ``pd_target_interp`` and several substeps, a (B, S, 28)
        schedule of the poses at cursor + s/S, s = 1..S."""
        cid = state.clip_id
        if self.pd_target_interp and self.n_substeps > 1:
            fracs = torch.arange(1, self.n_substeps + 1, dtype=torch.float32,
                                 device=self.device) / self.n_substeps
            cursor = state.mocap_idx.to(torch.float32)[:, None] + fracs
            idx_s, _ = self._clip_index(cid[:, None], cursor,
                                        state.init_idx[:, None])
            return self.clip_qpos[cid[:, None], idx_s][..., 7:] + action[:, None]
        ref_idx, _ = self._clip_index(cid, state.mocap_idx + 1,
                                      state.init_idx)
        return self.clip_qpos[cid, ref_idx][:, 7:] + action

    def step(self, state: EnvState, action: torch.Tensor) -> EnvState:
        cid = state.clip_id
        if self.control_mode == "pd_residual":
            action = self._pd_targets(state, action)
        qpos, qvel = self._dynamics(state.qpos, state.qvel, action)
        kin = kinematics.fk(self.model, qpos)
        com = kinematics.mass_center(self.model, kin)
        if self.termination == "fall_contact":
            # the full candidate set, each env against its own clip's row
            active = collision.floor_contacts(self.model, kin).active
            done = torch.any(active & self._fall_cand[cid], dim=1)
        else:
            done = (com[:, 2] < 0.7) | (com[:, 2] > 2.0)
        if self.max_episode_steps:
            done = done | (state.step_count + 1 >= self.max_episode_steps)

        # the cursor advances before the reward: the post-step pose is held
        # against the post-step frame
        mocap_idx = state.mocap_idx + 1
        idx, cycles = self._clip_index(cid, mocap_idx, state.init_idx)
        offset = cycles[:, None] * self.cycle_offset[cid]  # root re-basing
        ref_qp, ref_qv = self.clip_qpos[cid, idx], self.clip_qvel[cid, idx]
        ee = self._ee_pos(kin)
        ref_ee = self.clip_ee[cid, idx] + offset[:, None]
        if self.reward_mode == "imitation_dm":
            ref_qp = torch.cat([ref_qp[:, 0:3] + offset, ref_qp[:, 3:]], dim=1)
            reward = rewards.deepmimic_reward(
                qpos, qvel, ref_qp, ref_qv, ee_pos=ee, ref_ee_pos=ref_ee,
                com_vel=kinematics.com_velocity(self.model, kin, qvel),
                ref_com_vel=self.clip_com_vel[cid, idx])
        else:
            reward = rewards.imitation_reward(
                qpos[:, 7:], ref_qp[:, 7:], qvel, ref_qv, qpos[:, 0:3],
                ref_qp[:, 0:3] + offset, ee_pos=ee, ref_ee_pos=ref_ee,
                com=com, ref_com=self.clip_com[cid, idx] + offset)
        # a clip that does not loop: the episode ends with the motion
        done = done | (~self.clip_wraps[cid]
                       & self._clip_over(cid, mocap_idx, state.init_idx))
        return EnvState(
            qpos=qpos, qvel=qvel,
            obs=self._obs(qpos, qvel, cid, mocap_idx, state.init_idx),
            reward=reward, done=done,
            mocap_idx=mocap_idx, init_idx=state.init_idx,
            step_count=state.step_count + 1, clip_id=cid)
