#!/usr/bin/env python3
"""The binding constraint behind the per-clip PD tracking ceiling (port of
``tools/tracking_ceiling_probe.py``; ``cli/clip_tracking_study.py`` measures
the ceiling): the one-step ``imitation_dm`` reward split into its five exp
terms, under A/B switches of the control knobs (:data:`PROBES`): the
clip's reference or integrator-consistent velocities, held or stepped PD
targets, 30 Hz or 60 Hz control; the PD gains and the torque limits scale
through :func:`probe`'s ``gain_mul`` and ``torque_mul``.  The frames are
one env batch.  Without ``--device cpu`` it runs on the CUDA card.

    python -m deepmimic_mujoco_torch.cli.tracking_ceiling_probe --clip spinkick
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from deepmimic_mujoco_torch.cli.clip_tracking_study import spread
from deepmimic_mujoco_torch.envs import rewards
from deepmimic_mujoco_torch.envs.dp_env_v3 import DPEnvV3
from deepmimic_mujoco_torch.physics import kinematics
from deepmimic_mujoco_torch.physics.humanoid import build_humanoid

TERMS = ("pose", "vel", "ee", "root", "com")
# name → probe() keywords, in the tool's order
PROBES = {
    "ref vels, held tgt": dict(vels="reference"),
    "fd vels, held tgt": dict(),
    "fd vels, stepped tgt": dict(interp=True),
    "fd vels, 60Hz ctrl": dict(n_substeps=1),
    "ref vels, 60Hz ctrl": dict(n_substeps=1, vels="reference"),
}


def probe(clip: str, n_frames: int, n_substeps: int = 2,
          gain_mul: float = 1.0, torque_mul: float = 1.0,
          interp: bool = False, vels: str = "consistent", device=None):
    """One zero-residual control step from ``n_frames`` spread frames of
    ``clip``; returns (starts, reward (n,), {term: (n,)}) as numpy arrays,
    the reward recomputed with its terms from the post-step state."""
    env = DPEnvV3(clip=clip, model=build_humanoid(device=device),
                  reward_mode="imitation_dm", control_mode="pd_residual",
                  n_substeps=n_substeps, pd_target_interp=interp,
                  clip_velocities=vels)
    if gain_mul != 1.0:
        env._kp = env._kp * gain_mul
        env._kd = env._kd * gain_mul
    if torque_mul != 1.0:
        env.model = dataclasses.replace(
            env.model, actuator_gear=env.model.actuator_gear * torque_mul)
    starts = spread(env, n_frames)
    s1 = env.step(env.reset_at(starts),
                  torch.zeros(n_frames, env.action_size, device=env.device))
    ridx, cycles = env._clip_index(s1.mocap_idx, s1.init_idx)
    offset = cycles[:, None] * env.cycle_offset
    ref_qp = env.clip_qpos[ridx]
    ref_qp = torch.cat([ref_qp[:, 0:3] + offset, ref_qp[:, 3:]], dim=1)
    kin = kinematics.fk(env.model, s1.qpos)
    ee = kinematics.geom_world_pos(env.model, kin)[:, env._ee_geoms]
    r, terms = rewards.deepmimic_reward(
        s1.qpos, s1.qvel, ref_qp, env.clip_qvel[ridx], ee_pos=ee,
        ref_ee_pos=env.clip_ee[ridx] + offset[:, None],
        com_vel=kinematics.com_velocity(env.model, kin, s1.qvel),
        ref_com_vel=env.clip_com_vel[ridx], return_terms=True)
    return (starts, r.cpu().numpy(),
            {k: v.cpu().numpy() for k, v in terms.items()})


def summary(starts, r, terms) -> dict:
    """Mean and min reward, the mean of each term, and the worst frame with
    its terms."""
    worst = int(np.argmin(r))
    return {"reward_mean": float(r.mean()), "reward_min": float(r.min()),
            "terms_mean": {k: float(np.mean(terms[k])) for k in TERMS},
            "worst_frame": int(starts[worst]),
            "terms_worst": {k: float(terms[k][worst]) for k in TERMS}}


def main(argv=None) -> dict:
    """Returns {probe name: :func:`summary`}."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--clip", default="spinkick")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; pass cpu for the CPU)")
    p.add_argument("--n-frames", type=int, default=32)
    args = p.parse_args(argv)

    out = {}
    for name, kw in PROBES.items():
        res = out[name] = summary(*probe(args.clip, args.n_frames,
                                         device=args.device, **kw))
        tm, tw = res["terms_mean"], res["terms_worst"]
        print(f"{name:24s} r={res['reward_mean']:.3f} "
              f"min={res['reward_min']:.3f}  terms(mean) "
              + " ".join(f"{k}={tm[k]:.2f}" for k in TERMS)
              + f"  worst@f{res['worst_frame']} "
              + " ".join(f"{k}={tw[k]:.2f}" for k in TERMS), flush=True)
    return out


if __name__ == "__main__":
    main()
