#!/usr/bin/env python3
"""Per-clip PD-tracking diagnostics (port of ``tools/clip_tracking_study.py``):
is the imitation plateau an RL problem or a physics and control ceiling?
For every clip, in the training configuration (``imitation_dm`` reward,
``pd_residual`` control, 2 substeps):

* one-step tracking: ``--n-frames`` envs reset to mocap frames spread over
  the clip take one control step with a zero residual (pure stable PD
  toward the next reference frame); the reward is what a perfectly
  synchronized policy gets, compounding drift excluded;
* open-loop rollout: ``--n-starts`` envs step zero residuals for up to
  ``--horizon`` steps under the fall-contact rule; the reward per step and
  episode length show how fast drift accumulates without feedback.

The frames and the starts are each one env batch.  Without ``--device cpu``
it runs on the CUDA card.

    python -m deepmimic_mujoco_torch.cli.clip_tracking_study \\
        --joint-limits mocap --out clip_tracking.json
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from deepmimic_mujoco_torch.envs.dp_env_v3 import DPEnvV3
from deepmimic_mujoco_torch.mocap.registry import available_clips
from deepmimic_mujoco_torch.physics.humanoid import (
    build_humanoid,
    mocap_hinge_range,
)


def spread(env: DPEnvV3, n: int) -> np.ndarray:
    """``n`` start frames spread evenly over [0, T − 2], rounded."""
    return np.linspace(0, env.clip_len - 2, n).round().astype(np.int64)


def one_step(env: DPEnvV3, n_frames: int):
    """(starts, reward, done) of one zero-residual control step from each
    of ``n_frames`` spread frames, as numpy arrays."""
    starts = spread(env, n_frames)
    s = env.step(env.reset_at(starts),
                 torch.zeros(n_frames, env.action_size, device=env.device))
    return starts, s.reward.cpu().numpy(), s.done.cpu().numpy()


def open_loop(env: DPEnvV3, n_starts: int, horizon: int):
    """(summed reward, length) of zero-residual rollouts from ``n_starts``
    spread frames: a step's reward counts while the env was alive before
    it, so the step that ends an episode counts.  The loop stops once no
    env is alive (later steps add nothing)."""
    s = env.reset_at(spread(env, n_starts))
    zero = torch.zeros(n_starts, env.action_size, device=env.device)
    alive = torch.ones(n_starts, dtype=torch.bool, device=env.device)
    rew = torch.zeros(n_starts, device=env.device)
    length = torch.zeros(n_starts, dtype=torch.int64, device=env.device)
    for _ in range(horizon):
        s = env.step(s, zero)
        rew = rew + torch.where(alive, s.reward, 0.0)
        length = length + alive.long()
        alive = alive & ~s.done
        if not bool(alive.any()):
            break
    return rew.cpu().numpy(), length.cpu().numpy()


def make_env(clip: str, model, horizon: int) -> DPEnvV3:
    return DPEnvV3(clip=clip, model=model, reward_mode="imitation_dm",
                   control_mode="pd_residual", n_substeps=2,
                   max_episode_steps=horizon)


def clip_row(name: str, env: DPEnvV3, r1, d1, rew, length) -> dict:
    """The tool's row of clip ``name``."""
    return {
        "clip": name,
        "clip_len": env.clip_len,
        "clip_fps": round(1.0 / env.clip.dt, 1),
        "loop": env.clip.loop,
        "onestep_reward_mean": float(np.mean(r1)),
        "onestep_reward_min": float(np.min(r1)),
        "onestep_done_frac": float(np.mean(d1)),
        "openloop_rew_per_step": float((rew / np.maximum(length, 1)).mean()),
        "openloop_eplen_mean": float(length.mean()),
    }


def main(argv=None) -> list:
    """Returns the rows, one per clip."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; pass cpu for the CPU)")
    p.add_argument("--horizon", type=int, default=300)
    p.add_argument("--n-frames", type=int, default=32,
                   help="one-step tracking sample frames per clip")
    p.add_argument("--n-starts", type=int, default=8,
                   help="starts of the open-loop rollout")
    p.add_argument("--clips", default="")
    p.add_argument("--joint-limits", default="xml", choices=["xml", "mocap"],
                   help="mocap = widen the hinge ranges to cover the clip "
                        "poses (physics/humanoid.py mocap_hinge_range)")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)

    clips = args.clips.split(",") if args.clips else available_clips()
    model = build_humanoid(device=args.device)
    if args.joint_limits == "mocap":
        model = mocap_hinge_range(model)
    rows = []
    for name in clips:
        env = make_env(name, model, args.horizon)
        _, r1, d1 = one_step(env, args.n_frames)
        rew, length = open_loop(env, args.n_starts, args.horizon)
        row = clip_row(name, env, r1, d1, rew, length)
        rows.append(row)
        print(f"{name:16s} fps={row['clip_fps']:5.1f} loop={row['loop']:5s}"
              f" 1step r={row['onestep_reward_mean']:.3f}"
              f" (min {row['onestep_reward_min']:.3f},"
              f" done {row['onestep_done_frac']:.2f})"
              f" openloop r/step={row['openloop_rew_per_step']:.3f}"
              f" len={row['openloop_eplen_mean']:.0f}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
        print("wrote", args.out)
    return rows


if __name__ == "__main__":
    main()
