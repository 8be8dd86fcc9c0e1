#!/usr/bin/env python3
"""Render a trained imitation policy to video (port of the JAX package's
``tools/render_policy.py``): roll the checkpoint deterministically from a
fixed mocap frame of the recipe env, then render the qpos trajectory
through host MuJoCo (``io_utils/video.render_qpos_trajectory``).

    python -m deepmimic_mujoco_torch.cli.render_policy \\
        --ckpt train_ckpt_walk_r2/DPEnvV3/trpo-walk-0/trpo_state.npz \\
        --motion walk --out figures/walk_policy.avi

The rollout (:func:`rollout`) runs on the device: the CUDA card unless
``--device cpu`` (or ``--platform cpu``) asks for the CPU.  The rendering
runs on the host and needs MuJoCo and cv2, which are checked before the
rollout starts (the card's machine has neither: there, call
:func:`rollout` alone)."""

from __future__ import annotations

import argparse
import os

import torch

from deepmimic_mujoco_torch.envs.dp_env_v3 import DPEnvV3
from deepmimic_mujoco_torch.io_utils import checkpoint, video
from deepmimic_mujoco_torch.models.policy import MlpPolicy
from deepmimic_mujoco_torch.utils.device import PLATFORMS, resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--motion", default="walk")
    p.add_argument("--out", default=None)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--start-frame", type=int, default=0)
    p.add_argument("--hidden-sizes", default="1024,512")
    p.add_argument("--activation", default="relu")
    p.add_argument("--fixed-logstd", type=float, default=-3.0)
    p.add_argument("--control-mode", default="pd_residual")
    p.add_argument("--platform", default=None, choices=sorted(PLATFORMS),
                   help="the JAX tool's flag: cpu, or gpu/cuda for the card")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; pass cpu for the CPU); "
                        "takes precedence over --platform")
    return p


def device_of(args) -> torch.device:
    return resolve_device(args.device or PLATFORMS.get(args.platform))


def setup(args, device):
    """(env, policy, params, start state) of the tool's configuration: the
    recipe env capped at ``--steps``, one env at ``--start-frame``."""
    env = DPEnvV3(clip=args.motion, reward_mode="imitation_dm",
                  control_mode=args.control_mode, n_substeps=2,
                  max_episode_steps=args.steps, device=device)
    policy = MlpPolicy(
        ob_dim=env.observation_size, ac_dim=env.action_size,
        fixed_logstd=args.fixed_logstd,
        hidden_sizes=tuple(int(h) for h in args.hidden_sizes.split(",")),
        activation=args.activation)
    params = checkpoint.load_trpo_params(args.ckpt, policy, device)
    return env, policy, params, env.reset_at([args.start_frame])


@torch.no_grad()
def rollout(env, policy, params: dict, state, steps: int):
    """``steps`` deterministic control steps (the policy's mean action) of
    every env of ``state``; after an env's done its state stays frozen.
    Returns the qpos before each step (steps, B, nq) and whether the env
    was alive then (steps, B), as the JAX tool's scan does."""
    alive = torch.ones(state.qpos.shape[0], dtype=torch.bool,
                       device=state.qpos.device)
    qpos, alive_t = [], []
    for _ in range(steps):
        mean, _ = policy.mean_logstd(params, state.obs)
        nxt = env.step(state, mean)
        qpos.append(state.qpos)
        alive_t.append(alive)
        state = nxt.where(alive, state)
        alive = alive & ~nxt.done
    return torch.stack(qpos), torch.stack(alive_t)


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    video.require_renderer()
    device = device_of(args)
    env, policy, params, state = setup(args, device)
    qpos, alive = rollout(env, policy, params, state, args.steps)
    n = int(alive[:, 0].sum())
    qpos = qpos[:max(n, 1), 0].cpu().numpy()
    out = args.out or os.path.join(REPO, "figures",
                                   f"{args.motion}_policy.avi")
    # clip frames are 30 fps; render each control step once
    video.render_qpos_trajectory(qpos, out, fps=30)
    print(f"rendered {len(qpos)} frames (episode ran {n}/{args.steps}) "
          f"→ {out}")
    return {"frames": len(qpos), "alive": n, "out": out}


if __name__ == "__main__":
    main()
