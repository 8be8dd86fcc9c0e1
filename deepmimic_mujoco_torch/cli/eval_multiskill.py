#!/usr/bin/env python3
"""Per-skill evaluation of a multi-clip imitation checkpoint (port of the
JAX package's ``tools/eval_multiskill.py``): deterministic episodes of
``DPEnvV3Multi`` from start frames of EACH clip, with the episode length and
the reward per step of every skill.

    python -m deepmimic_mujoco_torch.cli.eval_multiskill \\
        --ckpt train_ckpt_multiskill_r4/DPEnvV3/trpo-walk+run+spinkick-0/trpo_state.npz \\
        --motions walk,run,spinkick --episodes 32

Skill k's episodes start at the frames ``np.random.RandomState(k).randint(0,
T_k, size=episodes)``, the frames the JAX tool draws.  All skills run in one
batch.  Without ``--device cpu`` it runs on the CUDA card."""

from __future__ import annotations

import argparse

import numpy as np
import torch

from deepmimic_mujoco_torch.algos import runner
from deepmimic_mujoco_torch.envs.multi_clip import DPEnvV3Multi
from deepmimic_mujoco_torch.io_utils import checkpoint
from deepmimic_mujoco_torch.models.policy import MlpPolicy
from deepmimic_mujoco_torch.physics.humanoid import (
    build_humanoid,
    mocap_hinge_range,
)
from deepmimic_mujoco_torch.utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--motions", default="walk,run,spinkick")
    p.add_argument("--episodes", type=int, default=32)
    p.add_argument("--horizon", type=int, default=300)
    p.add_argument("--fixed-logstd", type=float, default=-3.0)
    p.add_argument("--hidden-sizes", default="1024,512")
    p.add_argument("--activation", default="relu", choices=["tanh", "relu"])
    p.add_argument("--joint-limits", default="xml", choices=["xml", "mocap"],
                   help="must match the checkpoint's training flag")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; pass cpu for the CPU)")
    return p


@torch.no_grad()
def run(args) -> dict:
    """Rolls every skill's episodes; returns per skill the episode lengths
    and returns (``ep_len``, ``ep_ret``: (K, B)), the mean length and the
    reward per step (``len_mean``, ``reward_per_step``: (K,))."""
    device = resolve_device(args.device)
    clips = tuple(args.motions.split(","))
    model = build_humanoid(device=device)
    if args.joint_limits == "mocap":
        model = mocap_hinge_range(model)
    env = DPEnvV3Multi(clips=clips, model=model,
                       max_episode_steps=args.horizon)
    hidden = tuple(int(h) for h in args.hidden_sizes.split(","))
    policy = MlpPolicy(ob_dim=env.observation_size, ac_dim=env.action_size,
                       fixed_logstd=args.fixed_logstd, hidden_sizes=hidden,
                       activation=args.activation)
    params = checkpoint.load_trpo_params(args.ckpt, policy, device)
    B, K = args.episodes, len(clips)
    frames = np.concatenate([
        np.random.RandomState(k).randint(0, int(env.clip_lens[k]), size=B)
        for k in range(K)])
    clip_id = np.repeat(np.arange(K), B)
    out = runner.rollout(env, policy, params, env.reset_at(clip_id, frames),
                         args.horizon)
    ep_len = out.ep_len.reshape(K, B).cpu().double()
    ep_ret = out.ep_ret.reshape(K, B).cpu().double()
    return {"ep_len": ep_len, "ep_ret": ep_ret,
            "len_mean": ep_len.mean(1),
            "reward_per_step": ep_ret.sum(1) / torch.clamp(ep_len.sum(1),
                                                           min=1.0)}


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    r = run(args)
    print(f"{'skill':>10} {'EpLen':>7} {'rew/step':>9}   "
          f"({args.episodes} RSI episodes each, deterministic)")
    for name, n, rps in zip(args.motions.split(","), r["len_mean"],
                            r["reward_per_step"]):
        print(f"{name:>10} {float(n):7.1f} {float(rps):9.3f}")
    print(f"{'MEAN':>10} {float(r['len_mean'].mean()):7.1f} "
          f"{float(r['reward_per_step'].mean()):9.3f}")
    return r


if __name__ == "__main__":
    main()
