#!/usr/bin/env python3
"""TRPO evaluation CLI (port of ``deepmimic_mujoco_tpu/cli/train_trpo.py``
with its evaluation flags, on DPEnvV3's default configuration and the tanh
100×2 MlpPolicy; the tasks ``train`` and ``sample`` and the imitation flags
are ROADMAP.md queue A, slice 2).

Example:
  python -m deepmimic_mujoco_torch.cli.train_trpo --task evaluate \\
      --load-model-path train_ckpt/DPEnvV3/trpo-walk-0/trpo_state.npz \\
      --eval-episodes 4096 --eval-horizon 200
"""

from __future__ import annotations

import argparse

import torch

from deepmimic_mujoco_torch.algos.runner import EvalResult, evaluate
from deepmimic_mujoco_torch.envs.dp_env_v3 import DPEnvV3
from deepmimic_mujoco_torch.io_utils import checkpoint
from deepmimic_mujoco_torch.models.policy import MlpPolicy
from deepmimic_mujoco_torch.physics.humanoid import build_humanoid
from deepmimic_mujoco_torch.utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--motion", default="walk", help="mocap clip")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--task", default="train",
                   choices=["train", "evaluate", "sample"])
    p.add_argument("--load-model-path", default=None)
    p.add_argument("--eval-episodes", type=int, default=100)
    p.add_argument("--eval-horizon", type=int, default=1024,
                   help="max steps per evaluated episode")
    p.add_argument("--sample-save-path", default=None)
    p.add_argument("--eval-reset", default="rsi", choices=["rsi", "noise"],
                   help="episode starts: rsi = random mocap frame, noise = "
                        "the training distribution")
    p.add_argument("--apgd-layout", default="blocks",
                   choices=["blocks", "lanes"],
                   help="layout of the batched APGD kernel on CUDA: blocks = "
                        "(B, ne, ne), lanes = (ne, ne, B)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; pass cpu for the CPU)")
    return p


def main(argv=None) -> EvalResult:
    args = build_parser().parse_args(argv)
    if args.task != "evaluate":
        raise NotImplementedError(
            f"--task {args.task} is not ported yet (ROADMAP.md, queue A: "
            "slice 2, TRPO training)")
    device = resolve_device(args.device)
    model = build_humanoid(apgd_layout=args.apgd_layout, device=device)
    env = DPEnvV3(clip=args.motion, model=model)
    policy = MlpPolicy(ob_dim=env.observation_size, ac_dim=env.action_size)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    if args.load_model_path:
        params = checkpoint.load_trpo_params(args.load_model_path, policy,
                                             device)
    else:
        params = policy.init(generator, device)
    result = evaluate(env, policy, params, generator,
                      n_episodes=args.eval_episodes, horizon=args.eval_horizon,
                      save_path=args.sample_save_path,
                      reset_mode=args.eval_reset)
    print(f"Average length: {result.avg_len:.1f}")
    print(f"Average return: {result.avg_ret:.1f}")
    return result


if __name__ == "__main__":
    main()
