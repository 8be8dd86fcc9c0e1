#!/usr/bin/env python3
"""TRPO training, evaluation and sampling CLI (port of
``deepmimic_mujoco_tpu/cli/train_trpo.py`` with its TRPO flags and
defaults) on single-clip ``DPEnvV3``: every reward mode, torque, PD and
PD-residual control, both obs modes and both termination rules.  Not
ported: ``--algo ppo`` and multi-clip ``--motion a,b`` raise
``NotImplementedError`` naming ROADMAP.md; the JAX CLI's ``--dynamics``,
``--joint-limits``, ``--warm-iterations`` and ``--clip-weights`` have no
flag here.

Examples:
  python -m deepmimic_mujoco_torch.cli.train_trpo --task train \\
      --num-envs 4096 --timesteps-per-batch 64 --g-step 1 --num-iters 100
  python -m deepmimic_mujoco_torch.cli.train_trpo --task evaluate \\
      --load-model-path train_ckpt/DPEnvV3/trpo-walk-0/trpo_state.npz \\
      --eval-episodes 4096 --eval-horizon 200
  # the imitation recipe (README "Quick start"), trained and evaluated
  python -m deepmimic_mujoco_torch.cli.train_trpo --task train \\
      --reward-mode imitation_dm --control-mode pd_residual \\
      --n-substeps 2 --max-episode-steps 300 --reset-mode rsi \\
      --gamma 0.95 --lam 0.95 --hidden-sizes 1024,512 --activation relu \\
      --fixed-logstd -3.0 --num-envs 4096 --timesteps-per-batch 32
  python -m deepmimic_mujoco_torch.cli.train_trpo --task evaluate \\
      --reward-mode imitation_dm --control-mode pd_residual \\
      --n-substeps 2 --max-episode-steps 300 --hidden-sizes 1024,512 \\
      --activation relu --fixed-logstd -3.0 --eval-horizon 300 \\
      --load-model-path train_ckpt_walk_r2/DPEnvV3/trpo-walk-0/trpo_state.npz

Without ``--device cpu`` they run on the CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from deepmimic_mujoco_torch.algos.runner import evaluate
from deepmimic_mujoco_torch.algos.train_loop import train
from deepmimic_mujoco_torch.algos.trpo import TRPO, TRPOConfig
from deepmimic_mujoco_torch.envs.dp_env_v3 import DPEnvV3
from deepmimic_mujoco_torch.io_utils import checkpoint
from deepmimic_mujoco_torch.models.policy import MlpPolicy
from deepmimic_mujoco_torch.physics.humanoid import build_humanoid
from deepmimic_mujoco_torch.utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--env-id", default="DPEnvV3", choices=["DPEnvV3"])
    p.add_argument("--motion", default="walk", help="mocap clip")
    p.add_argument("--reward-mode", default="alive",
                   choices=["alive", "mocap", "imitation", "imitation_dm"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--task", default="train",
                   choices=["train", "evaluate", "sample"])
    p.add_argument("--algo", default="trpo", choices=["trpo", "ppo"])
    # TRPO hyperparameters (the JAX CLI's defaults)
    p.add_argument("--g-step", type=int, default=3)
    p.add_argument("--policy-entcoeff", type=float, default=0)
    p.add_argument("--num-timesteps", type=int, default=1_000_000)
    p.add_argument("--timesteps-per-batch", type=int, default=256)
    p.add_argument("--num-envs", type=int, default=8)
    p.add_argument("--max-kl", type=float, default=0.01)
    p.add_argument("--cg-iters", type=int, default=10)
    p.add_argument("--cg-damping", type=float, default=0.1)
    p.add_argument("--vf-iters", type=int, default=3)
    p.add_argument("--vf-stepsize", type=float, default=1e-3)
    p.add_argument("--gamma", type=float, default=0.995)
    p.add_argument("--lam", type=float, default=0.97)
    p.add_argument("--hid-size", type=int, default=100)
    p.add_argument("--num-hid-layers", type=int, default=2)
    p.add_argument("--hidden-sizes", default=None,
                   help="comma list overriding hid-size, e.g. 1024,512")
    p.add_argument("--activation", default="tanh", choices=["tanh", "relu"])
    p.add_argument("--obs-mode", default=None, choices=["legacy", "full"])
    p.add_argument("--fixed-logstd", type=float, default=None,
                   help="freeze exploration noise at this logstd")
    p.add_argument("--override-logstd", type=float, default=None,
                   help="set the logstd AFTER loading --pretrained-weight-"
                        "path (the checkpointed value wins otherwise)")
    # infra
    p.add_argument("--save-per-iter", type=int, default=100)
    p.add_argument("--checkpoint-dir", default="checkpoint_tmp")
    p.add_argument("--log-dir", default="log_tmp")
    p.add_argument("--load-model-path", default=None)
    p.add_argument("--pretrained-weight-path", default=None,
                   help="a TRPO checkpoint whose whole state training "
                        "continues from")
    p.add_argument("--num-iters", type=int, default=0,
                   help="stop after N iterations instead of timesteps")
    p.add_argument("--eval-episodes", type=int, default=100)
    p.add_argument("--eval-horizon", type=int, default=1024,
                   help="max steps per evaluated episode")
    p.add_argument("--sample-save-path", default=None)
    p.add_argument("--control-mode", default="torque",
                   choices=["torque", "pd", "pd_residual"])
    p.add_argument("--reset-mode", default="noise", choices=["noise", "rsi"],
                   help="post-done reset; rsi = random mocap frame")
    p.add_argument("--n-substeps", type=int, default=1,
                   help="physics substeps per control step")
    p.add_argument("--max-episode-steps", type=int, default=0)
    p.add_argument("--termination", default=None,
                   choices=["com", "fall_contact"])
    p.add_argument("--eval-reset", default="rsi", choices=["rsi", "noise"],
                   help="episode starts for evaluate/sample: rsi = random "
                        "mocap frame, noise = the training distribution")
    p.add_argument("--apgd-layout", default="blocks",
                   choices=["blocks", "lanes"],
                   help="layout of the batched APGD kernel on CUDA: blocks = "
                        "(B, ne, ne), lanes = (ne, ne, B)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; pass cpu for the CPU)")
    return p


def task_name(args) -> str:
    """The reference's get_task_short_name."""
    motion = args.motion.replace(",", "+")
    return f"{args.env_id}/{args.algo}-{motion}-{args.seed}"


def main(argv=None):
    """Runs the task; returns the final ``TRPOState`` (train) or the
    ``EvalResult`` (evaluate, sample)."""
    args = build_parser().parse_args(argv)
    if args.algo != "trpo":
        raise NotImplementedError(
            f"--algo {args.algo} is not ported yet (ROADMAP.md, queue A, "
            "item 'Other learners')")
    if "," in args.motion:
        raise NotImplementedError(
            f"--motion {args.motion}: multi-clip training is not ported yet "
            "(ROADMAP.md, queue A, item 'Multi-clip lanes')")
    device = resolve_device(args.device)
    model = build_humanoid(apgd_layout=args.apgd_layout, device=device)
    env = DPEnvV3(clip=args.motion, model=model, reward_mode=args.reward_mode,
                  control_mode=args.control_mode, n_substeps=args.n_substeps,
                  max_episode_steps=args.max_episode_steps,
                  obs_mode=args.obs_mode, termination=args.termination)
    hidden_sizes = (tuple(int(h) for h in args.hidden_sizes.split(","))
                    if args.hidden_sizes else None)
    policy = MlpPolicy(ob_dim=env.observation_size, ac_dim=env.action_size,
                       hid_size=args.hid_size,
                       num_hid_layers=args.num_hid_layers,
                       fixed_logstd=args.fixed_logstd,
                       hidden_sizes=hidden_sizes, activation=args.activation)
    name = task_name(args)

    if args.task == "train":
        cfg = TRPOConfig(
            horizon=args.timesteps_per_batch, num_envs=args.num_envs,
            g_step=args.g_step, gamma=args.gamma, lam=args.lam,
            max_kl=args.max_kl, cg_iters=args.cg_iters,
            cg_damping=args.cg_damping, vf_iters=args.vf_iters,
            vf_stepsize=args.vf_stepsize, entcoeff=args.policy_entcoeff,
            reset_mode=args.reset_mode)
        # the exact recipe next to the logs
        log_dir = os.path.join(args.log_dir, name)
        os.makedirs(log_dir, exist_ok=True)
        with open(os.path.join(log_dir, "args.json"), "w") as f:
            json.dump(vars(args), f, indent=1, sort_keys=True)
        return train(
            TRPO(env, policy, cfg), seed=args.seed,
            max_timesteps=args.num_timesteps if not args.num_iters else 0,
            max_iters=args.num_iters,
            ckpt_dir=os.path.join(args.checkpoint_dir, name),
            log_dir=log_dir, save_per_iter=args.save_per_iter,
            resume_from=args.pretrained_weight_path,
            override_logstd=args.override_logstd)

    generator = torch.Generator(device=device).manual_seed(args.seed)
    if args.load_model_path:
        params = checkpoint.load_trpo_params(args.load_model_path, policy,
                                             device)
    else:
        params = policy.init(generator, device)
    result = evaluate(env, policy, params, generator,
                      n_episodes=args.eval_episodes, horizon=args.eval_horizon,
                      stochastic=args.task == "sample",
                      save_path=args.sample_save_path,
                      reset_mode=args.eval_reset)
    print(f"Average length: {result.avg_len:.1f}")
    print(f"Average return: {result.avg_ret:.1f}")
    return result


if __name__ == "__main__":
    main()
