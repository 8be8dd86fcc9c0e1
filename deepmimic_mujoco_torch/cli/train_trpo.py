#!/usr/bin/env python3
"""TRPO training, evaluation and sampling CLI (port of
``deepmimic_mujoco_tpu/cli/train_trpo.py`` with its TRPO flags and
defaults) on single-clip ``DPEnvV3`` (every reward mode, torque, PD and
PD-residual control, both obs modes and both termination rules) and, with
``--motion a,b,...``, on the multi-skill ``DPEnvV3Multi`` (one policy over
several clips; the JAX CLI's coercions and warnings: PD-residual control,
an imitation reward, at least 2 substeps, 300-step episodes, the full obs
and fall-contact termination unless given).  ``--joint-limits mocap``
widens the hinge ranges to the bundled clips' poses; ``--warm-iterations``
sets the model's warm-started solve budget; ``--clip-weights`` weights the
clips' RSI draws.  ``--algo ppo`` trains the vectorized clipped-surrogate
PPO (``algos/ppo.py``, the ``--ppo-*`` flags) and evaluates its
checkpoints.  Not ported: ``--dynamics mujoco`` raises
``NotImplementedError`` naming ROADMAP.md.

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
  # one policy over three skills (the multiskill_r4 run's flags)
  python -m deepmimic_mujoco_torch.cli.train_trpo --task train \\
      --motion walk,run,spinkick --reward-mode imitation_dm \\
      --control-mode pd_residual --n-substeps 2 --max-episode-steps 300 \\
      --reset-mode rsi --gamma 0.95 --lam 0.95 --hidden-sizes 1024,512 \\
      --activation relu --fixed-logstd -3.0 --clip-weights 1,1,2
  # vectorized PPO on walk at bench.py's width
  python -m deepmimic_mujoco_torch.cli.train_trpo --task train --algo ppo \\
      --num-envs 4096 --timesteps-per-batch 64 --num-iters 100

Without ``--device cpu`` (or the JAX CLI's ``--platform cpu``) they run on
the CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import warnings

import torch

from deepmimic_mujoco_torch.algos.ppo import PPO, PPOConfig
from deepmimic_mujoco_torch.algos.runner import evaluate
from deepmimic_mujoco_torch.algos.train_loop import train
from deepmimic_mujoco_torch.algos.trpo import TRPO, TRPOConfig
from deepmimic_mujoco_torch.envs.dp_env_v3 import DPEnvV3
from deepmimic_mujoco_torch.envs.multi_clip import DPEnvV3Multi
from deepmimic_mujoco_torch.io_utils import checkpoint
from deepmimic_mujoco_torch.models.policy import MlpPolicy
from deepmimic_mujoco_torch.physics.humanoid import (
    build_humanoid,
    mocap_hinge_range,
)
from deepmimic_mujoco_torch.utils.device import PLATFORMS, resolve_device


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
    p.add_argument("--algo", default="trpo", choices=["trpo", "ppo"],
                   help="trust-region TRPO or vectorized clipped PPO")
    # PPO-only knobs (algos/ppo.py)
    p.add_argument("--ppo-clip", type=float, default=0.2)
    p.add_argument("--ppo-epochs", type=int, default=4)
    p.add_argument("--ppo-minibatches", type=int, default=8)
    p.add_argument("--ppo-lr", type=float, default=3e-4)
    p.add_argument("--ppo-ent-coef", type=float, default=0.0)
    p.add_argument("--ppo-lr-decay", type=float, default=1.0)
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
    p.add_argument("--joint-limits", default="xml", choices=["xml", "mocap"],
                   help="hinge limit ranges: xml = the reference XML's; "
                        "mocap = widened to the bundled clips' poses")
    p.add_argument("--warm-iterations", type=int, default=-1,
                   help=">=0 sets the model's warm-started solve budget "
                        "(-1 keeps the default)")
    p.add_argument("--dynamics", default="torch", choices=["torch", "mujoco"],
                   help="physics backend (mujoco: not ported)")
    p.add_argument("--clip-weights", default=None,
                   help="multi-clip only: comma list of RSI sampling "
                        "weights per clip, e.g. 1,1,2")
    p.add_argument("--apgd-layout", default="blocks",
                   choices=["blocks", "lanes"],
                   help="layout of the batched APGD kernel on CUDA: blocks = "
                        "(B, ne, ne), lanes = (ne, ne, B)")
    p.add_argument("--platform", default=None, choices=sorted(PLATFORMS),
                   help="the JAX CLI's flag: cpu, or gpu for the card")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; pass cpu for the CPU); "
                        "takes precedence over --platform")
    return p


def task_name(args) -> str:
    """The reference's get_task_short_name."""
    motion = args.motion.replace(",", "+")
    return f"{args.env_id}/{args.algo}-{motion}-{args.seed}"


def make_env(args, model):
    """``DPEnvV3`` of one clip, or ``DPEnvV3Multi`` for ``--motion a,b``
    with the JAX CLI's coercions to what the multi-clip env supports (a
    warning for each explicit flag it overrides)."""
    if "," not in args.motion:
        return DPEnvV3(clip=args.motion, model=model,
                       reward_mode=args.reward_mode,
                       control_mode=args.control_mode,
                       n_substeps=args.n_substeps,
                       max_episode_steps=args.max_episode_steps,
                       obs_mode=args.obs_mode, termination=args.termination)
    if args.control_mode == "torque":
        warnings.warn("multi-clip training requires PD control: "
                      "--control-mode torque replaced by pd_residual")
    reward_mode = args.reward_mode
    if reward_mode in ("alive", "mocap"):
        if reward_mode != "alive":  # not the default: given explicitly
            warnings.warn(f"--reward-mode {reward_mode} is not an imitation "
                          "mode; multi-clip uses imitation_dm")
        reward_mode = "imitation_dm"
    if 0 < args.n_substeps < 2:
        warnings.warn("multi-clip requires >=2 substeps (30 Hz control); "
                      f"--n-substeps {args.n_substeps} raised to 2")
    return DPEnvV3Multi(
        clips=tuple(args.motion.split(",")), model=model,
        control_mode=(args.control_mode if args.control_mode != "torque"
                      else "pd_residual"),
        reward_mode=reward_mode, n_substeps=max(args.n_substeps, 2),
        max_episode_steps=args.max_episode_steps or 300,
        obs_mode=args.obs_mode or "full",
        termination=args.termination or "fall_contact",
        clip_weights=(tuple(float(w) for w in args.clip_weights.split(","))
                      if args.clip_weights else None))


def main(argv=None):
    """Runs the task; returns the final ``TRPOState`` or ``PPOState``
    (train) or the ``EvalResult`` (evaluate, sample)."""
    args = build_parser().parse_args(argv)
    if args.dynamics != "torch":
        raise NotImplementedError(
            f"--dynamics {args.dynamics} (the host-MuJoCo A/B backend) is not "
            "ported (ROADMAP.md, queue A, item 'Parity modes and tools')")
    device = resolve_device(args.device or PLATFORMS.get(args.platform))
    model = build_humanoid(apgd_layout=args.apgd_layout, device=device)
    if args.warm_iterations >= 0:
        model = dataclasses.replace(model,
                                    warm_iterations=args.warm_iterations)
    if args.joint_limits == "mocap":
        model = mocap_hinge_range(model)
    env = make_env(args, model)
    hidden_sizes = (tuple(int(h) for h in args.hidden_sizes.split(","))
                    if args.hidden_sizes else None)
    policy = MlpPolicy(ob_dim=env.observation_size, ac_dim=env.action_size,
                       hid_size=args.hid_size,
                       num_hid_layers=args.num_hid_layers,
                       fixed_logstd=args.fixed_logstd,
                       hidden_sizes=hidden_sizes, activation=args.activation)
    name = task_name(args)

    if args.task == "train":
        if args.algo == "ppo":
            learner = PPO(env, policy, PPOConfig(
                horizon=args.timesteps_per_batch, num_envs=args.num_envs,
                gamma=args.gamma, lam=args.lam, clip_ratio=args.ppo_clip,
                epochs=args.ppo_epochs, minibatches=args.ppo_minibatches,
                lr=args.ppo_lr, ent_coef=args.ppo_ent_coef,
                reset_mode=args.reset_mode, lr_decay=args.ppo_lr_decay))
        else:
            learner = TRPO(env, policy, TRPOConfig(
                horizon=args.timesteps_per_batch, num_envs=args.num_envs,
                g_step=args.g_step, gamma=args.gamma, lam=args.lam,
                max_kl=args.max_kl, cg_iters=args.cg_iters,
                cg_damping=args.cg_damping, vf_iters=args.vf_iters,
                vf_stepsize=args.vf_stepsize, entcoeff=args.policy_entcoeff,
                reset_mode=args.reset_mode))
        # the exact recipe next to the logs
        log_dir = os.path.join(args.log_dir, name)
        os.makedirs(log_dir, exist_ok=True)
        with open(os.path.join(log_dir, "args.json"), "w") as f:
            json.dump(vars(args), f, indent=1, sort_keys=True)
        return train(
            learner, seed=args.seed,
            max_timesteps=args.num_timesteps if not args.num_iters else 0,
            max_iters=args.num_iters,
            ckpt_dir=os.path.join(args.checkpoint_dir, name),
            log_dir=log_dir, save_per_iter=args.save_per_iter,
            resume_from=args.pretrained_weight_path,
            override_logstd=args.override_logstd)

    generator = torch.Generator(device=device).manual_seed(args.seed)
    if args.load_model_path:
        load = (checkpoint.load_ppo_params if args.algo == "ppo"
                else checkpoint.load_trpo_params)
        params = load(args.load_model_path, policy, device)
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
