#!/usr/bin/env python3
"""GAIL training CLI (port of ``deepmimic_mujoco_tpu/cli/train_gail.py``,
with its flags and defaults, and ``--device``): the expert ``.npz``,
``--traj-limitation``, the discriminator's width and entropy coefficient,
``g_step`` / ``d_step``, behaviour-cloning pretraining (``--pretrained``,
``--bc-max-iters``) and the env and policy configuration of
``train_trpo``.  Each iteration logs ``EpLenMean``, ``EpRewMean`` (the
discriminator's returns), ``EpTrueRewMean`` (the env's), ``DLoss``,
``GenAcc``, ``ExpertAcc``, ``TimestepsSoFar`` and ``TimeElapsed``; the
monitor records the TRUE returns.  ``gail_state.npz`` (the JAX layout) is
written every ``--save-per-iter`` iterations and at the end.

Example, the bundled r4 run's flags (``tools/r4_chain.sh``):
  python -m deepmimic_mujoco_torch.cli.train_gail \\
      --expert-path assets/expert/walk_expert.npz --motion walk \\
      --reward-mode imitation_dm --control-mode pd_residual \\
      --reset-mode rsi --n-substeps 2 --max-episode-steps 300 \\
      --obs-mode full --num-envs 64 --num-iters 800

Without ``--device cpu`` it runs on the CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from collections import deque

import numpy as np
import torch

from deepmimic_mujoco_torch.algos.bc import behavior_clone
from deepmimic_mujoco_torch.algos.dataset import MujocoDset
from deepmimic_mujoco_torch.algos.gail import GAIL, GAILConfig
from deepmimic_mujoco_torch.algos.trpo import TRPOConfig
from deepmimic_mujoco_torch.envs.dp_env_v3 import DPEnvV3
from deepmimic_mujoco_torch.io_utils import checkpoint
from deepmimic_mujoco_torch.models.policy import MlpPolicy
from deepmimic_mujoco_torch.physics.humanoid import build_humanoid
from deepmimic_mujoco_torch.utils import logger
from deepmimic_mujoco_torch.utils.device import resolve_device
from deepmimic_mujoco_torch.utils.monitor import Monitor


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--env-id", default="DPEnvV3", choices=["DPEnvV3"])
    p.add_argument("--motion", default="walk")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--expert-path", required=True)
    p.add_argument("--traj-limitation", type=int, default=-1)
    p.add_argument("--g-step", type=int, default=3)
    p.add_argument("--d-step", type=int, default=1)
    p.add_argument("--num-timesteps", type=int, default=5_000_000)
    p.add_argument("--timesteps-per-batch", type=int, default=1024)
    p.add_argument("--num-envs", type=int, default=8)
    p.add_argument("--max-kl", type=float, default=0.01)
    p.add_argument("--policy-entcoeff", type=float, default=0.0)
    p.add_argument("--adversary-entcoeff", type=float, default=1e-3)
    p.add_argument("--adversary-hidden-size", type=int, default=100)
    p.add_argument("--d-stepsize", type=float, default=3e-4)
    p.add_argument("--d-exact", type=int, default=1,
                   help="1 = the reference's d-step (one sequential sweep "
                        "of the shuffled last segment, a sequential expert "
                        "cursor); 0 = random subsamples")
    p.add_argument("--pretrained", action="store_true",
                   help="behaviour-cloning pretraining")
    p.add_argument("--bc-max-iters", type=int, default=10_000)
    p.add_argument("--checkpoint-dir", default="checkpoint_tmp")
    p.add_argument("--log-dir", default="log_tmp")
    p.add_argument("--num-iters", type=int, default=0)
    p.add_argument("--reward-mode", default="alive",
                   choices=["alive", "mocap", "imitation", "imitation_dm"],
                   help="the TRUE-reward env config; the learning signal "
                        "is always the discriminator's")
    p.add_argument("--control-mode", default="torque",
                   choices=["torque", "pd", "pd_residual"])
    p.add_argument("--n-substeps", type=int, default=1)
    p.add_argument("--max-episode-steps", type=int, default=0)
    p.add_argument("--obs-mode", default=None, choices=["legacy", "full"])
    p.add_argument("--termination", default=None,
                   choices=["com", "fall_contact"])
    p.add_argument("--reset-mode", default="noise", choices=["noise", "rsi"])
    p.add_argument("--fixed-logstd", type=float, default=None)
    p.add_argument("--hidden-sizes", default=None,
                   help="comma list, e.g. 1024,512")
    p.add_argument("--activation", default="tanh", choices=["tanh", "relu"])
    p.add_argument("--save-per-iter", type=int, default=100)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; pass cpu for the CPU)")
    return p


def main(argv=None):
    """Trains; returns the final ``GAILState``."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    env = DPEnvV3(
        clip=args.motion, model=build_humanoid(device=device),
        reward_mode=args.reward_mode, control_mode=args.control_mode,
        n_substeps=args.n_substeps, max_episode_steps=args.max_episode_steps,
        obs_mode=args.obs_mode, termination=args.termination)
    hidden_sizes = (tuple(int(h) for h in args.hidden_sizes.split(","))
                    if args.hidden_sizes else None)
    policy = MlpPolicy(ob_dim=env.observation_size, ac_dim=env.action_size,
                       fixed_logstd=args.fixed_logstd,
                       hidden_sizes=hidden_sizes, activation=args.activation)
    dset = MujocoDset(args.expert_path, traj_limitation=args.traj_limitation)
    if dset.obs.shape[1] != env.observation_size:
        raise ValueError(
            f"expert obs dim {dset.obs.shape[1]} != env obs dim "
            f"{env.observation_size}: the expert data was sampled under "
            "another env configuration (obs-mode / reward-mode / phase)")

    cfg = GAILConfig(
        trpo=TRPOConfig(
            horizon=args.timesteps_per_batch, num_envs=args.num_envs,
            g_step=args.g_step, max_kl=args.max_kl,
            entcoeff=args.policy_entcoeff, reset_mode=args.reset_mode),
        d_step=args.d_step, d_stepsize=args.d_stepsize,
        d_exact=bool(args.d_exact))
    learner = GAIL(env, policy, dset.obs, dset.acs, cfg,
                   adversary_hidden=args.adversary_hidden_size,
                   adversary_entcoeff=args.adversary_entcoeff)
    state = learner.init(torch.Generator(device=device).manual_seed(args.seed))
    if args.pretrained:
        params = behavior_clone(policy, state.trpo.params, dset,
                                max_iters=args.bc_max_iters)
        state = dataclasses.replace(
            state, trpo=dataclasses.replace(state.trpo, params=params))

    name = f"{args.env_id}/gail-{args.motion}-{args.seed}"
    log_dir = os.path.join(args.log_dir, name)
    ckpt = os.path.join(args.checkpoint_dir, name, "gail_state")
    logger.configure(log_dir)
    monitor = Monitor(os.path.join(log_dir, "monitor.json"))
    lenbuffer, rewbuffer, truebuffer = (deque(maxlen=40) for _ in range(3))
    timesteps = iters = 0
    tstart = time.time()
    try:
        while True:
            if args.num_iters and iters >= args.num_iters:
                break
            if not args.num_iters and timesteps >= args.num_timesteps:
                break
            state, stats = learner.iteration(state)
            t = stats.trpo
            if int(t.ep_count):
                # one row per finished episode, in completion order; the
                # monitor records the TRUE return
                lens = t.ep_lens.reshape(-1).cpu().numpy()
                rets = t.ep_rets.reshape(-1).cpu().numpy()
                trues = stats.true_ep_rets.reshape(-1).cpu().numpy()
                ended = lens > 0
                for r, tr, n in zip(rets[ended], trues[ended], lens[ended]):
                    rewbuffer.append(float(r))
                    truebuffer.append(float(tr))
                    lenbuffer.append(int(n))
                    monitor.record(float(tr), int(n))
            timesteps += int(t.timesteps)
            iters += 1
            for key, buf in (("EpLenMean", lenbuffer),
                             ("EpRewMean", rewbuffer),
                             ("EpTrueRewMean", truebuffer)):
                logger.record_tabular(key, np.mean(buf) if buf else np.nan)
            logger.record_tabular("DLoss", float(stats.d_loss))
            logger.record_tabular("GenAcc", float(stats.gen_acc))
            logger.record_tabular("ExpertAcc", float(stats.exp_acc))
            logger.record_tabular("TimestepsSoFar", timesteps)
            logger.record_tabular("TimeElapsed", time.time() - tstart)
            logger.dump_tabular()
            if iters % args.save_per_iter == 0:
                checkpoint.save(ckpt, state)
        checkpoint.save(ckpt, state)
    finally:
        monitor.close()
    return state


if __name__ == "__main__":
    main()
