#!/usr/bin/env python3
"""PPO training CLI of the original DeepMimic learning stack (port of
``deepmimic_mujoco_tpu/cli/train_ppo.py``, with its flags and ``--device``):
the fc_2layers_1024units agent of a JSON spec (``--agent-spec``, default
the spec of ``assets/agents/ct_agent_humanoid_ppo.json``), trained by the
replay-buffer driver (``dp_policy/rl_agent.py``).

  # the original training surface: 197-D record_state, 36-D PD targets
  python -m deepmimic_mujoco_torch.cli.train_ppo --surface deepmimic \\
      --motion walk --num-iters 100

  # DPEnvV3 (56-D obs, 28-D torque), the standup task
  python -m deepmimic_mujoco_torch.cli.train_ppo --surface v3 --motion walk

  # the bundled r5 run's flags, resumed from its params
  python -m deepmimic_mujoco_torch.cli.train_ppo --surface deepmimic \\
      --motion walk --num-envs 512 --num-iters 700 \\
      --resume train_ckpt_dp_ppo_r5/deepmimic/ppo-walk-0/ppo_params.npz

Each iteration logs the train step's metrics, ``avg_path_reward``,
``Samples`` and ``TimeElapsed`` under ``{log_dir}/{surface}/ppo-{motion}-
{seed}``, and ``Test_Return``/``Test_Length`` of 16 deterministic episodes
every ``--test-every`` iterations; ``ppo_params.npz`` (the JAX layout) is
written every ``--save-every`` iterations and at the end.  ``--resume``
reads params only.  Without ``--device cpu`` it runs on the CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from deepmimic_mujoco_torch.dp_policy.ppo_agent import PPOAgent
from deepmimic_mujoco_torch.dp_policy.rl_agent import RLAgentDriver
from deepmimic_mujoco_torch.envs.deepmimic_surface import DeepMimicSurfaceEnv
from deepmimic_mujoco_torch.envs.dp_env_v3 import DPEnvV3
from deepmimic_mujoco_torch.io_utils import checkpoint
from deepmimic_mujoco_torch.utils import logger
from deepmimic_mujoco_torch.utils.device import resolve_device

_PLATFORMS = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--motion", default="walk")
    p.add_argument("--surface", default="deepmimic",
                   choices=["deepmimic", "v3"],
                   help="deepmimic = the original 197-D record_state / 36-D "
                        "PD-target surface; v3 = DPEnvV3's obs/torque "
                        "surface")
    p.add_argument("--reward-mode", default=None,
                   help="default: imitation_dm on the deepmimic surface, "
                        "alive on v3")
    p.add_argument("--agent-spec", default=None,
                   help="JSON agent spec (ct_agent_humanoid_ppo format)")
    p.add_argument("--num-envs", type=int, default=32)
    p.add_argument("--num-iters", type=int, default=100)
    p.add_argument("--max-episode-steps", type=int, default=300)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--test-every", type=int, default=10)
    p.add_argument("--save-every", type=int, default=50)
    p.add_argument("--log-dir", default="log_tmp")
    p.add_argument("--checkpoint-dir", default="checkpoint_tmp")
    p.add_argument("--resume", default=None)
    p.add_argument("--platform", default=None, choices=sorted(_PLATFORMS),
                   help="the JAX CLI's flag: cpu, or gpu for the card")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; pass cpu for the CPU)")
    return p


def main(argv=None) -> dict:
    """Train; returns the final params."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device or _PLATFORMS.get(args.platform))
    spec = None
    if args.agent_spec:
        with open(args.agent_spec) as f:
            spec = json.load(f)

    if args.surface == "deepmimic":
        env = DeepMimicSurfaceEnv(
            clip=args.motion, reward_mode=args.reward_mode or "imitation_dm",
            max_episode_steps=args.max_episode_steps, device=device)
        # the normalizers start from the env's offset/scale/group builders
        agent = PPOAgent.for_env(env, spec=spec, reward_bounds=(0.0, 1.0))
    else:
        env = DPEnvV3(clip=args.motion,
                      reward_mode=args.reward_mode or "alive", device=device)
        ctrl = env.model.ctrl_range.cpu().numpy()
        agent = PPOAgent(env.observation_size, env.action_size, spec=spec,
                         action_bounds=(ctrl[:, 0], ctrl[:, 1]),
                         reward_bounds=(0.0, 1.0))
    driver = RLAgentDriver(env, agent, num_envs=args.num_envs, seed=args.seed)

    name = f"{args.surface}/ppo-{args.motion}-{args.seed}"
    logger.configure(os.path.join(args.log_dir, name))

    params = agent.init(torch.Generator(device=device).manual_seed(args.seed),
                        device)
    if args.resume:
        params = checkpoint.load_dp_ppo_params(args.resume, agent, device)
    env_state = env.reset(
        torch.Generator(device=device).manual_seed(args.seed + 1),
        args.num_envs)

    ckpt = os.path.join(args.checkpoint_dir, name, "ppo_params")
    tstart = time.time()
    for it in range(args.num_iters):
        params, env_state, metrics = driver.train_iteration(params, env_state)
        logger.record_tabular("Iter", it)
        for k, v in metrics.items():
            logger.record_tabular(k, v)
        logger.record_tabular("Samples", float(params["sample_count"]))
        logger.record_tabular("TimeElapsed", time.time() - tstart)
        if args.test_every and (it + 1) % args.test_every == 0:
            ret, length = driver.test_episodes(params, n_episodes=16)
            logger.record_tabular("Test_Return", ret)
            logger.record_tabular("Test_Length", length)
        if args.save_every and (it + 1) % args.save_every == 0:
            checkpoint.save(ckpt, params)
        logger.dump_tabular()

    checkpoint.save(ckpt, params)
    print("saved", ckpt)
    return params


if __name__ == "__main__":
    main()
