#!/usr/bin/env python3
"""Query an action from a built agent (port of
``deepmimic_mujoco_tpu/cli/get_action.py``): build an ``RLWorld`` from an
arg file (``--arg-file assets/args/run_humanoid3d_walk_args.txt``, whose
``--model_files none`` builds a fresh agent) or from the default PPO spec,
query it with a zero state, print the first 8 entries of the action and
its shape.  Without ``--device cpu`` it runs on the CUDA card."""

from __future__ import annotations

import argparse

import numpy as np
import torch

from deepmimic_mujoco_torch.dp_policy.ppo_agent import PPOAgent
from deepmimic_mujoco_torch.dp_policy.rl_world import ActionGiver, RLWorld
from deepmimic_mujoco_torch.utils.arg_parser import ArgParser


def main(argv=None) -> np.ndarray:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arg-file", default=None)
    p.add_argument("--state-size", type=int, default=197)
    p.add_argument("--action-size", type=int, default=36)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; pass cpu for the CPU)")
    args = p.parse_args(argv)

    if args.arg_file:
        world = ActionGiver(args.arg_file, args.state_size, args.action_size,
                            device=args.device).world
    else:
        # one PPO agent of the built-in spec
        world = RLWorld(ArgParser(), args.state_size, args.action_size,
                        device=args.device)
        agent = PPOAgent(args.state_size, args.action_size)
        world.agents = [agent]
        world.agent_params = [agent.init(
            torch.Generator(device=world.device).manual_seed(0), world.device)]

    ac = world.get_action(0, np.zeros(args.state_size, np.float32))
    print("action:", np.round(ac[:8], 4), "...")
    print("shape:", ac.shape)
    return ac


if __name__ == "__main__":
    main()
