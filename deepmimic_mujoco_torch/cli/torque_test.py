#!/usr/bin/env python3
"""P-control mocap-tracking smoke test (port of ``deepmimic_mujoco_tpu/cli/
torque_test.py``, the reference's ``env_torque_test.py``): track the clip
through the physics with the action ``kp·(q_ref − q)`` on ``DPEnvV3(
reward_mode="mocap")`` from frame 0, print the reward, root height and
done flag every 20 steps and the mean tracking reward.  Checks the
actuators and the reward plumbing.  Without ``--device cpu`` it runs on
the CUDA card."""

from __future__ import annotations

import argparse

import torch

from deepmimic_mujoco_torch.envs.dp_env_v3 import DPEnvV3
from deepmimic_mujoco_torch.physics.humanoid import build_humanoid


def main(argv=None) -> float:
    """Returns the mean tracking reward."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--motion", default="walk")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--kp", type=float, default=0.8)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; pass cpu for the CPU)")
    args = p.parse_args(argv)

    env = DPEnvV3(clip=args.motion, reward_mode="mocap",
                  model=build_humanoid(device=args.device))
    state = env.reset_at([0])
    total = 0.0
    for t in range(args.steps):
        ref = env.clip_qpos[torch.remainder(state.mocap_idx, env.clip_len)]
        state = env.step(state, args.kp * (ref[:, 7:] - state.qpos[:, 7:]))
        total += float(state.reward[0])
        if (t + 1) % 20 == 0:
            print(f"step {t+1}: reward {float(state.reward[0]):.4f} "
                  f"root z {float(state.qpos[0, 2]):.3f} "
                  f"done {bool(state.done[0])}")
    mean = total / args.steps
    print(f"mean tracking reward over {args.steps} steps: {mean:.4f}")
    return mean


if __name__ == "__main__":
    main()
