#!/usr/bin/env python3
"""Mocap playback smoke test (port of ``deepmimic_mujoco_tpu/cli/
play_mocap.py``): play a clip's frames with the root chained across cycles
(each cycle starts where the last ended, in the ground plane), and with
``--through-dynamics`` score every frame by one physics step from it
(``DPEnvV3(reward_mode="mocap")``, zero actions), printing the mean config
reward per cycle.  The frames of a cycle run as one batch: each starts
from its own frame, as in the JAX loop, so one batch serves every cycle.
``--video out.avi`` renders the played track through host MuJoCo at the
clip's frame rate (``io_utils/video.py``; MuJoCo and cv2 are checked
before anything runs).  Without ``--device cpu`` it runs on the CUDA
card."""

from __future__ import annotations

import argparse

import numpy as np
import torch

from deepmimic_mujoco_torch.envs.dp_env_v3 import DPEnvV3
from deepmimic_mujoco_torch.io_utils import video
from deepmimic_mujoco_torch.mocap.registry import get_clip
from deepmimic_mujoco_torch.physics.humanoid import build_humanoid


def main(argv=None) -> np.ndarray:
    """Returns the played (cycles·T, 35) qpos track."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--motion", default="spinkick")
    p.add_argument("--cycles", type=int, default=2)
    p.add_argument("--video", default=None, help="output .avi path")
    p.add_argument("--through-dynamics", action="store_true",
                   help="also step the physics from each frame")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; pass cpu for the CPU)")
    args = p.parse_args(argv)
    if args.video:
        video.require_renderer()

    clip = get_clip(args.motion)
    print(f"{clip.name}: {len(clip)} frames, dt={clip.dt:.4f}, "
          f"loop={clip.loop}")
    rewards = None
    if args.through_dynamics:
        env = DPEnvV3(clip=clip, reward_mode="mocap",
                      model=build_humanoid(device=args.device))
        state = env.reset_at(torch.arange(len(clip)))
        state = env.step(state, torch.zeros(len(clip), env.action_size,
                                            device=env.device))
        rewards = state.reward.cpu().numpy()

    qpos_track = []
    phase_offset = np.zeros(3)
    for cycle in range(args.cycles):
        for k in range(len(clip)):
            qpos = np.asarray(clip.qpos[k], np.float64).copy()
            qpos[:3] += phase_offset
            qpos_track.append(qpos)
        phase_offset = qpos_track[-1][:3].copy()
        phase_offset[2] = 0.0
        if rewards is not None:
            print(f"cycle {cycle}: mean config reward "
                  f"{np.mean(rewards):.4f}")
    if args.video:
        out = video.render_qpos_trajectory(
            np.stack(qpos_track), args.video, fps=int(round(1.0 / clip.dt)))
        print("wrote", out)
    return np.stack(qpos_track)


if __name__ == "__main__":
    main()
