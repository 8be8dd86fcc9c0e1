#!/usr/bin/env python3
"""State-setting study (port of ``tools/setting_states.py``, the analogue of
the reference's ``setting_states`` scripts): mocap frames written straight
into qpos and qvel, and the dynamics quantities the PD controller relies on
read at each: the CoM height, ‖bias force‖ (``qfrc_bias``: Coriolis,
centrifugal and gravity at zero acceleration), ‖qacc‖ of the passive
forward dynamics (zero control) and the mean finite-difference velocity
error |(q[k+1] − q[k])/dt − qvel[k+1]| of the hinges.  Every frame is one
env of a single batch.  Headless; prints a per-frame table.  Without
``--device cpu`` it runs on the CUDA card.

    python -m deepmimic_mujoco_torch.cli.setting_states --motion walk \
        --frames 10
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from deepmimic_mujoco_torch.mocap.registry import get_clip
from deepmimic_mujoco_torch.physics import dynamics, engine, kinematics
from deepmimic_mujoco_torch.physics.humanoid import build_humanoid

COLUMNS = ("com_z", "bias", "qacc", "fd_vel_err")


def frame_table(clip, n_frames: int, device=None) -> dict:
    """{column: (n,) numpy array} for the first ``n`` = min(``n_frames``,
    T − 1) frames of ``clip`` under ``build_humanoid()``."""
    model = build_humanoid(device=device)
    n = min(n_frames, len(clip) - 1)
    dev = model.device
    qpos = torch.as_tensor(clip.qpos[:n], dtype=torch.float32, device=dev)
    qvel = torch.as_tensor(clip.qvel[:n], dtype=torch.float32, device=dev)
    kin = kinematics.fk(model, qpos)
    com = kinematics.mass_center(model, kin)
    bias = dynamics.bias_force(model, kin, qvel)
    fwd = engine.forward(model, qpos, qvel,
                         torch.zeros(n, model.nu, device=dev))
    # does (frame[k+1] − frame[k])/dt match the stored clip velocity?  (the
    # v1 env's velocity-consistent reset)
    fd = (clip.qpos[1:n + 1, 7:] - clip.qpos[:n, 7:]) / clip.dt
    return {"com_z": com[:, 2].cpu().numpy(),
            "bias": torch.linalg.norm(bias, dim=1).cpu().numpy(),
            "qacc": torch.linalg.norm(fwd.qacc, dim=1).cpu().numpy(),
            "fd_vel_err": np.abs(fd - clip.qvel[1:n + 1, 6:]).mean(axis=1)}


def main(argv=None) -> dict:
    """Returns :func:`frame_table`'s columns."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--motion", default="walk")
    p.add_argument("--frames", type=int, default=10)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; pass cpu for the CPU)")
    args = p.parse_args(argv)

    clip = get_clip(args.motion)
    print(f"clip {args.motion}: {len(clip)} frames @ {clip.dt:.4f}s")
    table = frame_table(clip, args.frames, args.device)
    print(f"{'frame':>5} {'com_z':>7} {'|bias|':>9} {'|qacc|':>9} "
          f"{'fd_vel_err':>10}")
    for k in range(len(table["com_z"])):
        print(f"{k:5d} {table['com_z'][k]:7.3f} {table['bias'][k]:9.2f} "
              f"{table['qacc'][k]:9.2f} {table['fd_vel_err'][k]:10.4f}")
    return table


if __name__ == "__main__":
    main()
