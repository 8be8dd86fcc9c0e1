"""Legacy v1 mocap surface (port of ``deepmimic_mujoco_tpu/mocap/
legacy.py``): the reference's ``mocap_v1.MocapDM``, which the earliest
DPEnv generation read, over the port's loader.

What v1 does unlike the v2 loader, kept as JAX keeps it:

* ``data`` keeps the joint rotations as quaternions: rows [duration,
  root_pos3, root_quat4, per-joint quat4/scalar] in MuJoCo joint order
  (``MocapClip.quat_frames``);
* ``data_angle`` mixes representations: root pos (3), root quat (4, not
  euler), and each joint as a hand-rolled roll-pitch-yaw triple or scalar;
* ``data_vel`` is the loader's ``qvel`` as lists, its first row zero;
* :func:`quat2euler` is v1's aircraft roll-pitch-yaw conversion.
"""

from __future__ import annotations

import math

import numpy as np

from deepmimic_mujoco_torch.mocap.constants import (
    BODY_DEFS,
    BODY_JOINTS,
    DOF_DEF,
)
from deepmimic_mujoco_torch.mocap.loader import MocapClip, load_clip


def quat2euler(elements) -> list:
    """wxyz quaternion → [roll, pitch, yaw] (v1's hand-rolled formula)."""
    q0, q1, q2, q3 = (float(e) for e in elements[:4])
    phi = math.atan2(2.0 * (q0 * q1 + q2 * q3),
                     1.0 - 2.0 * (q1 * q1 + q2 * q2))
    theta = math.asin(max(-1.0, min(1.0, 2.0 * (q0 * q2 - q3 * q1))))
    psi = math.atan2(2.0 * (q0 * q3 + q1 * q2),
                     1.0 - 2.0 * (q2 * q2 + q3 * q3))
    return [phi, theta, psi]


class MocapV1:
    """v1 ``MocapDM`` API over the port's clip pipeline."""

    def __init__(self):
        self.num_bodies = len(BODY_DEFS)
        self.pos_dim = 3
        self.rot_dim = 4

    def load_mocap(self, filepath_or_name: str) -> None:
        """A ``.txt``/``.json`` DeepMimic clip or ``.npz`` bundle by path,
        else a bundled clip by name."""
        if filepath_or_name.endswith((".txt", ".json", ".npz")):
            clip = load_clip(filepath_or_name)
        else:
            from deepmimic_mujoco_torch.mocap.registry import get_clip

            clip = get_clip(filepath_or_name)
        self._from_clip(clip)

    def _from_clip(self, clip: MocapClip) -> None:
        self.clip = clip
        qf = np.asarray(clip.quat_frames)
        self.dt = clip.dt
        self.durations = qf[:, 0].tolist()
        self.data = qf.copy()

        # per-frame dicts of the aligned values
        self.all_states = []
        for k in range(len(qf)):
            st = {"root_pos": qf[k, 1:4], "root_rot": qf[k, 4:8]}
            off = 8
            for j in BODY_JOINTS:
                n = 4 if DOF_DEF[j] == 3 else 1
                st[j] = qf[k, off:off + n]
                off += n
            self.all_states.append(st)

        qvel = np.asarray(clip.qvel)
        self.data_vel = [[0.0] * qvel.shape[1]] + [row.tolist()
                                                   for row in qvel[1:]]

        self.data_angle = []
        for st in self.all_states:
            row = list(st["root_pos"]) + list(st["root_rot"])
            for j in BODY_JOINTS:
                if DOF_DEF[j] == 3:
                    row += quat2euler(st[j])
                else:
                    row += [float(st[j][0])]
            self.data_angle.append(row)
