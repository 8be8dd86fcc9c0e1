"""DeepMimic motion-clip pipeline (numpy copy of ``deepmimic_mujoco_tpu/
mocap/loader.py``): DeepMimic JSON clips (``{"Loop": ..., "Frames":
[...]}``, in ``.txt`` or ``.json`` files) and the bundled ``.npz`` clips →
``convert_frames`` → ``MocapClip`` with ``qpos_cont`` / ``qvel_fd``.

Frames are ``[dt, root_pos3, root_quat4, <dp-order joint quats/scalars>]``;
the output is the MuJoCo layout (qpos 35, qvel 34), in float64."""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np

from deepmimic_mujoco_torch.mocap import _quat_np as qnp
from deepmimic_mujoco_torch.mocap.constants import (
    BODY_JOINTS,
    BODY_JOINTS_IN_DP_ORDER,
    DOF_DEF,
    NQ,
    NV,
)


@dataclasses.dataclass
class MocapClip:
    """A converted motion clip (host numpy, float64).

    name, loop ("wrap" | "none"), dt (first frame's duration), durations (T,),
    qpos (T, 35) and qvel (T, 34) in the reference's conversion semantics;
    quat_frames (T, 44): the aligned frames in MuJoCo joint order
    [duration, root_pos3, root_quat4, per-joint quat4/scalar] (the
    reference's ``MocapDM.data``); raw_frames (T, 44): the file's frames."""

    name: str
    loop: str
    dt: float
    durations: np.ndarray
    qpos: np.ndarray
    qvel: np.ndarray
    quat_frames: np.ndarray
    raw_frames: np.ndarray
    _qpos_cont: Optional[np.ndarray] = dataclasses.field(
        default=None, repr=False, compare=False)
    _qvel_fd: Optional[np.ndarray] = dataclasses.field(
        default=None, repr=False, compare=False)

    def __len__(self) -> int:
        return self.qpos.shape[0]

    @property
    def qpos_cont(self) -> np.ndarray:
        """Pose track with euler branch flips and ±2π jumps removed."""
        if self._qpos_cont is None:
            self._qpos_cont = continuous_qpos(self.qpos)
        return self._qpos_cont

    @property
    def qvel_fd(self) -> np.ndarray:
        """Integrator-consistent velocities: frame k's velocity takes
        qpos_cont[k] to qpos_cont[k+1] over durations[k]."""
        if self._qvel_fd is None:
            self._qvel_fd = consistent_qvel(self.qpos_cont, self.durations,
                                            self.loop)
        return self._qvel_fd

    @property
    def total_time(self) -> float:
        return float(self.durations.sum())

    def save_npz(self, path: str) -> None:
        """Write the raw frames, the loop flag and the name (the bundle
        :func:`load_npz` reads); conversion re-runs at load time."""
        np.savez(path, frames=self.raw_frames, loop=self.loop, name=self.name)


def continuous_qpos(qpos: np.ndarray) -> np.ndarray:
    """Re-pick, per spherical triple per frame, the euler branch (and per-dof
    2π shift) closest to the previous frame; unwrap 1-dof joints."""
    out = np.array(qpos, dtype=np.float64, copy=True)
    off = 7
    for j in BODY_JOINTS:
        if DOF_DEF[j] == 3:
            for k in range(1, out.shape[0]):
                out[k, off:off + 3] = _nearest_branch(
                    out[k - 1, off:off + 3], qpos[k, off:off + 3])
            off += 3
        else:
            out[:, off] = np.unwrap(qpos[:, off])
            off += 1
    return out


def _nearest_branch(prev3: np.ndarray, e3: np.ndarray) -> np.ndarray:
    """Of e3 and its twin (x+π, π−y, z+π), with per-dof 2π shifts, the one
    closest to ``prev3``."""
    two_pi = 2.0 * np.pi
    alt = np.array([e3[0] + np.pi, np.pi - e3[1], e3[2] + np.pi])
    best, bestd = None, np.inf
    for c in (e3, alt):
        c = c + two_pi * np.round((prev3 - c) / two_pi)
        d = np.abs(c - prev3).max()
        if d < bestd:
            best, bestd = c, d
    return best


def consistent_qvel(qpos: np.ndarray, durations: np.ndarray,
                    loop: str) -> np.ndarray:
    """(T, NV) velocities with ``integrate_pos(qpos[k], qvel[k],
    durations[k]) == qpos[k+1]``; looping clips close the cycle through the
    ground-plane offset, non-looping clips hold the previous velocity."""
    T = qpos.shape[0]
    qv = np.zeros((T, NV))
    nxt = np.empty_like(qpos)
    nxt[:-1] = qpos[1:]
    if loop == "wrap":
        nxt[-1] = qpos[0]
        off = qpos[-1, 0:3] - qpos[0, 0:3]
        off[2] = 0.0
        nxt[-1, 0:3] += off
        o = 7
        for j in BODY_JOINTS:
            if DOF_DEF[j] == 3:
                nxt[-1, o:o + 3] = _nearest_branch(
                    qpos[-1, o:o + 3], qpos[0, o:o + 3])
                o += 3
            else:
                d1 = nxt[-1, o] - qpos[-1, o]
                nxt[-1, o] = qpos[-1, o] + (
                    np.mod(d1 + np.pi, 2.0 * np.pi) - np.pi)
                o += 1
    else:
        nxt[-1] = qpos[-1]
    dt = float(durations[0])
    for k in range(T):
        d = float(durations[k])
        if d <= 1e-9:
            d = dt
        qv[k, 0:3] = (nxt[k, 0:3] - qpos[k, 0:3]) / d
        qv[k, 3:6] = qnp.rot_vel(qpos[k, 3:7], nxt[k, 3:7], d)
        dq = nxt[k, 7:] - qpos[k, 7:]
        qv[k, 6:] = (np.mod(dq + np.pi, 2.0 * np.pi) - np.pi) / d
    if loop != "wrap" and T > 1:
        qv[-1] = qv[-2]
    return qv


def _parse_frame(frame: np.ndarray) -> dict:
    """Split one raw frame into aligned root + dp-order joint states."""
    state = {
        "root_pos": qnp.align_position(frame[1:4]),
        "root_rot": qnp.align_rotation(frame[4:8]),
    }
    off = 8
    for joint in BODY_JOINTS_IN_DP_ORDER:
        dof = DOF_DEF[joint]
        if dof == 1:
            state[joint] = frame[off:off + 1].copy()
            off += 1
        elif dof == 3:
            state[joint] = qnp.align_rotation(frame[off:off + 4])
            off += 4
    return state


def convert_frames(frames: np.ndarray, loop: str = "wrap",
                   name: str = "clip") -> MocapClip:
    """Raw (T, 44) DeepMimic frames → :class:`MocapClip`."""
    frames = np.asarray(frames, dtype=np.float64)
    T = frames.shape[0]
    durations = frames[:, 0].copy()
    states = [_parse_frame(frames[k]) for k in range(T)]
    quat_frames = np.full((T, frames.shape[1]), np.nan)
    qpos = np.zeros((T, NQ))
    qvel = np.zeros((T, NV))
    prev = None
    for k in range(T):
        st = states[k]
        dura = durations[k] if k == 0 else durations[k - 1]
        quat_frames[k, 0] = dura
        quat_frames[k, 1:4] = st["root_pos"]
        quat_frames[k, 4:8] = st["root_rot"]
        off_q = 8
        for joint in BODY_JOINTS:
            n = 1 if DOF_DEF[joint] == 1 else 4
            quat_frames[k, off_q:off_q + n] = st[joint]
            off_q += n
        qpos[k, 0:3] = st["root_pos"]
        qpos[k, 3:7] = st["root_rot"]
        if k > 0:
            qvel[k, 0:3] = (st["root_pos"] - prev["root_pos"]) / dura
            # the reference's (curr, prev) argument order
            qvel[k, 3:6] = qnp.rot_vel(st["root_rot"], prev["root_rot"], dura)
        off_p, off_v = 7, 6
        for joint in BODY_JOINTS:
            if DOF_DEF[joint] == 1:
                qpos[k, off_p] = st[joint][0]
                if k > 0:
                    qvel[k, off_v] = (st[joint][0] - prev[joint][0]) / dura
                off_p += 1
                off_v += 1
            else:
                qpos[k, off_p:off_p + 3] = qnp.euler_rxyz(st[joint])
                if k > 0:
                    qvel[k, off_v:off_v + 3] = qnp.rot_vel(
                        st[joint], prev[joint], dura)
                off_p += 3
                off_v += 3
        prev = st
    return MocapClip(name=name, loop=loop, dt=float(durations[0]),
                     durations=durations, qpos=qpos, qvel=qvel,
                     quat_frames=quat_frames, raw_frames=frames)


def load_deepmimic_json(path: str, name: Optional[str] = None) -> MocapClip:
    """A DeepMimic JSON clip (``Frames`` and ``Loop``, which defaults to
    "wrap"); ``name`` defaults to the file's base name."""
    with open(path, "r") as fin:
        data = json.load(fin)
    frames = np.asarray(data["Frames"], dtype=np.float64)
    loop = str(data.get("Loop", "wrap"))
    if name is None:
        name = os.path.splitext(os.path.basename(path))[0]
    return convert_frames(frames, loop=loop, name=name)


def load_npz(path: str) -> MocapClip:
    """Load a clip bundled as ``.npz`` (raw frames, loop flag, name)."""
    with np.load(path, allow_pickle=False) as z:
        frames = np.asarray(z["frames"], dtype=np.float64)
        loop = str(z["loop"])
        name = str(z["name"])
    return convert_frames(frames, loop=loop, name=name)


def load_clip(path_or_name: str) -> MocapClip:
    """Load by file path (a ``.npz`` bundle, or any other file as DeepMimic
    JSON: ``.txt`` and ``.json``) or by bundled clip name."""
    if os.path.exists(path_or_name):
        if path_or_name.endswith(".npz"):
            return load_npz(path_or_name)
        return load_deepmimic_json(path_or_name)
    from deepmimic_mujoco_torch.mocap.registry import get_clip
    return get_clip(path_or_name)
