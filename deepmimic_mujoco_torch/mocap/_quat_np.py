"""Float64 numpy quaternion helpers for host-side clip conversion (copy of
``deepmimic_mujoco_tpu/mocap/_quat_np.py``).  wxyz order."""

from __future__ import annotations

import numpy as np


def mul(q: np.ndarray, r: np.ndarray) -> np.ndarray:
    w1, x1, y1, z1 = q
    w2, x2, y2, z2 = r
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def conj(q: np.ndarray) -> np.ndarray:
    return np.array([q[0], -q[1], -q[2], -q[3]])


def axis_angle(q: np.ndarray) -> tuple[np.ndarray, float]:
    """pyquaternion ``.axis``/``.angle``: normalize, angle wrapped to (-π, π]."""
    q = q / np.linalg.norm(q)
    n = np.linalg.norm(q[1:])
    angle = 2.0 * np.arctan2(n, q[0])
    if angle > np.pi:
        angle -= 2.0 * np.pi
    axis = q[1:] / n if n > 1e-12 else np.zeros(3)
    return axis, angle


def rot_vel(q0: np.ndarray, q1: np.ndarray, dt: float) -> np.ndarray:
    """Axis-angle of q0* ⊗ q1 over dt."""
    axis, angle = axis_angle(mul(conj(q0), q1))
    return (angle / dt) * axis


def to_mat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def euler_rxyz(q: np.ndarray) -> np.ndarray:
    """Intrinsic-xyz euler extraction (Gohlke 'rxyz', incl. gimbal branch)."""
    m = to_mat(q)
    cy = np.hypot(m[0, 0], m[0, 1])
    if cy > 1e-8:
        a = np.arctan2(-m[1, 2], m[2, 2])
        b = np.arctan2(m[0, 2], cy)
        c = np.arctan2(-m[0, 1], m[0, 0])
    else:
        a = 0.0
        b = np.arctan2(m[0, 2], cy)
        c = np.arctan2(m[1, 0], m[1, 1])
    return np.array([a, b, c])


def from_euler_rxyz(e: np.ndarray) -> np.ndarray:
    """The quaternion (w, x, y, z) of intrinsic-xyz euler angles: the
    inverse of :func:`euler_rxyz`."""
    ha, hb, hc = np.asarray(e, np.float64) / 2.0
    ca, sa, cb, sb = np.cos(ha), np.sin(ha), np.cos(hb), np.sin(hb)
    cc, sc = np.cos(hc), np.sin(hc)
    return np.array([
        ca * cb * cc - sa * sb * sc,
        sa * cb * cc + ca * sb * sc,
        ca * sb * cc - sa * cb * sc,
        ca * cb * sc + sa * sb * cc,
    ])


def align_rotation(q: np.ndarray) -> np.ndarray:
    """DeepMimic Y-up → MuJoCo Z-up frame change (w unchanged,
    v → (vx, -vz, vy))."""
    w, x, y, z = q
    return np.array([w, x, -z, y])


def align_position(p: np.ndarray) -> np.ndarray:
    """(x, y, z)_Yup → (x, -z, y)_Zup."""
    return np.array([p[0], -p[2], p[1]])
