"""Batched quaternion algebra in PyTorch (port of the functions of
``deepmimic_mujoco_tpu/utils/quaternion.py`` that FK, the integrator, the
root-aware observation and the imitation rewards call).  Quaternions are ``(..., 4)`` in wxyz order; every function broadcasts
over leading dimensions."""

from __future__ import annotations

import torch

_EPS = 1e-12


def normalize(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion along ``q`` (safe at ~zero norm)."""
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(n, min=_EPS)


def mul(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Hamilton product ``q ⊗ r``."""
    qw, qx, qy, qz = q.unbind(-1)
    rw, rx, ry, rz = r.unbind(-1)
    return torch.stack([
        qw * rw - qx * rx - qy * ry - qz * rz,
        qw * rx + qx * rw + qy * rz - qz * ry,
        qw * ry - qx * rz + qy * rw + qz * rx,
        qw * rz + qx * ry - qy * rx + qz * rw,
    ], dim=-1)


def conj(q: torch.Tensor) -> torch.Tensor:
    """Quaternion conjugate (the inverse of a unit quaternion)."""
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``R(q) @ v`` without forming the matrix: v + 2w(u×v) + 2u×(u×v)."""
    u = q[..., 1:]
    w = q[..., :1]
    u, v = torch.broadcast_tensors(u, v)
    uv = torch.linalg.cross(u, v)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv))


def to_mat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) → rotation matrix (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    row0 = torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1)
    row1 = torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1)
    row2 = torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def heading_inverse(q: torch.Tensor) -> torch.Tensor:
    """Rotation by −yaw(q) about z (DeepMimic's heading normalization):
    ``mul(heading_inverse(q), q)`` is ``q`` with its heading removed."""
    siny = 2.0 * (q[..., 0] * q[..., 3] + q[..., 1] * q[..., 2])
    cosy = 1.0 - 2.0 * (q[..., 2] ** 2 + q[..., 3] ** 2)
    half = -0.5 * torch.atan2(siny, cosy)
    zero = torch.zeros_like(half)
    return torch.stack([torch.cos(half), zero, zero, torch.sin(half)], dim=-1)


def from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Unit axis (..., 3) + angle (...) → quaternion (..., 4)."""
    half = 0.5 * angle
    return torch.cat([torch.cos(half)[..., None],
                      torch.sin(half)[..., None] * axis], dim=-1)


def to_axis_angle(q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Quaternion → (axis (..., 3), angle (...)), pyquaternion semantics:
    ``q`` is normalized first, angle = 2·atan2(|v|, w) wrapped to (−π, π],
    axis = v/|v| and zero where |v| ≤ 1e-9 (the JAX version's ``_EPS`` and
    threshold, on which ``angle_between`` near the identity depends)."""
    q = normalize(q)
    v = q[..., 1:]
    n = torch.linalg.vector_norm(v, dim=-1)
    angle = 2.0 * torch.atan2(n, q[..., 0])
    angle = torch.where(angle > torch.pi, angle - 2.0 * torch.pi, angle)
    axis = v / torch.clamp(n, min=_EPS)[..., None]
    axis = torch.where(n[..., None] > 1e-9, axis, torch.zeros_like(axis))
    return axis, angle


def angle_between(q0: torch.Tensor, q1: torch.Tensor) -> torch.Tensor:
    """Wrapped rotation angle of ``q0* ⊗ q1``."""
    return to_axis_angle(mul(conj(q0), q1))[1]


def quat_from_euler_rxyz(e: torch.Tensor) -> torch.Tensor:
    """Intrinsic-xyz euler angles (..., 3) → quaternion: qx(a) ⊗ qy(b) ⊗
    qz(c), the humanoid's stacked x, y, z hinge composition."""
    ha, hb, hc = 0.5 * e[..., 0], 0.5 * e[..., 1], 0.5 * e[..., 2]
    ca, sa = torch.cos(ha), torch.sin(ha)
    cb, sb = torch.cos(hb), torch.sin(hb)
    cc, sc = torch.cos(hc), torch.sin(hc)
    return torch.stack([
        ca * cb * cc - sa * sb * sc,
        sa * cb * cc + ca * sb * sc,
        ca * sb * cc - sa * cb * sc,
        ca * cb * sc + sa * sb * cc,
    ], dim=-1)


def exp_map(w: torch.Tensor) -> torch.Tensor:
    """Rotation vector (..., 3) → quaternion; first order below 1e-9 rad."""
    angle = torch.linalg.vector_norm(w, dim=-1)
    axis = w / torch.clamp(angle, min=_EPS)[..., None]
    q = from_axis_angle(axis, angle)
    small = torch.cat([torch.ones_like(angle)[..., None], 0.5 * w], dim=-1)
    return torch.where(angle[..., None] > 1e-9, q, small)


def integrate(q: torch.Tensor, omega: torch.Tensor, dt) -> torch.Tensor:
    """Integrate a unit quaternion by the *local-frame* angular velocity
    ``omega`` over ``dt`` (MuJoCo ``mju_quatIntegrate``: q ← q ⊗ exp(ω dt))."""
    return normalize(mul(q, exp_map(omega * dt)))
