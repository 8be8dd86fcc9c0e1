"""Batched quaternion algebra in PyTorch (port of the functions of
``deepmimic_mujoco_tpu/utils/quaternion.py`` that FK and the integrator
call).  Quaternions are ``(..., 4)`` in wxyz order; every function broadcasts
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


def from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Unit axis (..., 3) + angle (...) → quaternion (..., 4)."""
    half = 0.5 * angle
    return torch.cat([torch.cos(half)[..., None],
                      torch.sin(half)[..., None] * axis], dim=-1)


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
