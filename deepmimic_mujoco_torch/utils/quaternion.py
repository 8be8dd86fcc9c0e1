"""Batched quaternion algebra in PyTorch (port of
``deepmimic_mujoco_tpu/utils/quaternion.py``).
Quaternions are ``(..., 4)`` in wxyz order; every function broadcasts over
leading dimensions."""

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


def rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate ``v`` by the inverse of ``q``: ``R(q)ᵀ @ v``."""
    return rotate(conj(q), v)


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


def from_mat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) → unit quaternion (..., 4), w ≥ 0, by
    Shepperd's method without branches: all four candidates are built (each
    square root floored at ``_EPS``) and chosen in JAX's order — w where the
    trace is positive, else x where m00 is the largest diagonal entry, else
    y where m11 > m22, else z."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=_EPS))

    s_w = safe_sqrt(1.0 + tr) * 2.0  # 4w
    q_w = torch.stack([0.25 * s_w, (m21 - m12) / s_w, (m02 - m20) / s_w,
                       (m10 - m01) / s_w], dim=-1)
    s_x = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0  # 4x
    q_x = torch.stack([(m21 - m12) / s_x, 0.25 * s_x, (m01 + m10) / s_x,
                       (m02 + m20) / s_x], dim=-1)
    s_y = safe_sqrt(1.0 - m00 + m11 - m22) * 2.0  # 4y
    q_y = torch.stack([(m02 - m20) / s_y, (m01 + m10) / s_y, 0.25 * s_y,
                       (m12 + m21) / s_y], dim=-1)
    s_z = safe_sqrt(1.0 - m00 - m11 + m22) * 2.0  # 4z
    q_z = torch.stack([(m10 - m01) / s_z, (m02 + m20) / s_z,
                       (m12 + m21) / s_z, 0.25 * s_z], dim=-1)
    cond_w = (tr > 0.0)[..., None]
    cond_x = ((m00 > m11) & (m00 > m22))[..., None]
    cond_y = (m11 > m22)[..., None]
    q = torch.where(cond_w, q_w,
                    torch.where(cond_x, q_x, torch.where(cond_y, q_y, q_z)))
    q = torch.where(q[..., :1] < 0, -q, q)
    return normalize(q)


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


def log_map(q: torch.Tensor) -> torch.Tensor:
    """Rotation vector (axis·angle, angle wrapped to (−π, π]) of ``q``; zero
    where the axis is (|v| ≤ 1e-9, :func:`to_axis_angle`'s branch)."""
    axis, angle = to_axis_angle(q)
    return axis * angle[..., None]


def angular_velocity(q0: torch.Tensor, q1: torch.Tensor, dt) -> torch.Tensor:
    """Angular velocity taking ``q0`` to ``q1`` over ``dt``: the body-frame
    difference ``q0* ⊗ q1`` as axis·angle / dt (the call order of the
    reference's ``calc_rot_vel`` is kept)."""
    axis, angle = to_axis_angle(mul(conj(q0), q1))
    return (angle / dt)[..., None] * axis


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


def integrate_world(q: torch.Tensor, omega: torch.Tensor, dt) -> torch.Tensor:
    """Integrate by the *world-frame* angular velocity: q ← exp(ω dt) ⊗ q."""
    return normalize(mul(exp_map(omega * dt), q))


def euler_rxyz_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (..., 4) → intrinsic-xyz euler angles (..., 3), the
    humanoid's x, y, z hinge triple: R = Rx(a)·Ry(b)·Rz(c), b = atan2(R02,
    |cos b|), a = atan2(−R12, R22), c = atan2(−R01, R00).  At the gimbal
    (|cos b| < 1e-8) a = 0 and c = atan2(R10, R11).  The matrix is that of
    ``normalize(q)``, in that order, so the angles round as JAX's do."""
    m = to_mat(normalize(q))
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m12, m22 = m[..., 1, 2], m[..., 2, 2]
    m10, m11 = m[..., 1, 0], m[..., 1, 1]
    cy = torch.sqrt(m00 * m00 + m01 * m01)
    gimbal = cy < 1e-8
    a = torch.where(gimbal, torch.zeros_like(cy), torch.atan2(-m12, m22))
    b = torch.atan2(m02, cy)
    c = torch.where(gimbal, torch.atan2(m10, m11), torch.atan2(-m01, m00))
    return torch.stack([a, b, c], dim=-1)
