"""Floor-plane collision with a static candidate set, and joint limits
(port of ``deepmimic_mujoco_tpu/physics/collision.py``).  Every candidate
point (sphere centre, capsule end, box corner) is evaluated every step and
inactive ones are masked: static shapes, no data-dependent control flow."""

from __future__ import annotations

from typing import NamedTuple

import torch

from deepmimic_mujoco_torch.physics.kinematics import Kin, point_jacobian
from deepmimic_mujoco_torch.physics.model import PhysicsModel
from deepmimic_mujoco_torch.utils import quaternion as quat

# geoms activate contacts within this distance (reference geom margin)
MARGIN = 1e-3


class Contacts(NamedTuple):
    pos: torch.Tensor     # (B, ncand) signed distance - margin (<0 ⇒ active)
    active: torch.Tensor  # (B, ncand) bool
    jac: torch.Tensor     # (B, ncand, 3, nv) rows: [normal(z); tangent x; tangent y]
    mu: torch.Tensor      # (ncand,)


def floor_contacts(model: PhysicsModel, kin: Kin) -> Contacts:
    b = model.cand_body
    p_w = kin.xpos[:, b] + quat.rotate(kin.xquat[:, b], model.cand_pos)
    dist = p_w[..., 2] - model.cand_radius
    pos = dist - MARGIN
    active = pos < 0.0
    # contact point on the surface, directly below the candidate centre
    r = model.cand_radius
    cpoint = p_w - torch.stack([torch.zeros_like(r), torch.zeros_like(r), r],
                               dim=-1)
    jp = point_jacobian(model, kin, b, cpoint)
    # constraint rows: normal (world z) first, then the two tangents (x, y)
    jac = jp[:, :, [2, 0, 1], :]
    return Contacts(pos=pos, active=active, jac=jac, mu=model.cand_mu)


class Limits(NamedTuple):
    pos: torch.Tensor     # (B, nh) signed distance to nearest violated bound
    active: torch.Tensor  # (B, nh) bool
    sign: torch.Tensor    # (B, nh) +1 lower bound, -1 upper bound


def joint_limits(model: PhysicsModel, qpos: torch.Tensor) -> Limits:
    q = qpos[:, 7:]
    lo, hi = model.hinge_range[:, 0], model.hinge_range[:, 1]
    d_lo = q - lo
    d_hi = hi - q
    lower_worse = d_lo < d_hi
    dist = torch.where(lower_worse, d_lo, d_hi)
    sign = torch.where(lower_worse, 1.0, -1.0).to(q.dtype)
    active = (dist < 0.0) & model.hinge_limited
    # unlimited hinges report a neutral depth so the deepest-first top-k
    # never ranks them above a violated limit row
    dist = torch.where(model.hinge_limited, dist, torch.zeros_like(dist))
    return Limits(pos=dist, active=active, sign=sign)
