"""Forward kinematics, batch-first (port of ``deepmimic_mujoco_tpu/physics/
kinematics.py``).  Every function takes a leading env axis ``B``; the JAX
package writes them per env and vmaps."""

from __future__ import annotations

from typing import NamedTuple

import torch

from deepmimic_mujoco_torch.physics.model import PhysicsModel
from deepmimic_mujoco_torch.utils import quaternion as quat


class Kin(NamedTuple):
    """World-frame kinematic quantities of a batch of configurations."""

    xpos: torch.Tensor        # (B, nbody, 3) body frame origins
    xquat: torch.Tensor       # (B, nbody, 4) body orientations
    xcom: torch.Tensor        # (B, nbody, 3) body COM positions
    rot_axes: torch.Tensor    # (B, nv, 3) world axis per rotational dof (0 for trans)
    trans_axes: torch.Tensor  # (nv, 3) world axis per translational dof
    anchors: torch.Tensor     # (B, nv, 3) world anchor per rotational dof


def fk(model: PhysicsModel, qpos: torch.Tensor) -> Kin:
    """qpos (B, nq) → :class:`Kin`.  Stacked hinges compose intrinsically, so
    an x,y,z hinge triple reproduces the mocap's euler-'rxyz' angles."""
    B = qpos.shape[0]
    nv = model.nv
    root_q = quat.normalize(qpos[:, 3:7])
    # every hinge's rotation at once: (B, nh, 4)
    hinge_q = quat.from_axis_angle(model.hinge_axis, qpos[:, 7:])

    xpos = [qpos[:, 0:3]]
    xquat = [root_q]
    hinge_axis_w = [None] * model.nhinge
    for i in range(1, model.nbody):
        p = model.parent[i]
        pos = xpos[p] + quat.rotate(xquat[p], model.body_pos[i])
        q = quat.mul(xquat[p], model.body_quat[i])
        for j in model.body_hinges[i]:
            hinge_axis_w[j] = quat.rotate(q, model.hinge_axis[j])
            q = quat.mul(q, hinge_q[:, j])
        xpos.append(pos)
        xquat.append(q)

    xpos = torch.stack(xpos, dim=1)
    xquat = torch.stack(xquat, dim=1)
    xcom = xpos + quat.rotate(xquat, model.body_com)

    zeros3 = qpos.new_zeros(B, 3, 3)
    root_r = quat.to_mat(root_q)  # local axes as columns
    rot_axes = torch.cat(
        [zeros3, root_r.transpose(-1, -2), torch.stack(hinge_axis_w, dim=1)],
        dim=1)
    trans_axes = torch.cat([torch.eye(3, dtype=qpos.dtype, device=qpos.device),
                            qpos.new_zeros(nv - 3, 3)])
    anchors = torch.cat([zeros3, xpos[:, 0:1].expand(B, 3, 3),
                         xpos[:, model.hinge_body]], dim=1)
    return Kin(xpos, xquat, xcom, rot_axes, trans_axes, anchors)


def com_jacobians(model: PhysicsModel, kin: Kin
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense COM Jacobians J_lin, J_ang of shape (B, nbody, 3, nv)."""
    mask = model.ancestor_mask[:, :, None]  # (nbody, nv, 1)
    arm = kin.xcom[:, :, None, :] - kin.anchors[:, None, :, :]  # (B, nb, nv, 3)
    axes = kin.rot_axes[:, None].expand_as(arm)
    lin = torch.linalg.cross(axes, arm) + kin.trans_axes
    j_lin = (mask * lin).transpose(-1, -2)
    j_ang = (mask * axes).transpose(-1, -2)
    return j_lin, j_ang


def point_jacobian(model: PhysicsModel, kin: Kin, body: torch.Tensor,
                   point: torch.Tensor) -> torch.Tensor:
    """Jacobians (B, P, 3, nv) of world points ``point`` (B, P, 3) attached
    to bodies ``body`` (P,)."""
    mask = model.ancestor_mask[body][..., None]  # (P, nv, 1)
    arm = point[:, :, None, :] - kin.anchors[:, None, :, :]  # (B, P, nv, 3)
    axes = kin.rot_axes[:, None].expand_as(arm)
    lin = torch.linalg.cross(axes, arm) + kin.trans_axes
    return (mask * lin).transpose(-1, -2)


def geom_world_pos(model: PhysicsModel, kin: Kin) -> torch.Tensor:
    """World positions of all geoms (B, ngeom, 3)."""
    b = model.geom_body
    return kin.xpos[:, b] + quat.rotate(kin.xquat[:, b], model.geom_pos)


def mass_center(model: PhysicsModel, kin: Kin) -> torch.Tensor:
    """Whole-body COM (B, 3)."""
    m = model.body_mass
    return torch.sum(m[:, None] * kin.xcom, dim=1) / torch.sum(m)


def com_velocity(model: PhysicsModel, kin: Kin, qvel: torch.Tensor
                 ) -> torch.Tensor:
    """Whole-body COM velocity (B, 3) = Σmᵢ·(J_lin,i q̇)/M, the input of the
    DeepMimic reward's com term."""
    j_lin, _ = com_jacobians(model, kin)                # (B, nbody, 3, nv)
    v = torch.einsum("xbiv,xv->xbi", j_lin, qvel)       # (B, nbody, 3)
    m = model.body_mass
    return torch.sum(m[:, None] * v, dim=1) / torch.sum(m)
