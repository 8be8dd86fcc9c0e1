"""Smooth dynamics, batch-first (port of ``deepmimic_mujoco_tpu/physics/
dynamics.py``): with per-body COM Jacobians J the mass matrix is
M = Σᵢ mᵢ Jlinᵢᵀ Jlinᵢ + Jangᵢᵀ Iᵢʷ Jangᵢ, and the bias force is the
J-projection of each body's velocity-product + gravity wrench.

Free-joint linear velocity is world-frame, angular velocity body-local."""

from __future__ import annotations

import torch

from deepmimic_mujoco_torch.physics.kinematics import Kin, com_jacobians
from deepmimic_mujoco_torch.physics.model import PhysicsModel
from deepmimic_mujoco_torch.utils import quaternion as quat


def world_inertia(model: PhysicsModel, kin: Kin) -> torch.Tensor:
    """Per-body inertia about COM in world axes, R I Rᵀ: (B, nbody, 3, 3)."""
    r = quat.to_mat(kin.xquat)
    return torch.einsum("xnab,nbc,xndc->xnad", r, model.body_inertia, r)


def mass_matrix(model: PhysicsModel, kin: Kin) -> torch.Tensor:
    """Joint-space mass matrix (B, nv, nv) incl. armature."""
    j_lin, j_ang = com_jacobians(model, kin)
    iw = world_inertia(model, kin)
    m = torch.einsum("n,xnav,xnaw->xvw", model.body_mass, j_lin, j_lin)
    m = m + torch.einsum("xnav,xnab,xnbw->xvw", j_ang, iw, j_ang)
    arma = torch.cat([model.armature.new_zeros(6), model.armature])
    return m + torch.diag(arma)


def body_velocities(model: PhysicsModel, kin: Kin, qvel: torch.Tensor):
    """Velocities and (q̈=0) bias accelerations down the tree: (omega,
    vel_com, domega_bias, acc_com_bias), each (B, nbody, 3), world frame."""
    root_r = quat.to_mat(kin.xquat[:, 0])
    omega = [torch.einsum("xij,xj->xi", root_r, qvel[:, 3:6])]
    zero = qvel.new_zeros(qvel.shape[0], 3)
    dom_b = [zero]
    v_o = [qvel[:, 0:3]]  # body-origin linear velocity
    a_ob = [zero]
    cross = torch.linalg.cross
    for i in range(1, model.nbody):
        p = model.parent[i]
        r = kin.xpos[:, i] - kin.xpos[:, p]
        v = v_o[p] + cross(omega[p], r)
        a = a_ob[p] + cross(dom_b[p], r) + cross(omega[p], cross(omega[p], r))
        w = omega[p]
        dw = dom_b[p]
        for j in model.body_hinges[i]:
            axis_w = kin.rot_axes[:, 6 + j]
            qd = qvel[:, 6 + j, None]
            dw = dw + cross(w, axis_w) * qd
            w = w + axis_w * qd
        omega.append(w)
        dom_b.append(dw)
        v_o.append(v)
        a_ob.append(a)

    omega = torch.stack(omega, dim=1)
    dom_b = torch.stack(dom_b, dim=1)
    v_o = torch.stack(v_o, dim=1)
    a_ob = torch.stack(a_ob, dim=1)
    rc = kin.xcom - kin.xpos
    v_com = v_o + cross(omega, rc)
    a_com_b = a_ob + cross(dom_b, rc) + cross(omega, cross(omega, rc))
    return omega, v_com, dom_b, a_com_b


def bias_force(model: PhysicsModel, kin: Kin, qvel: torch.Tensor,
               jac: tuple | None = None) -> torch.Tensor:
    """qfrc_bias (B, nv): Coriolis + centrifugal + gravity.

    ``jac``: optional precomputed ``(j_lin, j_ang, iw)``, which depend on
    ``kin`` only (the stage-frozen integrator computes them once)."""
    if jac is not None:
        j_lin, j_ang, iw = jac
    else:
        j_lin, j_ang = com_jacobians(model, kin)
        iw = world_inertia(model, kin)
    omega, _, dom_b, a_com_b = body_velocities(model, kin, qvel)
    f = model.body_mass[:, None] * (a_com_b - model.gravity)
    tau = torch.einsum("xnab,xnb->xna", iw, dom_b) + torch.linalg.cross(
        omega, torch.einsum("xnab,xnb->xna", iw, omega))
    return (torch.einsum("xnav,xna->xv", j_lin, f)
            + torch.einsum("xnav,xna->xv", j_ang, tau))


def passive_force(model: PhysicsModel, qvel: torch.Tensor) -> torch.Tensor:
    """qfrc_passive (B, nv): joint damping on the hinge dofs."""
    return torch.cat([qvel.new_zeros(qvel.shape[0], 6),
                      -model.damping * qvel[:, 6:]], dim=1)


def actuator_force(model: PhysicsModel, ctrl: torch.Tensor) -> torch.Tensor:
    """qfrc_actuator (B, nv): torque motors τ = gear · clip(ctrl, ctrlrange)."""
    c = torch.clamp(ctrl, model.ctrl_range[:, 0], model.ctrl_range[:, 1])
    out = ctrl.new_zeros(ctrl.shape[0], model.nv)
    return out.index_add(1, 6 + model.actuator_hinge, model.actuator_gear * c)
