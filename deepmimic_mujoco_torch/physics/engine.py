"""Simulation engine, batch-first (port of ``deepmimic_mujoco_tpu/physics/
engine.py``: ``mass_inverse``, ``integrate_pos``, ``forward``, the RK4
substeps, ``_make_substep`` and ``step``).

``step(model, qpos, qvel, ctrl)`` advances a batch of envs (B, ·) by one
control step.  RK4 as MuJoCo's ``mj_RungeKutta``; the root quaternion
integrates on the manifold by the exponential map of the body-local ω."""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from deepmimic_mujoco_torch.physics import collision, dynamics, kinematics, solver
from deepmimic_mujoco_torch.physics.model import PhysicsModel
from deepmimic_mujoco_torch.utils import quaternion as quat

_NS_ITERS_LO = 8   # first phase (bf16 matmul precision on the TPU; f32 here)
_NS_ITERS_HI = 2   # clean-up phase


class Forward(NamedTuple):
    qacc: torch.Tensor
    kin: kinematics.Kin
    contact_force: torch.Tensor  # (B, ncand*3 + nhinge)


def mass_inverse(m: torch.Tensor, lo_iters: int = _NS_ITERS_LO,
                 hi_iters: int = _NS_ITERS_HI) -> torch.Tensor:
    """Explicit M⁻¹ (B, nv, nv) by Jacobi-scaled Newton–Schulz iteration:
    with B = D^{-1/2} M D^{-1/2} and X₀ = I/‖B‖₁, X ← X(2I − BX).  Every
    product runs in full f32 (TF32 is off, see the package docstring), which
    the residual ‖M⁻¹M − I‖∞ < 1e-4 needs."""
    dinv = 1.0 / torch.sqrt(torch.diagonal(m, dim1=-2, dim2=-1))
    b = m * dinv[..., None, :] * dinv[..., :, None]
    norm1 = torch.amax(torch.sum(torch.abs(b), dim=-1), dim=-1)
    eye = torch.eye(m.shape[-1], dtype=m.dtype, device=m.device)
    x = eye / norm1[..., None, None]
    eye2 = 2.0 * eye
    for _ in range(lo_iters + hi_iters):
        x = torch.matmul(x, eye2 - torch.matmul(b, x))
    return x * dinv[..., None, :] * dinv[..., :, None]


def _mv(minv: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.einsum("xvw,xw->xv", minv, x)


def integrate_pos(model: PhysicsModel, qpos: torch.Tensor, qvel: torch.Tensor,
                  dt) -> torch.Tensor:
    """qpos ⊞ qvel·dt: linear for translations/hinges, exponential map for
    the root quaternion (body-local angular velocity)."""
    root_pos = qpos[:, 0:3] + dt * qvel[:, 0:3]
    root_quat = quat.integrate(qpos[:, 3:7], qvel[:, 3:6], dt)
    hinges = qpos[:, 7:] + dt * qvel[:, 6:]
    return torch.cat([root_pos, root_quat, hinges], dim=1)


def forward(model: PhysicsModel, qpos: torch.Tensor, qvel: torch.Tensor,
            ctrl: torch.Tensor, f_warm: torch.Tensor | None = None,
            solver_iterations: int | None = None) -> Forward:
    """Forward dynamics qacc(qpos, qvel, ctrl) with every quantity evaluated
    at (qpos, qvel) — the legacy ``stage_reuse='none'`` stage."""
    kin = kinematics.fk(model, qpos)
    minv = mass_inverse(dynamics.mass_matrix(model, kin))
    tau = (dynamics.actuator_force(model, ctrl)
           + dynamics.passive_force(model, qvel)
           - dynamics.bias_force(model, kin, qvel))
    qacc_smooth = _mv(minv, tau)
    system = solver.assemble_system(model, minv,
                                    collision.floor_contacts(model, kin),
                                    collision.joint_limits(model, qpos))
    sol = solver.solve_system(model, system, qacc_smooth, qvel, f_warm=f_warm,
                              iterations=solver_iterations)
    qacc = qacc_smooth + _mv(minv, sol.qfrc_constraint)
    return Forward(qacc=qacc, kin=kin, contact_force=sol.force)


def _nefc_full(model: PhysicsModel) -> int:
    return int(model.ncand) * 3 + int(model.nhinge)


CtrlFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _rk4_substep(model: PhysicsModel, qpos, qvel, ctrl_fn: CtrlFn, f_warm):
    """Classic RK4 with every stage a full :func:`forward`; with
    ``warm_iterations`` set each stage warm-starts from the previous stage's
    forces at that reduced budget."""
    dt = model.dt
    warm_n = int(model.warm_iterations)
    kv = ka = torch.zeros_like(qvel)
    acc_v = acc_a = torch.zeros_like(qvel)
    f_prev = f_warm
    for a_i, b_i in ((0.0, 1.0 / 6.0), (0.5, 2.0 / 6.0), (0.5, 2.0 / 6.0),
                     (1.0, 1.0 / 6.0)):
        qp_i = integrate_pos(model, qpos, kv, dt * a_i)
        qv_i = qvel + dt * a_i * ka
        out = forward(model, qp_i, qv_i, ctrl_fn(qp_i, qv_i),
                      f_warm=(f_prev if warm_n > 0 else None),
                      solver_iterations=(warm_n if warm_n > 0 else None))
        kv, ka = qv_i, out.qacc
        acc_v = acc_v + b_i * kv
        acc_a = acc_a + b_i * ka
        f_prev = out.contact_force
    return (integrate_pos(model, qpos, acc_v, dt), qvel + dt * acc_a, f_prev)


def _rk4_substep_frozen(model: PhysicsModel, qpos, qvel, ctrl_fn: CtrlFn,
                        f_warm):
    """RK4 substep with stage-frozen kinematics (``stage_reuse='kin'``): FK,
    M⁻¹, the contact/limit set and the dual matrix A are computed once at
    the substep entry — stage 1's evaluation point — and reused by stages
    2-4, which re-evaluate only the velocity-dependent terms and re-solve
    the dual warm-started from the previous stage at ``stage_iterations``;
    stage 1 solves at ``warm_iterations`` from ``f_warm``."""
    dt = model.dt
    kin = kinematics.fk(model, qpos)
    minv = mass_inverse(dynamics.mass_matrix(model, kin))
    system = solver.assemble_system(model, minv,
                                    collision.floor_contacts(model, kin),
                                    collision.joint_limits(model, qpos))
    jac = (*kinematics.com_jacobians(model, kin),
           dynamics.world_inertia(model, kin))

    warm_n = int(model.warm_iterations)
    it1 = warm_n if warm_n > 0 else None
    stage_n = int(model.stage_iterations)
    it_rest = stage_n if stage_n > 0 else it1

    def stage_forward(qp_i, qv_i, f_prev, iters):
        tau = (dynamics.actuator_force(model, ctrl_fn(qp_i, qv_i))
               + dynamics.passive_force(model, qv_i)
               - dynamics.bias_force(model, kin, qv_i, jac=jac))
        qacc_smooth = _mv(minv, tau)
        sol = solver.solve_system(model, system, qacc_smooth, qv_i,
                                  f_warm=(f_prev if warm_n > 0 else None),
                                  iterations=iters)
        return qacc_smooth + _mv(minv, sol.qfrc_constraint), sol.force

    # stage 1: exact evaluation at (qpos, qvel)
    ka, f = stage_forward(qpos, qvel, f_warm, it1)
    acc_v, acc_a = qvel / 6.0, ka / 6.0
    kv = qvel
    # stages 2-4: frozen kinematics, reduced budget, warm chain on the same A
    for a_i, b_i in ((0.5, 2.0 / 6.0), (0.5, 2.0 / 6.0), (1.0, 1.0 / 6.0)):
        qp_i = integrate_pos(model, qpos, kv, dt * a_i)
        qv_i = qvel + dt * a_i * ka
        ka, f = stage_forward(qp_i, qv_i, f, it_rest)
        kv = qv_i
        acc_v = acc_v + b_i * qv_i
        acc_a = acc_a + b_i * ka
    return integrate_pos(model, qpos, acc_v, dt), qvel + dt * acc_a, f


def _make_substep(model: PhysicsModel, ctrl_fn: CtrlFn):
    """Substep closure ``(qp, qv, f_warm) → (qp', qv', f_last)``."""
    if model.integrator != "rk4":
        raise NotImplementedError(
            f"integrator {model.integrator!r}: only rk4 is ported "
            "(ROADMAP.md, queue A, parity modes)")
    if model.stage_reuse == "kin":
        return lambda qp, qv, f: _rk4_substep_frozen(model, qp, qv, ctrl_fn, f)
    if model.stage_reuse != "none":
        raise ValueError(f"unknown stage_reuse {model.stage_reuse!r}")
    return lambda qp, qv, f: _rk4_substep(model, qp, qv, ctrl_fn, f)


def step(model: PhysicsModel, qpos: torch.Tensor, qvel: torch.Tensor,
         ctrl: torch.Tensor, n_substeps: int = 1):
    """Advance a batch of envs by ``n_substeps`` physics steps under constant
    ctrl (B, nu); returns (qpos, qvel)."""
    sub = _make_substep(model, lambda qp, qv: ctrl)
    f = qvel.new_zeros(qvel.shape[0], _nefc_full(model))
    for _ in range(n_substeps):
        qpos, qvel, f = sub(qpos, qvel, f)
    return qpos, qvel
