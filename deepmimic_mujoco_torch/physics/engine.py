"""Simulation engine, batch-first (port of ``deepmimic_mujoco_tpu/physics/
engine.py``: ``mass_inverse``, the Cholesky M⁻¹ path and its calibration,
``integrate_pos``, ``forward``, the RK4 and semi-implicit Euler substeps,
``_make_substep``, ``step``, ``step_euler``, ``step_rk4``, ``pd_torque`` and
``step_pd``).

``step(model, qpos, qvel, ctrl)`` advances a batch of envs (B, ·) by one
control step under motor controls; ``step_pd`` under a joint PD controller
re-evaluated at every integrator stage.  Integrators: ``rk4`` (MuJoCo's
``mj_RungeKutta``) and ``euler`` (semi-implicit, implicit joint damping as
MuJoCo's ``mj_Euler``); the root quaternion integrates on the manifold by
the exponential map of the body-local ω."""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, NamedTuple, Optional

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


def _chol_inv_mul(m: torch.Tensor) -> Callable[[torch.Tensor], torch.Tensor]:
    """x (B, nv, k) ↦ M⁻¹x by a batched Cholesky factor and triangular
    solves (``minv_mode="cholesky"``: slower than Newton–Schulz, robust for
    any SPD M).  ``cholesky_ex`` without its error check, so the device is
    never waited on; an env whose M is not positive definite gets NaN, as
    JAX's ``cho_factor`` gives."""
    chol, info = torch.linalg.cholesky_ex(m, check_errors=False)
    chol = torch.where((info == 0)[:, None, None], chol,
                       torch.full_like(chol, math.nan))
    return lambda x: torch.cholesky_solve(x, chol)


@contextlib.contextmanager
def _full_f32():
    """f32 matmuls without TF32 for the duration, whatever the caller set:
    the Newton–Schulz residual is an f32 figure."""
    prec = torch.get_float32_matmul_precision()
    cudnn = torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prec)
        torch.backends.cudnn.allow_tf32 = cudnn


def ns_inverse_residual(model: PhysicsModel, qpos: torch.Tensor
                        ) -> torch.Tensor:
    """‖M⁻¹M − I‖∞ (B,) of the Newton–Schulz inverse at configurations
    ``qpos`` (B, nq)."""
    kin = kinematics.fk(model, qpos)
    m = dynamics.mass_matrix(model, kin)
    with _full_f32():
        r = torch.matmul(mass_inverse(m), m)
    r = r - torch.eye(model.nv, dtype=m.dtype, device=m.device)
    return torch.amax(torch.abs(r), dim=(1, 2))


def calibrate_minv_mode(model: PhysicsModel, n_samples: int = 8,
                        tol: float = 1e-4, seed: int = 0) -> PhysicsModel:
    """The model with its M⁻¹ path chosen: 'ns' when the Newton–Schulz
    residual stays below ``tol`` at qpos0 and at ``n_samples`` − 1 random
    perturbations of it (0.3·N(0, 1) from a CPU generator seeded with
    ``seed``, the root quaternion renormalized), 'cholesky' otherwise.  Run
    once at model build (the MJCF importer does), never on the step path:
    it reads one number back from the device."""
    gen = torch.Generator().manual_seed(seed)
    qpos0 = model.qpos0.cpu()
    rows = [qpos0]
    for _ in range(1, n_samples):
        q = qpos0 + 0.3 * torch.randn(model.nq, generator=gen)
        rows.append(torch.cat([q[:3], quat.normalize(q[3:7]), q[7:]]))
    worst = float(ns_inverse_residual(
        model, torch.stack(rows).to(model.device)).max())
    return dataclasses.replace(model,
                               minv_mode="ns" if worst < tol else "cholesky")


def _inv_mul(model: PhysicsModel, m: torch.Tensor) -> solver.InvMul:
    """M⁻¹ of the model's ``minv_mode`` as x (B, nv, k) ↦ M⁻¹x: the explicit
    Newton–Schulz inverse, or Cholesky solves (:func:`_chol_inv_mul`)."""
    if model.minv_mode == "ns":
        minv = mass_inverse(m)
        return lambda x: torch.bmm(minv, x)
    if model.minv_mode == "cholesky":
        return _chol_inv_mul(m)
    raise ValueError(f"unknown minv_mode {model.minv_mode!r}")


def _mv(inv_mul: solver.InvMul, x: torch.Tensor) -> torch.Tensor:
    """M⁻¹x of a (B, nv) vector."""
    return inv_mul(x[:, :, None])[:, :, 0]


def integrate_pos(model: PhysicsModel, qpos: torch.Tensor, qvel: torch.Tensor,
                  dt) -> torch.Tensor:
    """qpos ⊞ qvel·dt: linear for translations/hinges, exponential map for
    the root quaternion (body-local angular velocity)."""
    root_pos = qpos[:, 0:3] + dt * qvel[:, 0:3]
    root_quat = quat.integrate(qpos[:, 3:7], qvel[:, 3:6], dt)
    hinges = qpos[:, 7:] + dt * qvel[:, 6:]
    return torch.cat([root_pos, root_quat, hinges], dim=1)


def _smooth_force(model: PhysicsModel, kin: kinematics.Kin, qvel, ctrl,
                  qfrc, jac=None) -> torch.Tensor:
    """actuator + passive − bias + qfrc_applied (B, nv), summed in the JAX
    engine's order.  ``ctrl`` None means zero controls: the PD path, whose
    zero motor force the JAX engine adds as exact zeros."""
    tau = dynamics.passive_force(model, qvel)
    if ctrl is not None:
        tau = dynamics.actuator_force(model, ctrl) + tau
    tau = tau - dynamics.bias_force(model, kin, qvel, jac=jac)
    if qfrc is not None:
        tau = tau + qfrc
    return tau


def forward(model: PhysicsModel, qpos: torch.Tensor, qvel: torch.Tensor,
            ctrl: Optional[torch.Tensor], extra_damping: float = 0.0,
            qfrc_applied: Optional[torch.Tensor] = None,
            f_warm: torch.Tensor | None = None,
            solver_iterations: int | None = None) -> Forward:
    """Forward dynamics qacc(qpos, qvel, ctrl) with every quantity evaluated
    at (qpos, qvel) — the ``stage_reuse='none'`` stage and Euler's step.
    ``extra_damping`` adds extra_damping·damping to the hinge diagonal of M
    before it is inverted (Euler's implicit joint damping, dt·damping).
    ``qfrc_applied`` (B, nv) adds a generalized force (MuJoCo's channel of
    that name; the PD controller's torque).  M⁻¹ is Newton–Schulz or, under
    ``minv_mode='cholesky'``, Cholesky solves (:func:`_chol_inv_mul`)."""
    kin = kinematics.fk(model, qpos)
    m = dynamics.mass_matrix(model, kin)
    if extra_damping:
        m = m + torch.diag(torch.cat([m.new_zeros(6),
                                      extra_damping * model.damping]))
    inv_mul = _inv_mul(model, m)
    qacc_smooth = _mv(inv_mul, _smooth_force(model, kin, qvel, ctrl,
                                             qfrc_applied))
    system = solver.assemble_system(model, inv_mul,
                                    collision.floor_contacts(model, kin),
                                    collision.joint_limits(model, qpos))
    sol = solver.solve_system(model, system, qacc_smooth, qvel, f_warm=f_warm,
                              iterations=solver_iterations)
    qacc = qacc_smooth + _mv(inv_mul, sol.qfrc_constraint)
    return Forward(qacc=qacc, kin=kin, contact_force=sol.force)


def _nefc_full(model: PhysicsModel) -> int:
    return int(model.ncand) * 3 + int(model.nhinge)


# (qpos, qvel) of an integrator stage → (ctrl or None, qfrc_applied or None)
CtrlFn = Callable[[torch.Tensor, torch.Tensor],
                  tuple[Optional[torch.Tensor], Optional[torch.Tensor]]]
# (qpos, qvel, extra_damping, f_prev) → Forward: one stage's dynamics
FwdFn = Callable[[torch.Tensor, torch.Tensor, float, Optional[torch.Tensor]],
                 Forward]


def _make_fwd(model: PhysicsModel, ctrl_fn: CtrlFn) -> FwdFn:
    """Stage dynamics: a full :func:`forward` under the controls of
    ``ctrl_fn``; with ``warm_iterations`` set every solve warm-starts from
    the carried forces at that reduced budget (the step's first from zeros)."""
    warm_n = int(model.warm_iterations)

    def fwd(qp, qv, extra_damping, f_prev):
        ctrl, qfrc = ctrl_fn(qp, qv)
        return forward(model, qp, qv, ctrl, extra_damping, qfrc_applied=qfrc,
                       f_warm=(f_prev if warm_n > 0 else None),
                       solver_iterations=(warm_n if warm_n > 0 else None))

    return fwd


def _euler_substep(model: PhysicsModel, qpos, qvel, fwd: FwdFn, f_warm):
    """Semi-implicit Euler with implicit joint damping (MuJoCo's
    ``mj_Euler``): one forward with dt·damping on M's hinge diagonal, the
    velocity first, then the position from the new velocity.  Returns
    (qpos, qvel, contact_force); the force warm-starts the next solve."""
    dt = model.dt
    f = fwd(qpos, qvel, dt, f_warm)
    qvel_new = qvel + dt * f.qacc
    return integrate_pos(model, qpos, qvel_new, dt), qvel_new, f.contact_force


def _rk4_substep(model: PhysicsModel, qpos, qvel, fwd: FwdFn, f_warm):
    """Classic RK4 with every stage a full forward; the constraint forces
    thread through the stages (each stage's warm start)."""
    dt = model.dt
    kv = ka = torch.zeros_like(qvel)
    acc_v = acc_a = torch.zeros_like(qvel)
    f_prev = f_warm
    for a_i, b_i in ((0.0, 1.0 / 6.0), (0.5, 2.0 / 6.0), (0.5, 2.0 / 6.0),
                     (1.0, 1.0 / 6.0)):
        qp_i = integrate_pos(model, qpos, kv, dt * a_i)
        qv_i = qvel + dt * a_i * ka
        out = fwd(qp_i, qv_i, 0.0, f_prev)
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
    inv_mul = _inv_mul(model, dynamics.mass_matrix(model, kin))
    system = solver.assemble_system(model, inv_mul,
                                    collision.floor_contacts(model, kin),
                                    collision.joint_limits(model, qpos))
    jac = (*kinematics.com_jacobians(model, kin),
           dynamics.world_inertia(model, kin))

    warm_n = int(model.warm_iterations)
    it1 = warm_n if warm_n > 0 else None
    stage_n = int(model.stage_iterations)
    it_rest = stage_n if stage_n > 0 else it1

    def stage_forward(qp_i, qv_i, f_prev, iters):
        ctrl, qfrc = ctrl_fn(qp_i, qv_i)
        tau = _smooth_force(model, kin, qv_i, ctrl, qfrc, jac=jac)
        qacc_smooth = _mv(inv_mul, tau)
        sol = solver.solve_system(model, system, qacc_smooth, qv_i,
                                  f_warm=(f_prev if warm_n > 0 else None),
                                  iterations=iters)
        return qacc_smooth + _mv(inv_mul, sol.qfrc_constraint), sol.force

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
    """Substep closure ``(qp, qv, f_warm) → (qp', qv', f_last)``, JAX's
    dispatch: the stage-frozen RK4 pipeline only for rk4 with
    ``stage_reuse='kin'`` and the Newton–Schulz M⁻¹ (under 'cholesky' a
    frozen substep falls back to four full stages); Euler ignores
    ``stage_reuse``."""
    if model.integrator not in ("rk4", "euler"):
        raise ValueError(f"unknown integrator {model.integrator!r}")
    if model.stage_reuse not in ("none", "kin"):
        raise ValueError(f"unknown stage_reuse {model.stage_reuse!r}")
    if (model.integrator == "rk4" and model.stage_reuse == "kin"
            and model.minv_mode == "ns"):
        return lambda qp, qv, f: _rk4_substep_frozen(model, qp, qv, ctrl_fn, f)
    fwd = _make_fwd(model, ctrl_fn)
    sub = _rk4_substep if model.integrator == "rk4" else _euler_substep
    return lambda qp, qv, f: sub(model, qp, qv, fwd, f)


def step(model: PhysicsModel, qpos: torch.Tensor, qvel: torch.Tensor,
         ctrl: torch.Tensor, n_substeps: int = 1):
    """Advance a batch of envs by ``n_substeps`` physics steps under constant
    ctrl (B, nu); returns (qpos, qvel)."""
    sub = _make_substep(model, lambda qp, qv: (ctrl, None))
    f = qvel.new_zeros(qvel.shape[0], _nefc_full(model))
    for _ in range(n_substeps):
        qpos, qvel, f = sub(qpos, qvel, f)
    return qpos, qvel


def step_euler(model: PhysicsModel, qpos: torch.Tensor, qvel: torch.Tensor,
               ctrl: torch.Tensor):
    """One semi-implicit Euler step of full forwards, whatever
    ``model.integrator`` says; returns (qpos, qvel)."""
    fwd = _make_fwd(model, lambda qp, qv: (ctrl, None))
    f0 = qvel.new_zeros(qvel.shape[0], _nefc_full(model))
    qp, qv, _ = _euler_substep(model, qpos, qvel, fwd, f0)
    return qp, qv


def step_rk4(model: PhysicsModel, qpos: torch.Tensor, qvel: torch.Tensor,
             ctrl: torch.Tensor):
    """One RK4 step of four full forwards (no stage reuse), whatever
    ``model.integrator`` says; returns (qpos, qvel)."""
    fwd = _make_fwd(model, lambda qp, qv: (ctrl, None))
    f0 = qvel.new_zeros(qvel.shape[0], _nefc_full(model))
    qp, qv, _ = _rk4_substep(model, qpos, qvel, fwd, f0)
    return qp, qv


def torque_limits(model: PhysicsModel) -> torch.Tensor:
    """Per-hinge PD torque limit (nhinge,): the motor gears scattered onto
    their hinges by a scatter-add into zeros, so a hinge without a motor
    clips to 0 (JAX ``engine.py:394-395``)."""
    lim = model.actuator_gear.new_zeros(model.nv - 6)
    return lim.index_add(0, model.actuator_hinge, model.actuator_gear)


def pd_torque(model: PhysicsModel, target: torch.Tensor, qpos: torch.Tensor,
              qvel: torch.Tensor, kp: torch.Tensor, kd: torch.Tensor
              ) -> torch.Tensor:
    """DeepMimic-style joint PD (B, nv): τ = kp·(target − q) − kd·q̇ on the
    hinge dofs, clamped to ± the motor gear (:func:`torque_limits`), zero
    on the root dofs.  The position error is wrapped to [−π, π): hinge
    dofs are 2π-periodic."""
    lim = torque_limits(model)
    err = target - qpos[:, 7:]
    # torch.remainder, not torch.fmod: jnp.mod's sign follows the divisor,
    # and fmod's the dividend, so they differ for negative errors
    err = torch.remainder(err + math.pi, 2.0 * math.pi) - math.pi
    tau = kp * err - kd * qvel[:, 6:]
    tau = torch.clamp(tau, -lim, lim)
    return torch.cat([tau.new_zeros(tau.shape[0], 6), tau], dim=1)


def step_pd(model: PhysicsModel, qpos: torch.Tensor, qvel: torch.Tensor,
            target: torch.Tensor, kp: torch.Tensor, kd: torch.Tensor,
            n_substeps: int = 1):
    """Advance under a PD controller tracking ``target`` joint angles; the
    torque is evaluated again at every RK4 stage from that stage's (q, q̇),
    stages 2-4 of a frozen substep included.  ``target`` (B, nhinge) is
    held for ``n_substeps`` substeps; (B, S, nhinge) is a per-substep
    schedule of S substeps (``n_substeps`` is then ignored, as in JAX).
    The constraint solve, its warm chain and its four solves per substep
    are those of :func:`step`.  Returns (qpos, qvel)."""
    if target.dim() == 3:
        schedule = target.unbind(1)
    else:
        schedule = (target,) * n_substeps
    f = qvel.new_zeros(qvel.shape[0], _nefc_full(model))
    for tgt in schedule:
        sub = _make_substep(model, lambda qp, qv, t=tgt: (
            None, pd_torque(model, t, qp, qv, kp, kd)))
        qpos, qvel, f = sub(qpos, qvel, f)
    return qpos, qvel
