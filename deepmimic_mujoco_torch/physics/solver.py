"""Soft-constraint contact/limit solver, batch-first (port of
``deepmimic_mujoco_tpu/physics/solver.py``: ``_impedance``, ``_kb``,
``_project_cone``, ``pgs_solve``, ``assemble_system``, ``solve_system``).

MuJoCo-style constraint model (solref = (timeconst, dampratio), solimp =
(dmin, dmax, width, mid, power)):

    aref_i = -B·(J qvel)_i - K·d(r_i)·pos_i,   B = 2/(dmax·tc),
    K = 1/(dmax²·tc²·dampratio²),   R_i = (1-d_i)/d_i · A_ii,
    minimize_f  ½ fᵀ(A+R)f + fᵀ(J qacc_smooth - aref)   s.t.  f ∈ cone

solved in the dual with APGD (``ops/apgd.py``: the CUDA kernel on the card,
the plain version on the CPU), or with ``solver_mode="pgs"`` by sequential
projected Gauss–Seidel sweeps in plain PyTorch (:func:`pgs_solve`)."""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from deepmimic_mujoco_torch.ops.apgd import apgd
from deepmimic_mujoco_torch.physics.collision import Contacts, Limits
from deepmimic_mujoco_torch.physics.model import PhysicsModel


def _impedance(model: PhysicsModel, pos: torch.Tensor) -> torch.Tensor:
    dmin, dmax, width, mid, power = model.solimp.unbind()
    x = torch.clamp(torch.abs(pos) / torch.clamp(width, min=1e-12), 0.0, 1.0)
    y_lo = (x / mid) ** power * mid
    y_hi = 1.0 - ((1.0 - x) / (1.0 - mid)) ** power * (1.0 - mid)
    y = torch.where(x < mid, y_lo, y_hi)
    return torch.clamp(dmin + y * (dmax - dmin), 1e-4, 1.0 - 1e-4)


def _kb(model: PhysicsModel) -> tuple[torch.Tensor, torch.Tensor]:
    tc, dr = model.solref.unbind()
    dmax = model.solimp[1]
    k = 1.0 / (dmax * dmax * tc * tc * dr * dr)
    b = 2.0 / (dmax * tc)
    return k, b


def _project_cone(f: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """Project (..., 3) [normal, t1, t2] onto the elliptic friction cone of
    friction ``mu`` (...)."""
    fn = f[..., 0]
    ft = f[..., 1:]
    t = torch.linalg.vector_norm(ft, dim=-1)
    inside = t <= mu * fn
    below = mu * t <= -fn  # the polar cone projects to zero
    fn_p = torch.clamp((fn + mu * t) / (1.0 + mu * mu), min=0.0)
    scale = torch.where(t > 1e-12, mu * fn_p / torch.clamp(t, min=1e-12),
                        torch.zeros_like(t))
    f_proj = torch.cat([fn_p[..., None], ft * scale[..., None]], dim=-1)
    f_keep = torch.cat([torch.clamp(fn, min=0.0)[..., None], ft], dim=-1)
    out = torch.where(inside[..., None], f_keep, f_proj)
    return torch.where(below[..., None], torch.zeros_like(out), out)


def pgs_solve(a: torch.Tensor, bvec: torch.Tensor, mu: torch.Tensor,
              nc: int, nl: int, n_sweeps: int,
              f0: torch.Tensor | None = None) -> torch.Tensor:
    """Projected Gauss–Seidel sweeps over the dual system, batched over the
    env axis: a (B, ne, ne), bvec (B, ne), mu (B, nc) → f (B, ne).  Each
    sweep visits the contact 3-blocks in row order, then the limit rows; a
    block's 3 rows update together by its residual over its (clamped)
    diagonal and project onto its own friction cone, a limit row clamps at
    f ≥ 0.  The structure of MuJoCo's PGS solver: the parity mode for A/B
    runs against host MuJoCo, sequential by nature — plain PyTorch, a few
    launches per block and sweep, not the APGD kernels' batched matvec."""
    B, ne = bvec.shape
    diag = torch.clamp(torch.diagonal(a, dim1=1, dim2=2), min=1e-8)
    f = a.new_zeros(B, ne) if f0 is None else f0.clone()
    for _ in range(n_sweeps):
        for i in range(nc):
            s = 3 * i
            r = torch.bmm(a[:, s:s + 3, :], f[:, :, None])[:, :, 0] \
                + bvec[:, s:s + 3]
            f[:, s:s + 3] = _project_cone(f[:, s:s + 3] - r / diag[:, s:s + 3],
                                          mu[:, i])
        for i in range(nl):
            s = 3 * nc + i
            r = torch.bmm(a[:, s:s + 1, :], f[:, :, None])[:, 0, 0] + bvec[:, s]
            f[:, s] = torch.clamp(f[:, s] - r / diag[:, s], min=0.0)
    return f


class EfcSolution(NamedTuple):
    qfrc_constraint: torch.Tensor  # (B, nv)
    force: torch.Tensor            # (B, ncand*3 + nhinge) full candidate layout


class ConstraintSystem(NamedTuple):
    """The velocity-independent half of the dual problem, which
    ``stage_reuse='kin'`` freezes across the RK4 stages of a substep."""

    j: torch.Tensor         # (B, ne, nv) selected constraint Jacobian (masked)
    a_solve: torch.Tensor   # (B, ne, ne) regularized dual matrix, solver dtype
    mu: torch.Tensor        # (B, nc) friction per selected contact
    d_rows: torch.Tensor    # (B, ne) impedance per row
    pos_rows: torch.Tensor  # (B, ne) constraint violation per row
    act_rows: torch.Tensor  # (B, ne) bool active mask
    c_rows: torch.Tensor    # (B, nc*3) full-layout row index per contact row
    lim_dof: torch.Tensor   # (B, nl) hinge index per selected limit row


def _caps(model: PhysicsModel) -> tuple[int, int, int, int]:
    """(nc, nl, nc_full, nl_full) — static selection sizes."""
    nc_full, nl_full = int(model.ncand), int(model.nhinge)
    return (min(model.max_contacts, nc_full), min(model.max_limits, nl_full),
            nc_full, nl_full)


def select_deepest(pos: torch.Tensor, k: int) -> torch.Tensor:
    """Indices (B, k) of the ``k`` deepest (most negative) entries of each
    row of ``pos`` (B, n), deepest first; equal depths in index order, as
    ``jax.lax.top_k(-pos, k)`` orders them.  A stable sort: the same sets
    on every device, also when equal depths straddle the cut
    (``torch.topk`` promises no order among ties, and its CPU and CUDA
    versions pick different ones)."""
    return torch.sort(pos, dim=1, stable=True).indices[:, :k]


# M⁻¹ applied to the columns of x (B, nv, k) (engine._inv_mul)
InvMul = Callable[[torch.Tensor], torch.Tensor]


def assemble_system(model: PhysicsModel, inv_mul: InvMul,
                    contacts: Contacts, limits: Limits) -> ConstraintSystem:
    """Top-k selection of the deepest ``max_contacts``/``max_limits``
    candidates and assembly of the dual matrix A = J M⁻¹ Jᵀ + R.
    ``inv_mul`` maps x (B, nv, k) to M⁻¹x."""
    B = contacts.pos.shape[0]
    nv = model.nv
    nc, nl, _, _ = _caps(model)

    c_sel = select_deepest(contacts.pos, nc)   # (B, nc)
    l_sel = select_deepest(limits.pos, nl)     # (B, nl)
    c_pos = contacts.pos.gather(1, c_sel)
    c_act = contacts.active.gather(1, c_sel)
    c_jac = contacts.jac.gather(
        1, c_sel[:, :, None, None].expand(B, nc, 3, nv))
    c_mu = contacts.mu[c_sel]
    l_pos = limits.pos.gather(1, l_sel)
    l_act = limits.active.gather(1, l_sel)
    l_sign = limits.sign.gather(1, l_sel)

    # constraint rows (static shape, masked); limit rows are ±e_{6+dof}
    j_c = torch.where(c_act[:, :, None, None], c_jac,
                      torch.zeros_like(c_jac)).reshape(B, nc * 3, nv)
    j_l = c_jac.new_zeros(B, nl, nv).scatter(2, 6 + l_sel[:, :, None],
                                            l_sign[:, :, None])
    j_l = torch.where(l_act[:, :, None], j_l, torch.zeros_like(j_l))
    j = torch.cat([j_c, j_l], dim=1)  # (B, ne, nv)

    zeros = torch.zeros_like(c_pos)
    pos_rows = torch.cat(
        [torch.stack([c_pos, zeros, zeros], dim=-1).reshape(B, -1), l_pos],
        dim=1)
    d_rows = torch.cat([_impedance(model, c_pos).repeat_interleave(3, dim=1),
                        _impedance(model, l_pos)], dim=1)
    act_rows = torch.cat([c_act.repeat_interleave(3, dim=1), l_act], dim=1)

    # dual matrix A = J M⁻¹ Jᵀ plus the impedance regularizer R on its diagonal
    a = torch.bmm(j, inv_mul(j.transpose(1, 2)))
    diag_a = torch.diagonal(a, dim1=1, dim2=2)
    r = (1.0 - d_rows) / d_rows * torch.clamp(diag_a, min=1e-8)
    r = torch.where(act_rows, r, torch.ones_like(r))
    a = a + torch.diag_embed(r)
    # bf16 storage halves the bytes the APGD solve reads (iterates stay
    # f32); PGS always solves in f32
    a_solve = (a.to(torch.bfloat16) if model.solver_mode != "pgs"
               and model.solver_dtype == "bf16" else a)

    c_rows = (c_sel[:, :, None] * 3
              + torch.arange(3, device=c_sel.device)).reshape(B, -1)
    return ConstraintSystem(j=j, a_solve=a_solve, mu=c_mu, d_rows=d_rows,
                            pos_rows=pos_rows, act_rows=act_rows,
                            c_rows=c_rows, lim_dof=l_sel)


def solve_system(model: PhysicsModel, system: ConstraintSystem,
                 qacc_smooth: torch.Tensor, qvel: torch.Tensor,
                 f_warm: torch.Tensor | None = None,
                 iterations: int | None = None) -> EfcSolution:
    """Reference accelerations + the dual solve (APGD, or PGS under
    ``solver_mode="pgs"``) on an assembled (maybe frozen) system; forces come back in the full candidate layout, so a
    warm start ``f_warm`` (B, ncand*3 + nhinge) carries across selections."""
    nc, nl, nc_full, nl_full = _caps(model)
    B = qvel.shape[0]
    ne = nc * 3 + nl

    k, b = _kb(model)
    vel = torch.einsum("xrv,xv->xr", system.j, qvel)
    aref = -b * vel - k * system.d_rows * system.pos_rows
    aref = torch.where(system.act_rows, aref, torch.zeros_like(aref))
    bvec = torch.einsum("xrv,xv->xr", system.j, qacc_smooth) - aref

    n_iters = int(model.iterations) if iterations is None else int(iterations)
    if f_warm is None:
        f0 = qvel.new_zeros(B, ne)
    else:
        f0 = torch.cat([f_warm.gather(1, system.c_rows),
                        f_warm.gather(1, nc_full * 3 + system.lim_dof)], dim=1)
        f0 = torch.where(system.act_rows, f0, torch.zeros_like(f0))

    if model.solver_mode == "pgs":
        f = pgs_solve(system.a_solve, bvec, system.mu, nc, nl, n_iters, f0)
    elif model.solver_mode == "apgd":
        f = apgd(system.a_solve, bvec, system.mu, f0, iterations=n_iters,
                 nc=nc, nl=nl, layout=model.apgd_layout)
    else:
        raise ValueError(f"unknown solver_mode {model.solver_mode!r}")
    f = torch.where(system.act_rows, f, torch.zeros_like(f))
    qfrc = torch.einsum("xrv,xr->xv", system.j, f)

    full = qvel.new_zeros(B, nc_full * 3 + nl_full)
    full = full.scatter(1, system.c_rows, f[:, :nc * 3])
    full = full.scatter(1, nc_full * 3 + system.lim_dof, f[:, nc * 3:])
    return EfcSolution(qfrc_constraint=qfrc, force=full)
