"""The port's physics-fidelity modes against the JAX reference on the CPU:
the three quaternion functions of slice 10, the PGS solver and its cone
projection, ``forward`` under the Cholesky M⁻¹, PGS and Euler's implicit
damping, ``step_euler``, ``step_rk4`` and ``engine.step`` of the euler
humanoid, ``ns_inverse_residual``, ``calibrate_minv_mode`` and the substep
dispatch.

Inputs are walk-clip frames (sunk 2 cm into the floor: active contacts)
and numpy noise from a seed, handed to both stacks.  The JAX side jits
three physics programs (the euler humanoid's ``engine.step``,
``step_euler`` and ``step_rk4``, each vmapped over 8 envs); ``forward``
runs eagerly, one env at a time.  Tolerances are stated per test."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepmimic_mujoco_tpu.physics import build_humanoid as jax_build
from deepmimic_mujoco_tpu.physics import engine as jeng
from deepmimic_mujoco_tpu.physics import solver as jsol
from deepmimic_mujoco_tpu.utils import quaternion as jquat
from deepmimic_mujoco_torch.mocap.loader import load_clip
from deepmimic_mujoco_torch.physics import (collision, dynamics, engine,
                                            kinematics, solver)
from deepmimic_mujoco_torch.physics.humanoid import build_humanoid
from deepmimic_mujoco_torch.utils import quaternion as quat

torch.set_num_threads(1)

FRAMES = [0, 5, 9, 14, 21, 26, 33, 37]   # 8 envs
T = torch.as_tensor


def _close(name, ref, out, rel):
    """|out − ref| ≤ rel · max(1, max|ref|)."""
    ref, out = np.asarray(ref, np.float64), np.asarray(out, np.float64)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(out - ref).max())
    assert err <= rel * scale, (name, err, rel * scale)


@pytest.fixture(scope="module")
def state():
    """(qpos, qvel, ctrl) of 8 envs: walk frames sunk 2 cm into the floor,
    a knee and an elbow pushed past their limits, torques 0.3·N(0, 1)."""
    clip = load_clip("walk")
    qp = np.asarray(clip.qpos_cont[FRAMES], np.float32).copy()
    qv = np.asarray(clip.qvel_fd[FRAMES], np.float32)
    qp[:, 2] -= 0.02
    qp[1, 7 + 17] = 0.03    # right_knee, range (-2.7, 0)
    qp[2, 7 + 9] = -0.03    # right_elbow, range (0, 2.8)
    ctrl = (0.3 * np.random.RandomState(1).randn(len(FRAMES), 28)).astype(
        np.float32)
    return qp, qv, ctrl


# ---------------------------------------------------------------------------
# quaternions


def _branch_matrices(rng):
    """Rotation matrices whose largest Shepperd candidate is w, x, y and z
    in turn (half-turns about the axes, perturbed), and random ones."""
    out = [np.asarray(jquat.to_mat(jquat.normalize(rng.randn(8, 4))))]
    for axis in range(3):
        q = np.zeros((3, 4))
        q[:, 1 + axis] = 1.0
        q += 0.05 * rng.randn(3, 4)
        out.append(np.asarray(jquat.to_mat(jquat.normalize(q))))
    return np.concatenate(out).astype(np.float32)


def test_rotate_inv_from_mat_integrate_world_match_jax():
    """1e-6 absolute; ``from_mat`` on matrices that take each of its four
    candidates (w, x, y, z), w ≥ 0 and unit norm."""
    rng = np.random.RandomState(0)
    q = np.array(jquat.normalize(rng.randn(6, 4)), np.float32)
    v = rng.randn(6, 3).astype(np.float32)
    w = np.concatenate([rng.randn(5, 3), np.zeros((1, 3))]).astype(np.float32)
    np.testing.assert_allclose(quat.rotate_inv(T(q), T(v)).numpy(),
                               np.asarray(jquat.rotate_inv(q, v)), atol=1e-6)
    np.testing.assert_allclose(
        quat.integrate_world(T(q), T(w), 0.0166).numpy(),
        np.asarray(jquat.integrate_world(q, w, 0.0166)), atol=1e-6)
    m = _branch_matrices(rng)
    tr = np.trace(m, axis1=1, axis2=2)
    d = np.diagonal(m, axis1=1, axis2=2)
    branch = np.where(tr > 0, 0, np.where(
        (d[:, 0] > d[:, 1]) & (d[:, 0] > d[:, 2]), 1,
        np.where(d[:, 1] > d[:, 2], 2, 3)))
    assert set(branch.tolist()) == {0, 1, 2, 3}
    out = quat.from_mat(T(m)).numpy()
    np.testing.assert_allclose(out, np.asarray(jquat.from_mat(m)), atol=1e-6)
    assert (out[:, 0] >= 0).all()
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-6)


# ---------------------------------------------------------------------------
# the PGS solver


def test_project_cone_matches_jax():
    """Points inside the cone, in its polar cone and outside both, exactly
    on the axis (t = 0) and at μ of 0.5-1.2: 1e-6 absolute."""
    rng = np.random.RandomState(3)
    f = rng.randn(64, 3).astype(np.float32)
    f[:4, 1:] = 0.0
    mu = rng.uniform(0.5, 1.2, 64).astype(np.float32)
    out = solver._project_cone(T(f), T(mu)).numpy()
    np.testing.assert_allclose(out, np.asarray(jsol._project_cone(f, mu)),
                               atol=1e-6)
    t = np.linalg.norm(f[:, 1:], axis=1)
    kinds = {"inside": t <= mu * f[:, 0], "polar": mu * t <= -f[:, 0]}
    assert all(k.any() for k in kinds.values())
    assert (~kinds["inside"] & ~kinds["polar"]).any()


def _dual_systems(rng, B, nc, nl, nv=12):
    """A = J Jᵀ + R (R > 0 on the diagonal), b, μ and a warm start f0."""
    ne = 3 * nc + nl
    j = rng.randn(B, ne, nv)
    a = j @ j.transpose(0, 2, 1) + np.eye(ne) * rng.uniform(0.05, 0.5,
                                                            (B, ne, 1))
    b = 3.0 * rng.randn(B, ne)
    mu = rng.uniform(0.5, 1.2, (B, nc))
    f0 = np.abs(rng.randn(B, ne))
    return [x.astype(np.float32) for x in (a, b, mu, f0)]


@pytest.mark.parametrize("warm", [False, True])
def test_pgs_solve_matches_jax(warm):
    """6 seeded systems, 4 contacts and 3 limit rows, 30 sweeps, from zero
    and from a warm start: the forces within 1e-5 of max|f|; some contact
    blocks end on the cone's surface and some limit rows at 0."""
    nc, nl = 4, 3
    a, b, mu, f0 = _dual_systems(np.random.RandomState(5), 6, nc, nl)
    start = f0 if warm else None
    ref = np.asarray(jax.vmap(
        lambda a_, b_, m_, f_: jsol.pgs_solve(a_, b_, m_, nc, nl, 30, f_),
        in_axes=(0, 0, 0, 0 if warm else None))(a, b, mu, start))
    out = solver.pgs_solve(T(a), T(b), T(mu), nc, nl, 30,
                           T(f0) if warm else None).numpy()
    scale = float(np.abs(ref).max())
    assert float(np.abs(out - ref).max()) <= 1e-5 * scale
    fc = ref[:, :3 * nc].reshape(6, nc, 3)
    on_surface = np.abs(np.linalg.norm(fc[..., 1:], axis=-1)
                        - mu * fc[..., 0]) < 1e-4 * scale
    assert (on_surface & (fc[..., 0] > 1e-3)).any()
    assert (ref[:, 3 * nc:] == 0).any() and (ref[:, 3 * nc:] > 0).any()


def test_pgs_keeps_the_dual_matrix_in_f32():
    """The model's ``solver_dtype='bf16'`` stores A in bf16 for APGD only:
    under PGS ``assemble_system`` keeps it f32, as JAX's does."""
    tm = build_humanoid(device="cpu")
    qp = tm.qpos0[None].clone()
    qp[:, 2] -= 0.05
    kin = kinematics.fk(tm, qp)
    inv_mul = engine._inv_mul(tm, dynamics.mass_matrix(tm, kin))
    args = (inv_mul, collision.floor_contacts(tm, kin),
            collision.joint_limits(tm, qp))
    assert tm.solver_dtype == "bf16"
    assert solver.assemble_system(tm, *args).a_solve.dtype == torch.bfloat16
    pgs = dataclasses.replace(tm, solver_mode="pgs")
    assert solver.assemble_system(pgs, *args).a_solve.dtype == torch.float32


def test_pgs_within_two_percent_of_apgd_at_200_iterations():
    """Port of JAX's ``TestPGSSolverMode.test_pgs_converges_to_apgd_
    solution``: both solve the same strictly convex dual, so at 200
    iterations (f32 A) PGS's qacc is within 2% of APGD's, relative to
    max(1, max|qacc|), dropping onto the floor with several contacts."""
    tm = dataclasses.replace(build_humanoid(solver_dtype="f32", device="cpu"),
                             iterations=200)
    qp = tm.qpos0[None].clone()
    qp[:, 2] -= 0.12
    qv = torch.zeros(1, tm.nv)
    qv[:, 2] = -1.0
    ctrl = torch.zeros(1, tm.nu)
    f_a = engine.forward(tm, qp, qv, ctrl)
    f_p = engine.forward(dataclasses.replace(tm, solver_mode="pgs"), qp, qv,
                         ctrl)
    assert torch.isfinite(f_p.qacc).all()
    assert int((f_p.contact_force.abs() > 1e-3).sum()) >= 6
    denom = max(float(f_a.qacc.abs().max()), 1.0)
    assert float((f_a.qacc - f_p.qacc).abs().max()) / denom < 0.02


# ---------------------------------------------------------------------------
# forward under the parity modes, eager JAX one env at a time


@pytest.mark.parametrize("case", ["cholesky", "pgs", "extra_damping"])
def test_forward_in_parity_modes_matches_jax(case, state):
    """``forward`` of 4 envs with contacts and limit rows under the
    Cholesky M⁻¹, under PGS, and with Euler's extra damping dt·damping on
    M's diagonal: qacc within 1e-4 of max(1, |qacc|), the forces within
    1e-4 of max(1, max|f|) in the full candidate layout."""
    qp, qv, ctrl = (x[:4] for x in state)
    jm, tm = jax_build(), build_humanoid(device="cpu")
    kw = {"cholesky": dict(minv_mode="cholesky"),
          "pgs": dict(solver_mode="pgs"), "extra_damping": {}}[case]
    jm, tm = dataclasses.replace(jm, **kw), dataclasses.replace(tm, **kw)
    damp = tm.dt if case == "extra_damping" else 0.0
    ref = [jeng.forward(jm, qp[i], qv[i], ctrl[i], damp) for i in range(4)]
    out = engine.forward(tm, T(qp), T(qv), T(ctrl), damp)
    _close("qacc", np.stack([r.qacc for r in ref]), out.qacc.numpy(), 1e-4)
    f_ref = np.stack([r.contact_force for r in ref])
    assert (np.abs(f_ref) > 1e-3).sum() >= 8
    _close("contact_force", f_ref, out.contact_force.numpy(), 1e-4)
    if case == "extra_damping":  # the damping changes the result
        plain = engine.forward(tm, T(qp), T(qv), T(ctrl))
        assert float((plain.qacc - out.qacc).abs().max()) > 1e-2


def test_cholesky_of_a_matrix_that_is_not_positive_definite_gives_nan():
    """An env whose M is not SPD gets NaN from the Cholesky path (JAX's
    ``cho_factor`` does), the others their M⁻¹x; no error is raised."""
    m = torch.eye(3).repeat(2, 1, 1)
    m[1, 2, 2] = -1.0
    x = torch.ones(2, 3, 1)
    out = engine._chol_inv_mul(m)(x)
    assert torch.equal(out[0], x[0]) and torch.isnan(out[1]).all()
    ref = jax.scipy.linalg.cho_solve(jax.scipy.linalg.cho_factor(
        jnp.asarray(m[1].numpy())), jnp.ones(3))
    assert np.isnan(np.asarray(ref)).all()


# ---------------------------------------------------------------------------
# the integrators: two jitted JAX programs


def _trajectory(step_fn, qp, qv, ctrls):
    out = []
    for c in ctrls:
        qp, qv = step_fn(qp, qv, c)
        out.append((np.asarray(qp), np.asarray(qv)))
    return out


@pytest.fixture(scope="module")
def ctrls():
    return (0.3 * np.random.RandomState(2).randn(10, len(FRAMES), 28)
            ).astype(np.float32)


@pytest.mark.parametrize("kind", ["step_euler_model", "step_euler", "step_rk4"])
def test_integrators_match_jax_over_ten_steps(kind, state, ctrls):
    """10 steps of 8 envs from the contact-rich starts under random
    torques: qpos and qvel within 1e-4 of max(1, |x|) at every step.
    ``step_euler_model``: ``engine.step`` of ``build_humanoid(integrator=
    'euler')`` (one warm-budget solve per step, ``stage_reuse`` ignored);
    ``step_euler`` and ``step_rk4`` of the default model (frozen stages
    and the integrator field ignored: full forwards)."""
    qp, qv, _ = state
    if kind == "step_euler_model":
        jm = jax_build(integrator="euler")
        tm = build_humanoid(integrator="euler", device="cpu")
        jfn = jax.jit(jax.vmap(lambda q, v, c: jeng.step(jm, q, v, c)))
        tfn = lambda q, v, c: engine.step(tm, q, v, c)  # noqa: E731
    elif kind == "step_euler":
        jm, tm = jax_build(), build_humanoid(device="cpu")
        jfn = jax.jit(jax.vmap(lambda q, v, c: jeng.step_euler(jm, q, v, c)))
        tfn = lambda q, v, c: engine.step_euler(tm, q, v, c)  # noqa: E731
    else:
        jm, tm = jax_build(), build_humanoid(device="cpu")
        jfn = jax.jit(jax.vmap(lambda q, v, c: jeng.step_rk4(jm, q, v, c)))
        tfn = lambda q, v, c: engine.step_rk4(tm, q, v, c)  # noqa: E731
    ref = _trajectory(jfn, jnp.asarray(qp), jnp.asarray(qv), ctrls)
    out = _trajectory(tfn, T(qp), T(qv), [T(c) for c in ctrls])
    for k, ((jq, jv), (tq, tv)) in enumerate(zip(ref, out)):
        _close(f"qpos step {k}", jq, tq, 1e-4)
        _close(f"qvel step {k}", jv, tv, 1e-4)
    assert np.isfinite(out[-1][0]).all()


# ---------------------------------------------------------------------------
# the M⁻¹ calibration


def _ill_conditioned(jm, tm):
    """``tests/test_physics.py``'s model: one body 10⁶ times heavier and
    armature 10⁵ on four hinges, in both stacks."""
    bm = np.asarray(jm.body_mass).copy()
    bm[1] *= 1e6
    arma = np.asarray(jm.armature).copy()
    arma[:4] = 1e5
    return (dataclasses.replace(jm, body_mass=jnp.asarray(bm),
                                armature=jnp.asarray(arma)),
            dataclasses.replace(tm, body_mass=T(bm), armature=T(arma)))


def test_ns_inverse_residual_matches_jax(state):
    """‖M⁻¹M − I‖∞ of the Newton–Schulz inverse at the 8 states and at
    qpos0 of the ill-conditioned model.  The humanoid's residuals are
    ~1e-6: within 1e-6 absolute (the calibration's tolerance is 1e-4).  The
    ill-conditioned model's is ~1.5, f32 rounding amplified by κ(M) ~ 10⁶:
    within 1e-4 of it, both far over the calibration's tolerance."""
    qp = state[0]
    jm, tm = jax_build(), build_humanoid(device="cpu")
    ref = [float(jeng.ns_inverse_residual(jm, q)) for q in qp]
    out = engine.ns_inverse_residual(tm, T(qp)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)
    jb, tb = _ill_conditioned(jm, tm)
    ref_b = float(jeng.ns_inverse_residual(jb, jb.qpos0))
    out_b = float(engine.ns_inverse_residual(tb, tb.qpos0[None])[0])
    assert ref_b > 1e-2 and abs(out_b - ref_b) <= 1e-4 * ref_b, (out_b, ref_b)


@pytest.mark.parametrize("which", ["humanoid", "ill_conditioned"])
def test_calibrate_minv_mode_decides_as_jax(which):
    """The decision equals JAX's (the perturbations come from other RNGs):
    'ns' for the humanoid; for the ill-conditioned model the decision
    agrees with the residual at qpos0, as JAX's test asserts."""
    jm, tm = jax_build(), build_humanoid(device="cpu")
    if which == "ill_conditioned":
        jm, tm = _ill_conditioned(jm, tm)
    ref = jeng.calibrate_minv_mode(jm).minv_mode
    out = engine.calibrate_minv_mode(tm)
    assert out.minv_mode == ref
    if which == "humanoid":
        assert out.minv_mode == "ns"
    worst = float(engine.ns_inverse_residual(out, out.qpos0[None])[0])
    assert (worst < 1e-4) == (out.minv_mode == "ns"), worst


def test_calibration_runs_in_full_f32_and_restores_the_precision():
    """With TF32 (or bf16) matmuls allowed by the caller, the calibration
    still measures in full f32 and picks 'ns' for the humanoid; the
    caller's setting comes back."""
    tm = build_humanoid(device="cpu")
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("medium")
        assert engine.calibrate_minv_mode(tm).minv_mode == "ns"
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(prev)


# ---------------------------------------------------------------------------
# the substep dispatch


@pytest.mark.parametrize("integrator", ["rk4", "euler"])
@pytest.mark.parametrize("stage_reuse", ["none", "kin"])
@pytest.mark.parametrize("minv_mode", ["ns", "cholesky"])
def test_substep_dispatch_matches_jax(integrator, stage_reuse, minv_mode,
                                      monkeypatch):
    """``_make_substep`` picks the substep JAX's picks for every integrator,
    ``stage_reuse`` and ``minv_mode``: the frozen pipeline only for rk4 +
    'kin' + 'ns', Euler whatever ``stage_reuse`` says."""
    picked = {}
    for mod, tag in ((jeng, "jax"), (engine, "torch")):
        for name in ("_rk4_substep_frozen", "_rk4_substep", "_euler_substep"):
            monkeypatch.setattr(mod, name, lambda *a, _n=name, _t=tag:
                                picked.setdefault(_t, _n))
    kw = dict(integrator=integrator, stage_reuse=stage_reuse,
              minv_mode=minv_mode)
    jeng._make_substep(dataclasses.replace(jax_build(), **kw), None)(0, 0, 0)
    engine._make_substep(dataclasses.replace(build_humanoid(device="cpu"),
                                             **kw), None)(0, 0, 0)
    assert picked["torch"] == picked["jax"]
    frozen = (integrator, stage_reuse, minv_mode) == ("rk4", "kin", "ns")
    assert (picked["torch"] == "_rk4_substep_frozen") == frozen
