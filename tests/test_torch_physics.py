"""The port's physics (``deepmimic_mujoco_torch/physics``) against the JAX
reference (``deepmimic_mujoco_tpu/physics``) on the CPU, at the default
``build_humanoid()`` configuration.

Inputs are mocap frames of the walk clip and numpy noise from a seed,
handed to both stacks.  The JAX side compiles two physics programs: one
holding FK, the mass matrix, the bias force, collision and one cold
``forward``; and one ``engine.step``.  Tolerances are stated per test."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepmimic_mujoco_tpu.mocap.loader import load_clip as jax_load_clip
from deepmimic_mujoco_tpu.physics import build_humanoid as jax_build
from deepmimic_mujoco_tpu.physics import collision as jcol
from deepmimic_mujoco_tpu.physics import dynamics as jdyn
from deepmimic_mujoco_tpu.physics import engine as jeng
from deepmimic_mujoco_tpu.physics import kinematics as jkin
from deepmimic_mujoco_tpu.utils import quaternion as jquat
from deepmimic_mujoco_torch.mocap.loader import load_clip
from deepmimic_mujoco_torch.physics import collision, dynamics, engine, kinematics
from deepmimic_mujoco_torch.physics.humanoid import build_humanoid
from deepmimic_mujoco_torch.utils import quaternion as quat

torch.set_num_threads(1)

FRAMES = [0, 9, 21, 33]


@pytest.fixture(scope="module")
def models():
    return jax_build(), build_humanoid(device="cpu")


@pytest.fixture(scope="module")
def frames():
    clip = load_clip("walk")
    return (np.asarray(clip.qpos_cont[FRAMES], np.float32),
            np.asarray(clip.qvel_fd[FRAMES], np.float32))


def _close(name, ref, out, rel):
    """|out − ref| ≤ rel · max(1, max|ref|): f32 sums in another order."""
    ref, out = np.asarray(ref, np.float64), np.asarray(out, np.float64)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(out - ref).max())
    assert err <= rel * scale, (name, err, rel * scale)


# ---------------------------------------------------------------------------
# numpy copies: exact


@pytest.mark.parametrize("name", ["walk", "spinkick"])
def test_mocap_loader_matches_jax_exactly(name):
    a, b = jax_load_clip(name), load_clip(name)
    assert (a.loop, a.dt, len(a)) == (b.loop, b.dt, len(b))
    for f in ("qpos", "qvel", "qpos_cont", "qvel_fd"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_model_matches_jax_field_by_field(models):
    jm, tm = models
    assert (tm.nq, tm.nv, tm.nu) == (35, 34, 28)
    for f in dataclasses.fields(jm):
        ref = getattr(jm, f.name)
        out = getattr(tm, f.name)
        if isinstance(out, torch.Tensor):
            np.testing.assert_array_equal(out.numpy(), np.asarray(ref),
                                          err_msg=f.name)
        else:
            assert out == ref, f.name
    assert (tm.max_contacts, tm.max_limits, tm.warm_iterations,
            tm.stage_iterations, tm.solver_dtype, tm.stage_reuse,
            tm.iterations, tm.dt) == (8, 8, 15, 8, "bf16", "kin", 50, 0.0166)


# ---------------------------------------------------------------------------
# quaternions: eager jnp, f32


def test_quaternion_functions_match_jax():
    rng = np.random.RandomState(0)
    q = rng.randn(6, 4).astype(np.float32)
    r = rng.randn(6, 4).astype(np.float32)
    v = rng.randn(6, 3).astype(np.float32)
    # angular velocities incl. exactly zero (the exp map's first-order branch)
    w = np.concatenate([rng.randn(5, 3), np.zeros((1, 3))]).astype(np.float32)
    qn = np.asarray(jquat.normalize(q))
    t = torch.tensor
    pairs = [
        (jquat.normalize(q), quat.normalize(t(q))),
        (jquat.mul(q, r), quat.mul(t(q), t(r))),
        (jquat.rotate(qn, v), quat.rotate(t(qn), t(v))),
        (jquat.to_mat(qn), quat.to_mat(t(qn))),
        (jquat.integrate(qn, w, 0.0166), quat.integrate(t(qn), t(w), 0.0166)),
    ]
    for ref, out in pairs:
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


# ---------------------------------------------------------------------------
# statics, collision and a cold forward: one JAX program


@pytest.fixture(scope="module")
def statics(models, frames):
    jm, tm = models
    qp, qv = frames
    # sink the frames 2 cm into the floor (15 active contacts over the 4
    # envs) and push a knee and an elbow past their limits
    qp = qp.copy()
    qp[:, 2] -= 0.02
    qp[1, 7 + 17] = 0.03    # right_knee, range (-2.7, 0)
    qp[2, 7 + 9] = -0.03    # right_elbow, range (0, 2.8)
    ctrl = (0.3 * np.random.RandomState(1).randn(len(FRAMES), 28)).astype(
        np.float32)

    def per_env(q, v, c):
        kin = jkin.fk(jm, q)
        return dict(
            xpos=kin.xpos, xquat=kin.xquat, xcom=kin.xcom,
            rot_axes=kin.rot_axes, anchors=kin.anchors,
            mass_matrix=jdyn.mass_matrix(jm, kin),
            bias=jdyn.bias_force(jm, kin, v),
            contacts=jcol.floor_contacts(jm, kin),
            limits=jcol.joint_limits(jm, q),
            com=jkin.mass_center(jm, kin),
            geom_pos=jkin.geom_world_pos(jm, kin),
            forward=jeng.forward(jm, q, v, c))

    ref = jax.jit(jax.vmap(per_env))(qp, qv, ctrl)
    return ref, (torch.as_tensor(qp), torch.as_tensor(qv),
                 torch.as_tensor(ctrl))


def test_fk_matches_jax(models, statics):
    _, tm = models
    ref, (qp, _, _) = statics
    kin = kinematics.fk(tm, qp)
    for name in ("xpos", "xquat", "xcom", "rot_axes", "anchors"):
        _close(name, ref[name], getattr(kin, name).numpy(), 1e-6)
    _close("com", ref["com"], kinematics.mass_center(tm, kin).numpy(), 1e-6)
    _close("geom_pos", ref["geom_pos"],
           kinematics.geom_world_pos(tm, kin).numpy(), 1e-6)


def test_mass_matrix_and_bias_match_jax(models, statics):
    _, tm = models
    ref, (qp, qv, _) = statics
    kin = kinematics.fk(tm, qp)
    _close("mass_matrix", ref["mass_matrix"],
           dynamics.mass_matrix(tm, kin).numpy(), 1e-6)
    _close("bias", ref["bias"], dynamics.bias_force(tm, kin, qv).numpy(), 1e-6)


def test_collision_matches_jax(models, statics):
    _, tm = models
    ref, (qp, _, _) = statics
    kin = kinematics.fk(tm, qp)
    c = collision.floor_contacts(tm, kin)
    lim = collision.joint_limits(tm, qp)
    _close("contact pos", ref["contacts"].pos, c.pos.numpy(), 1e-6)
    _close("contact jac", ref["contacts"].jac, c.jac.numpy(), 1e-6)
    np.testing.assert_array_equal(c.active.numpy(),
                                  np.asarray(ref["contacts"].active))
    assert int(c.active.sum()) >= 12 and int(lim.active.sum()) == 2
    _close("limit pos", ref["limits"].pos, lim.pos.numpy(), 1e-6)
    np.testing.assert_array_equal(lim.active.numpy(),
                                  np.asarray(ref["limits"].active))
    np.testing.assert_array_equal(lim.sign.numpy(),
                                  np.asarray(ref["limits"].sign))


def test_contact_forces_match_jax_in_full_candidate_layout(models, statics):
    """``engine.forward``'s constraint forces, compared in the full
    candidate layout (``EfcSolution.force``): top-k may order tied
    candidates differently, the full layout is selection-order-free.
    Tolerance 1e-4 of the largest force: 50 cold APGD iterations on the
    same bf16 A, sums in another order."""
    _, tm = models
    ref, (qp, qv, ctrl) = statics
    fwd = engine.forward(tm, qp, qv, ctrl)
    f_ref = np.asarray(ref["forward"].contact_force)
    assert (np.abs(f_ref) > 1e-3).sum() >= 12, "too few forces in the fixture"
    _close("contact_force", f_ref, fwd.contact_force.numpy(), 1e-4)
    _close("qacc", ref["forward"].qacc, fwd.qacc.numpy(), 1e-4)


def test_mass_inverse_residual(models):
    """``TestMassInverse``'s budget: ‖M⁻¹M − I‖∞ < 1e-4 at random reachable
    poses (hinges inside their ranges, random root orientation)."""
    _, tm = models
    rng = np.random.RandomState(0)
    lo, hi = tm.hinge_range[:, 0].numpy(), tm.hinge_range[:, 1].numpy()
    hinges = lo + (hi - lo) * rng.uniform(size=(8, tm.nhinge))
    qr = rng.randn(8, 4)
    qr /= np.linalg.norm(qr, axis=1, keepdims=True)
    qpos = np.concatenate([np.tile([0.0, 0.0, 1.0], (8, 1)), qr, hinges], 1)
    m = dynamics.mass_matrix(tm, kinematics.fk(
        tm, torch.as_tensor(qpos, dtype=torch.float32)))
    minv = engine.mass_inverse(m)
    resid = (minv @ m - torch.eye(tm.nv)).abs().max()
    assert float(resid) < 1e-4, float(resid)


# ---------------------------------------------------------------------------
# engine.step at the default config: one JAX program


@pytest.fixture(scope="module")
def trajectories(models, frames):
    jm, tm = models
    qp, qv = frames
    rng = np.random.RandomState(2)
    ctrls = (0.3 * rng.randn(20, len(FRAMES), 28)).astype(np.float32)
    step = jax.jit(jax.vmap(lambda q, v, c: jeng.step(jm, q, v, c)))
    jq, jv = jnp.asarray(qp), jnp.asarray(qv)
    tq, tv = torch.as_tensor(qp), torch.as_tensor(qv)
    out = []
    for c in ctrls:
        jq, jv = step(jq, jv, c)
        tq, tv = engine.step(tm, tq, tv, torch.as_tensor(c))
        out.append((np.asarray(jq), np.asarray(jv), tq.numpy(), tv.numpy()))
    return out


def test_one_step_matches_jax(trajectories):
    """Budgets of ``TestWarmIntegration.test_stage_frozen_stage1_exact``:
    qpos within 1e-4, qvel within 1e-3 after one step."""
    jq, jv, tq, tv = trajectories[0]
    assert np.abs(tq - jq).max() < 1e-4
    assert np.abs(tv - jv).max() < 1e-3


def test_twenty_step_trajectory_matches_jax(trajectories):
    """The tightest trajectory budget of ``TestWarmIntegration`` (qpos RMS
    < 5e-3), over 20 steps of random torques; the state stays finite."""
    jq = np.stack([t[0] for t in trajectories])
    tq = np.stack([t[2] for t in trajectories])
    assert np.isfinite(tq).all()
    rms = float(np.sqrt(np.mean((jq - tq) ** 2)))
    assert rms < 5e-3, rms


def test_stage_frozen_within_budget_of_exact_cold(models):
    """Port-only mirror of ``TestWarmIntegration.
    test_stage_frozen_within_budget``: the default (stage-frozen, warm,
    bf16) stays within 2e-2 qpos RMS of the exact-cold config
    (``stage_reuse='none'``, cold f32 solves) over 12 contact-rich tracking
    steps.  Exercises the port's ``forward`` and ``_rk4_substep``."""
    _, tm = models
    exact = dataclasses.replace(tm, warm_iterations=0, solver_dtype="f32",
                                stage_reuse="none", stage_iterations=0)
    clip = load_clip("walk")
    ref_q = torch.as_tensor(clip.qpos_cont, dtype=torch.float32)
    trajs = {}
    for name, model in (("exact", exact), ("frozen", tm)):
        q = ref_q[0:1]
        v = torch.as_tensor(clip.qvel_fd[0:1], dtype=torch.float32)
        out = []
        for t in range(12):
            ctrl = 0.8 * (ref_q[(t + 1) % len(clip), 7:] - q[:, 7:])
            q, v = engine.step(model, q, v, ctrl)
            out.append(q.numpy())
        trajs[name] = np.stack(out)
    rms = float(np.sqrt(np.mean((trajs["exact"] - trajs["frozen"]) ** 2)))
    assert rms < 2e-2, rms
