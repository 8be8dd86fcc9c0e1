"""The imitation recipe of the port (quaternion helpers, gains, the
fall-contact list, ``com_velocity``, the PD path of the engine, the rewards
and the imitation configurations of ``DPEnvV3``) against the JAX reference
on the CPU, and the recipe's evaluation of the bundled ``walk_r2`` policy:

    DPEnvV3(clip="walk", reward_mode="imitation_dm",
            control_mode="pd_residual", n_substeps=2, max_episode_steps=300)

with the 68-D obs, fall-contact termination and the per-substep PD target
schedule.  Inputs are mocap frames and numpy draws from a seed, handed to
both stacks.  The JAX side jits two physics programs: ``engine.step_pd``
on a target schedule, and ``runner.evaluate`` of the recipe.  The env's
bookkeeping in every configuration (targets, cursor, obs, reward, done) is
held against JAX's with the physics replaced by the same cheap map in both
stacks.  Tolerances are stated per test."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepmimic_mujoco_tpu.algos.runner import evaluate as jax_evaluate
from deepmimic_mujoco_tpu.algos.trpo import TRPO as JaxTRPO
from deepmimic_mujoco_tpu.algos.trpo import TRPOConfig as JaxTRPOConfig
from deepmimic_mujoco_tpu.envs import DPEnvV3 as JaxDPEnvV3
from deepmimic_mujoco_tpu.envs import deepmimic_surface as jsurf
from deepmimic_mujoco_tpu.envs import dp_env_v3 as jenv_mod
from deepmimic_mujoco_tpu.envs import rewards as jrew
from deepmimic_mujoco_tpu.io_utils import checkpoint as jax_checkpoint
from deepmimic_mujoco_tpu.mocap import constants as jconst
from deepmimic_mujoco_tpu.models import MlpPolicy as JaxMlpPolicy
from deepmimic_mujoco_tpu.physics import build_humanoid as jax_build
from deepmimic_mujoco_tpu.physics import engine as jeng
from deepmimic_mujoco_tpu.physics import kinematics as jkin
from deepmimic_mujoco_tpu.utils import quaternion as jquat
from deepmimic_mujoco_torch.algos import runner
from deepmimic_mujoco_torch.algos.trpo import TRPO, Draws, TRPOConfig
from deepmimic_mujoco_torch.cli import eval_imitation, train_trpo
from deepmimic_mujoco_torch.envs import deepmimic_surface, rewards
from deepmimic_mujoco_torch.envs.dp_env_v3 import DPEnvV3, root_obs
from deepmimic_mujoco_torch.io_utils import checkpoint
from deepmimic_mujoco_torch.mocap import constants
from deepmimic_mujoco_torch.models.policy import MlpPolicy
from deepmimic_mujoco_torch.physics import collision, engine, kinematics
from deepmimic_mujoco_torch.physics.humanoid import build_humanoid
from deepmimic_mujoco_torch.utils import quaternion as quat

torch.set_num_threads(1)

CKPT_R2 = os.path.join(os.path.dirname(__file__), "..", "train_ckpt_walk_r2",
                       "DPEnvV3", "trpo-walk-0", "trpo_state.npz")
RECIPE = dict(clip="walk", reward_mode="imitation_dm",
              control_mode="pd_residual", n_substeps=2,
              max_episode_steps=300)
POLICY = dict(ob_dim=68, ac_dim=28, hidden_sizes=(1024, 512),
              activation="relu", fixed_logstd=-3.0)
RECIPE_FLAGS = ["--reward-mode", "imitation_dm", "--control-mode",
                "pd_residual", "--n-substeps", "2", "--max-episode-steps",
                "300", "--hidden-sizes", "1024,512", "--activation", "relu",
                "--fixed-logstd", "-3.0"]


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x,
                      np.float64)


def _close(name, ref, out, atol):
    ref, out = _np(ref), _np(out)
    assert ref.shape == out.shape, (name, ref.shape, out.shape)
    err = float(np.abs(out - ref).max())
    assert err <= atol, (name, err, atol)


@pytest.fixture(scope="module")
def models():
    return jax_build(), build_humanoid(device="cpu")


@pytest.fixture(scope="module")
def recipe_envs(models):
    jm, tm = models
    return JaxDPEnvV3(model=jm, **RECIPE), DPEnvV3(model=tm, **RECIPE)


@pytest.fixture(scope="module")
def perturbed(recipe_envs):
    """16 perturbed walk frames (qpos, qvel) and their reference frames."""
    _, tenv = recipe_envs
    rng = np.random.RandomState(0)
    idx = rng.randint(0, tenv.clip_len, 16)
    ref_qp = tenv.clip_qpos.numpy()[idx]
    ref_qv = tenv.clip_qvel.numpy()[idx]
    qp = ref_qp + rng.normal(0, 0.15, ref_qp.shape).astype(np.float32)
    q = qp[:, 3:7] * np.where(rng.rand(16, 1) < 0.5, -1, 1)
    qp[:, 3:7] = q / np.linalg.norm(q, axis=1, keepdims=True)
    qv = ref_qv + rng.normal(0, 0.8, ref_qv.shape).astype(np.float32)
    return (qp.astype(np.float32), qv.astype(np.float32),
            ref_qp.astype(np.float32), ref_qv.astype(np.float32))


# ---------------------------------------------------------------------------
# quaternion helpers, constants, the fall-contact list: 1e-6 / exact


def _quats(rng):
    rand = rng.normal(size=(64, 4)).astype(np.float32)
    near = np.concatenate([np.ones((5, 1)), rng.normal(size=(5, 3))
                           * np.array([1e-12, 1e-10, 1e-8, 1e-6, 1e-4])[:, None]],
                          axis=1).astype(np.float32)
    return np.concatenate([rand, near, -near])


def test_quaternion_helpers_match_jax():
    """conj, to_axis_angle (unnormalized input), angle_between (random
    pairs and pairs a small rotation apart), heading_inverse and
    quat_from_euler_rxyz on random and near-identity quaternions: 1e-6."""
    rng = np.random.RandomState(1)
    q = _quats(rng)
    q1 = q / np.linalg.norm(q, axis=1, keepdims=True)
    small = _quats(rng)[-10:]
    q2 = np.concatenate([np.roll(q1, 7, axis=0)[:64], np.asarray(
        jquat.mul(q1[-10:], jquat.normalize(small)))]).astype(np.float32)
    e = rng.uniform(-np.pi, np.pi, (64, 3)).astype(np.float32)
    _close("conj", jquat.conj(q), quat.conj(_t(q)), 0)
    j_axis, j_ang = jquat.to_axis_angle(q)
    t_axis, t_ang = quat.to_axis_angle(_t(q))
    _close("axis", j_axis, t_axis, 1e-6)
    _close("angle", j_ang, t_ang, 1e-6)
    _close("angle_between", jquat.angle_between(q1[:74], q2),
           quat.angle_between(_t(q1[:74]), _t(q2)), 1e-6)
    _close("heading_inverse", jquat.heading_inverse(q1),
           quat.heading_inverse(_t(q1)), 1e-6)
    _close("quat_from_euler_rxyz", jquat.quat_from_euler_rxyz(e),
           quat.quat_from_euler_rxyz(_t(e)), 1e-6)
    # the 1e-9 branch: no axis at the identity, a unit axis above it
    assert float(t_axis[64].abs().max()) == 0.0
    assert abs(float(t_axis[67].norm()) - 1.0) < 1e-6


def test_gains_weights_and_body_list_match_jax():
    assert constants.BODY_DEFS == jconst.BODY_DEFS
    assert constants.PARAMS_KP_KD == jconst.PARAMS_KP_KD
    assert constants.JOINT_WEIGHT == jconst.JOINT_WEIGHT
    for got, ref in zip(constants.kp_kd_vectors(), jconst.kp_kd_vectors()):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, np.asarray(ref, np.float32))


@pytest.mark.parametrize("clip", ["walk", "getup_facedown", "no_such_clip"])
def test_load_fall_contact_bodies_matches_jax(clip):
    """The arg file's list (walk), the disabled rule (getup_facedown: ()),
    and the default list for a clip without an arg file."""
    got = deepmimic_surface.load_fall_contact_bodies(clip)
    assert got == jsurf.load_fall_contact_bodies(clip)
    assert deepmimic_surface.DEFAULT_FALL_CONTACT_BODIES == \
        jsurf.DEFAULT_FALL_CONTACT_BODIES
    assert got == {"walk": jsurf.DEFAULT_FALL_CONTACT_BODIES,
                   "getup_facedown": (),
                   "no_such_clip": jsurf.DEFAULT_FALL_CONTACT_BODIES}[clip]


# ---------------------------------------------------------------------------
# kinematics and the PD path of the engine


def test_com_velocity_matches_jax(models, perturbed):
    """Σmᵢ·(J_lin,i q̇)/M of perturbed frames: 1e-5."""
    jm, tm = models
    qp, qv = perturbed[:2]
    ref = jax.vmap(lambda p, v: jkin.com_velocity(jm, jkin.fk(jm, p), v))(
        qp, qv)
    got = kinematics.com_velocity(tm, kinematics.fk(tm, _t(qp)), _t(qv))
    _close("com_velocity", ref, got, 1e-5)


def test_pd_torque_matches_jax(models, perturbed):
    """Random states with position errors beyond ±π and torques past the
    gear limits: |Δτ| ≤ 1e-6·max(1, |τ|) per element."""
    jm, tm = models
    qp, qv = perturbed[:2]
    rng = np.random.RandomState(2)
    qp = qp.copy()
    qp[:, 7:] += rng.uniform(-5, 5, qp[:, 7:].shape).astype(np.float32)
    qv = (qv * 10).astype(np.float32)
    target = rng.uniform(-4, 4, (16, 28)).astype(np.float32)
    kp, kd = constants.kp_kd_vectors()
    ref = np.asarray(jax.vmap(lambda t, p, v: jeng.pd_torque(
        jm, t, p, v, jnp.asarray(kp), jnp.asarray(kd)))(target, qp, qv))
    got = engine.pd_torque(tm, _t(target), _t(qp), _t(qv), _t(kp),
                           _t(kd)).numpy()
    assert np.all(np.abs(got - ref) <= 1e-6 * np.maximum(1.0, np.abs(ref)))
    err = target - qp[:, 7:]
    assert (np.abs(err) > np.pi).mean() > 0.2 and (err < -np.pi).any()
    lim = engine.torque_limits(tm).numpy()
    np.testing.assert_array_equal(lim, np.asarray(
        jnp.zeros(28).at[jm.actuator_hinge].add(jm.actuator_gear)))
    assert (np.abs(got[:, 6:]) == lim).mean() > 0.2   # clipped at the gear
    assert (np.abs(got[:, 6:]) < lim).mean() > 0.05
    np.testing.assert_array_equal(got[:, :6], 0.0)


@pytest.fixture(scope="module")
def pd_schedule(models, recipe_envs):
    """8 walk frames, each with a 2-substep target schedule (the next two
    clip frames plus noise), stepped by both engines."""
    jm, tm = models
    _, tenv = recipe_envs
    rng = np.random.RandomState(3)
    f = np.arange(0, 39, 5)
    cq = tenv.clip_qpos.numpy()
    qp, qv = cq[f], tenv.clip_qvel.numpy()[f]
    target = np.stack([cq[(f + 1) % 39, 7:], cq[(f + 2) % 39, 7:]], axis=1)
    target = (target + rng.normal(0, 0.05, target.shape)).astype(np.float32)
    kp, kd = constants.kp_kd_vectors()
    step = jax.jit(jax.vmap(lambda p, v, t: jeng.step_pd(
        jm, p, v, t, jnp.asarray(kp), jnp.asarray(kd))))
    ref = [np.asarray(x) for x in step(qp, qv, target)]
    got = engine.step_pd(tm, _t(qp), _t(qv), _t(target), _t(kp), _t(kd))
    return qp, qv, target, ref, got


def test_step_pd_schedule_matches_jax(models, pd_schedule):
    """One control step of 2 substeps on a per-substep target schedule,
    with floor contacts active: qpos within 1e-4, qvel within 1e-2 (the
    qvel bound as test_torch_physics' one-step budget)."""
    _, tm = models
    qp, _, _, (rq, rv), (gq, gv) = pd_schedule
    kin = kinematics.fk(tm, _t(qp))
    assert bool(collision.floor_contacts(tm, kin).active.any())
    _close("qpos", rq, gq, 1e-4)
    _close("qvel", rv, gv, 1e-2)


def test_step_pd_held_target_is_a_constant_schedule(models, pd_schedule):
    """A (B, 28) target held for n_substeps is the (B, n, 28) schedule of
    that target repeated, exactly; the schedule's rows are used in order."""
    _, tm = models
    qp, qv, target, _, _ = pd_schedule
    kp, kd = (_t(x) for x in constants.kp_kd_vectors())
    held = engine.step_pd(tm, _t(qp), _t(qv), _t(target[:, 0]), kp, kd,
                          n_substeps=2)
    rep = engine.step_pd(tm, _t(qp), _t(qv),
                         _t(np.repeat(target[:, :1], 2, axis=1)), kp, kd)
    for a, b in zip(held, rep):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    swapped = engine.step_pd(tm, _t(qp), _t(qv), _t(target[:, ::-1].copy()),
                             kp, kd)
    assert not torch.equal(swapped[0], engine.step_pd(
        tm, _t(qp), _t(qv), _t(target), kp, kd)[0])


# ---------------------------------------------------------------------------
# rewards: 1e-5


def _reward_inputs(models, recipe_envs, perturbed):
    jm, tm = models
    _, tenv = recipe_envs
    qp, qv, rqp, rqv = perturbed
    kin = kinematics.fk(tm, _t(qp))
    rkin = kinematics.fk(tm, _t(rqp))
    ee = tenv._ee_pos(kin).numpy()
    ree = tenv._ee_pos(rkin).numpy()
    com = kinematics.mass_center(tm, kin).numpy()
    rcom = kinematics.mass_center(tm, rkin).numpy()
    cv = kinematics.com_velocity(tm, kin, _t(qv)).numpy()
    rcv = kinematics.com_velocity(tm, rkin, _t(rqv)).numpy()
    return qp, qv, rqp, rqv, ee, ree, com, rcom, cv, rcv


@pytest.mark.parametrize("fn", [
    "config_l1_error", "weighted_pose_error", "velocity_l1_error",
    "root_l1_error", "end_effector_error", "com_error", "deepmimic_reward",
    "imitation_reward"])
def test_reward_functions_match_jax(fn, models, recipe_envs, perturbed):
    """Each error term and both rewards (every term of deepmimic_reward's
    return_terms; imitation_reward with and without the ee and com terms)
    on perturbed walk frames: 1e-5."""
    qp, qv, rqp, rqv, ee, ree, com, rcom, cv, rcv = _reward_inputs(
        models, recipe_envs, perturbed)
    args = {
        "config_l1_error": (qp[:, 7:], rqp[:, 7:]),
        "weighted_pose_error": (qp[:, 7:], rqp[:, 7:]),
        "velocity_l1_error": (qv, rqv),
        "root_l1_error": (qp[:, :3], rqp[:, :3]),
        "end_effector_error": (ee, ree),
        "com_error": (com, rcom),
        "imitation_reward": (qp[:, 7:], rqp[:, 7:], qv, rqv, qp[:, :3],
                             rqp[:, :3], ee, ree, com, rcom),
    }
    if fn == "deepmimic_reward":
        a = (qp, qv, rqp, rqv, ee, ree, cv, rcv)
        jr, jterms = jax.vmap(lambda *x: jrew.deepmimic_reward(
            *x, return_terms=True))(*a)
        tr, tterms = rewards.deepmimic_reward(*map(_t, a), return_terms=True)
        assert sorted(tterms) == sorted(jterms)
        for k in jterms:
            _close(k, jterms[k], tterms[k], 1e-5)
        _close(fn, jr, tr, 1e-5)
        assert 0.05 < float(tr.min()) and float(tr.max()) < 0.95
        return
    _close(fn, jax.vmap(getattr(jrew, fn))(*args[fn]),
           getattr(rewards, fn)(*map(_t, args[fn])), 1e-5)
    if fn == "imitation_reward":
        a = args[fn][:6]
        _close("imitation_reward without ee, com",
               jax.vmap(jrew.imitation_reward)(*a),
               rewards.imitation_reward(*map(_t, a)), 1e-5)


# ---------------------------------------------------------------------------
# the env: clip cursor, obs, bookkeeping in every configuration


@pytest.mark.parametrize("clip,n_substeps,last", [
    ("walk", 2, None), ("kick", 2, None), ("spinkick", 4, 1000)])
def test_clip_index_and_clip_over_match_jax(clip, n_substeps, last, models):
    """Every integer cursor from 0 to 3·T, and the half-step float cursors
    of the PD schedule, from several start frames (walk at 2 substeps
    loops, kick does not; spinkick at 4 substeps up to cursor 1000, where
    from frame 1 the cursor 978.5 rounds differently in f32 than in f64):
    equal frame indices, cycles and end flags."""
    jm, tm = models
    jenv = JaxDPEnvV3(clip=clip, model=jm, n_substeps=n_substeps)
    tenv = DPEnvV3(clip=clip, model=tm, n_substeps=n_substeps)
    T = tenv.clip_len
    assert tenv.cursor_scale == jenv.cursor_scale
    assert tenv.clip_wraps == (clip != "kick")
    cur = np.arange(0, (last or 3 * T) + 1)
    for init in (0, 1, T // 2, T - 1):
        ini = np.full_like(cur, init)
        for c_j, c_t in ((jnp.asarray(cur, jnp.int32), _t(cur)),
                         (jnp.asarray(cur, jnp.float32) + 0.5,
                          _t(cur).float() + 0.5)):
            j_idx, j_cyc = jenv._clip_index(c_j, jnp.asarray(ini, jnp.int32))
            t_idx, t_cyc = tenv._clip_index(c_t, _t(ini))
            np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
            np.testing.assert_array_equal(
                t_cyc.numpy(), np.broadcast_to(np.asarray(j_cyc), cur.shape))
            np.testing.assert_array_equal(
                tenv._clip_over(c_t, _t(ini)).numpy(),
                np.asarray(jenv._clip_over(c_j, jnp.asarray(ini, jnp.int32))))
    if clip == "walk":
        # positions in [T − 0.5, T) round to T: index 0 of the next cycle
        pos = tenv._clip_pos(_t(cur), _t(np.zeros_like(cur))).numpy()
        at = (pos >= T - 0.5) & (pos < T)
        assert at.any()
        idx, cyc = tenv._clip_index(_t(cur[at]), _t(np.zeros_like(cur[at])))
        assert (idx == 0).all() and (cyc == 1).all()


def test_recipe_env_matches_jax_at_reset(recipe_envs):
    """Sizes, gains, the fall-contact candidate mask, the clip's end
    effector / COM / COM-velocity tracks (1e-5) and the 68-D obs at reset
    (1e-6)."""
    jenv, tenv = recipe_envs
    assert tenv.observation_size == jenv.observation_size == 68
    assert (tenv.obs_mode, tenv.include_phase, tenv.termination,
            tenv.pd_target_interp) == ("full", True, "fall_contact", True)
    np.testing.assert_array_equal(tenv._fall_cand.numpy(),
                                  np.asarray(jenv._fall_cand))
    np.testing.assert_array_equal(tenv._kp.numpy(), np.asarray(jenv._kp))
    np.testing.assert_array_equal(tenv._kd.numpy(), np.asarray(jenv._kd))
    np.testing.assert_array_equal(tenv.cycle_offset.numpy(),
                                  np.asarray(jenv.cycle_offset))
    for f in ("clip_ee", "clip_com", "clip_com_vel"):
        _close(f, getattr(jenv, f), getattr(tenv, f), 1e-5)
    idx = np.array([0, 7, 19, 38])
    js = jax.vmap(jenv.reset_at)(jax.random.split(jax.random.PRNGKey(0), 4),
                                 jnp.asarray(idx))
    ts = tenv.reset_at(idx)
    _close("obs", js.obs, ts.obs, 1e-6)


def test_root_obs_matches_jax(perturbed):
    """Perturbed walk roots with w < 0 in half of them, and 64 uniformly
    random orientations (some with w < 0 once the heading is removed, which
    the second flip catches): 1e-6."""
    qp, qv = perturbed[:2]
    rng = np.random.RandomState(6)
    q = rng.normal(size=(64, 4))
    qp = np.concatenate([qp, np.repeat(qp[:1], 64, axis=0)])
    qp[16:, 3:7] = q / np.linalg.norm(q, axis=1, keepdims=True)
    qv = np.concatenate([qv, np.repeat(qv[:1], 64, axis=0)])
    qp, qv = qp.astype(np.float32), qv.astype(np.float32)
    got = root_obs(_t(qp), _t(qv))
    _close("root_obs", jax.vmap(jenv_mod.root_obs)(qp, qv), got, 1e-6)
    q = _t(qp[:, 3:7])
    q = torch.where(q[:, :1] < 0, -q, q)
    assert (quat.mul(quat.heading_inverse(q), q)[:, 0] < 0).any()


def _jfake(qp, qv, ac):
    t = ac.mean(0) if ac.ndim == 2 else ac
    return qp.at[7:].set(0.5 * qp[7:] + 0.5 * t).at[0].add(0.01), 0.9 * qv


def _tfake(qp, qv, ac):
    t = ac.mean(1) if ac.dim() == 3 else ac
    return (torch.cat([qp[:, :1] + 0.01, qp[:, 1:7], 0.5 * qp[:, 7:] + 0.5 * t],
                      dim=1), 0.9 * qv)


@pytest.mark.parametrize("kw", [
    dict(RECIPE),
    dict(reward_mode="imitation", control_mode="pd_residual", n_substeps=2,
         pd_target_interp=False),
    dict(reward_mode="mocap", control_mode="pd"),
    dict(clip="kick", reward_mode="imitation", control_mode="pd_residual",
         n_substeps=2, max_episode_steps=4),
    dict(reward_mode="imitation_dm", obs_mode="legacy", include_phase=False,
         termination="com", clip_velocities="reference"),
    dict(termination="fall_contact", obs_mode="full", control_mode="pd"),
], ids=["recipe", "imitation-held-target", "mocap-pd", "kick-imitation",
        "dm-legacy-com-reference", "alive-fall-full"])
def test_env_bookkeeping_matches_jax(kw, models):
    """5 steps of 6 envs that start near the clip's end (the cursor wraps or
    the motion ends), with the physics replaced by the same cheap map in
    both stacks: the PD targets it receives, the cursor, obs (1e-5),
    reward (1e-5) and done flags of every configuration."""
    jm, tm = models
    jenv, tenv = JaxDPEnvV3(model=jm, **kw), DPEnvV3(model=tm, **kw)
    assert tenv.observation_size == jenv.observation_size
    seen = []
    jenv._dynamics = _jfake
    tenv._dynamics = lambda qp, qv, ac: (seen.append(ac), _tfake(qp, qv, ac))[1]
    T = tenv.clip_len
    idx = np.array([T - 9, T - 4, T - 2, T - 1, 0, T // 3])
    js = jax.vmap(jenv.reset_at)(jax.random.split(jax.random.PRNGKey(0), 6),
                                 jnp.asarray(idx))
    ts = tenv.reset_at(idx)
    step = jax.vmap(jenv.step)
    rng = np.random.RandomState(4)
    for k in range(5):
        ac = rng.normal(0, 0.1, (6, 28)).astype(np.float32)
        js, ts = step(js, jnp.asarray(ac)), tenv.step(ts, _t(ac))
        np.testing.assert_array_equal(ts.mocap_idx.numpy(),
                                      np.asarray(js.mocap_idx), err_msg=k)
        np.testing.assert_array_equal(ts.done.numpy(), np.asarray(js.done),
                                      err_msg=k)
        _close("obs", js.obs, ts.obs, 1e-5)
        _close("reward", js.reward, ts.reward, 1e-5)
        _close("qpos", js.qpos, ts.qpos, 1e-6)
    if kw.get("control_mode") == "pd_residual":
        assert seen[0].dim() == (3 if kw.get("pd_target_interp", True)
                                 else 2)
    if kw.get("clip") == "kick":
        assert ts.done.any()


# ---------------------------------------------------------------------------
# the walk_r2 checkpoint and the slice


@pytest.fixture(scope="module")
def r2(recipe_envs):
    jenv, _ = recipe_envs
    jpol = JaxMlpPolicy(**POLICY)
    like = JaxTRPO(jenv, jpol, JaxTRPOConfig(num_envs=64)).init(
        jax.random.PRNGKey(0))
    jparams = jax_checkpoint.load(CKPT_R2, like).params   # strict
    tpol = MlpPolicy(**POLICY)
    return jpol, jparams, tpol, checkpoint.load_trpo_params(CKPT_R2, tpol,
                                                            "cpu")


def test_walk_r2_reader_matches_jax_strict_load(r2):
    """``load_trpo_params`` of the 68-D, relu 1024-512 ``walk_r2`` policy
    equals JAX's strict ``checkpoint.load`` of the same file: 0 error."""
    _, jp, _, tp = r2
    for head in ("pol", "vf"):
        assert len(tp[head]) == 3
        for jl, tl in zip(jp[head], tp[head]):
            for k in ("w", "b"):
                np.testing.assert_array_equal(tl[k].numpy(), np.asarray(jl[k]))
    assert tp["pol"][0]["w"].shape == (68, 1024)
    np.testing.assert_array_equal(tp["logstd"].numpy(), np.asarray(jp["logstd"]))
    for jx, tx in zip(jp["ob_rms"], tp["ob_rms"]):
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))


@pytest.fixture(scope="module")
def slice_run(recipe_envs, r2, tmp_path_factory):
    """JAX's ``runner.evaluate`` of walk_r2 on the recipe env, 4 RSI
    episodes x 10 steps, and the port's rollout from the same frames."""
    jenv, tenv = recipe_envs
    jpol, jp, tpol, tp = r2
    n, horizon = 4, 10
    key = jax.random.PRNGKey(5)
    path = str(tmp_path_factory.mktemp("eval") / "jax_eval.npz")
    jax_evaluate(jenv, jpol, jp, key, n_episodes=n, horizon=horizon,
                 save_path=path, reset_mode="rsi")
    with np.load(path, allow_pickle=True) as z:
        ref = {k: z[k] for k in z.files}
    frames = np.asarray(jax.vmap(jenv.reset)(
        jax.random.split(key, n + 1)[1:]).init_idx)
    out = runner.rollout(tenv, tpol, tp, tenv.reset_at(frames), horizon,
                         record=True)
    return ref, out


def test_recipe_evaluation_matches_jax(slice_run):
    """Equal episode lengths; per-step obs and deterministic actions within
    1e-3 (test_torch_eval's budget) and per-step rewards within 1e-4."""
    ref, out = slice_run
    np.testing.assert_array_equal(out.ep_len.numpy(), ref["lens"])
    obs, acs, rews = (t.swapaxes(0, 1).numpy() for t in out.traj)
    for e, n in enumerate(ref["lens"]):
        assert n > 0
        np.testing.assert_allclose(obs[e, :n], ref["obs"][e], atol=1e-3)
        np.testing.assert_allclose(acs[e, :n], ref["acs"][e], atol=1e-3)
        np.testing.assert_allclose(rews[e, :n], ref["rews"][e], atol=1e-4)
    np.testing.assert_allclose(out.ep_ret.numpy(), ref["ep_rets"], atol=1e-3)
    assert obs.shape[-1] == 68 and 0.5 < float(rews.mean()) < 1.0


# ---------------------------------------------------------------------------
# the recipe's entry points on the CPU


def test_cli_train_recipe_checkpoint_loads_in_jax_strictly(recipe_envs,
                                                           tmp_path):
    """``--task train`` with the README's flags at 2 envs x 8 steps: its
    checkpoint loads through the JAX package's strict ``checkpoint.load``
    into the same 1024-512 relu policy and reads back in the port."""
    jenv, _ = recipe_envs
    state = train_trpo.main([
        "--task", "train", "--device", "cpu", "--num-iters", "1",
        "--num-envs", "2", "--timesteps-per-batch", "8", "--reset-mode",
        "rsi", "--gamma", "0.95", "--lam", "0.95", *RECIPE_FLAGS,
        "--log-dir", str(tmp_path / "logs"),
        "--checkpoint-dir", str(tmp_path / "ckpt")])
    path = str(tmp_path / "ckpt" / "DPEnvV3" / "trpo-walk-0" /
               "trpo_state.npz")
    like = JaxTRPO(jenv, JaxMlpPolicy(**POLICY),
                   JaxTRPOConfig(num_envs=2)).init(jax.random.PRNGKey(0))
    js = jax_checkpoint.load(path, like)   # strict: raises on any drift
    np.testing.assert_array_equal(np.asarray(js.params["pol"][1]["w"]),
                                  state.params["pol"][1]["w"].numpy())
    assert np.asarray(js.env_state.obs).shape == (2, 68)
    np.testing.assert_array_equal(np.asarray(js.params["logstd"]), -3.0)
    back = checkpoint.load_trpo_params(path, MlpPolicy(**POLICY), "cpu")
    torch.testing.assert_close(back["vf"][2]["w"], state.params["vf"][2]["w"])


@pytest.mark.parametrize("task", ["evaluate", "sample"])
def test_cli_evaluate_and_sample_walk_r2(task, tmp_path):
    argv = ["--task", task, "--device", "cpu", "--eval-episodes", "2",
            "--eval-horizon", "3", "--load-model-path", CKPT_R2,
            *RECIPE_FLAGS]
    if task == "sample":
        argv += ["--sample-save-path", str(tmp_path / "s.npz")]
    res = train_trpo.main(argv)
    assert res.avg_len == 3 and 1.5 < res.avg_ret < 3.0
    assert res.rollout.state.obs.shape == (2, 68)
    if task == "sample":
        with np.load(tmp_path / "s.npz", allow_pickle=True) as z:
            assert z["obs"][0].shape == (3, 68)


def test_eval_imitation_tool_matches_the_runner(recipe_envs, r2):
    """The tracking tool's figures on fixed frames equal the runner's
    rollout of the same episodes."""
    _, tenv = recipe_envs
    _, _, tpol, tp = r2
    r = eval_imitation.main([
        "--ckpt", CKPT_R2, "--hidden-sizes", "1024,512", "--activation",
        "relu", "--horizon", "4", "--frames", "3,30", "--device", "cpu"])
    out = runner.rollout(tenv, tpol, tp, tenv.reset_at([3, 30]), 4)
    np.testing.assert_array_equal(r["ep_len"].numpy(), out.ep_len.numpy())
    torch.testing.assert_close(r["ep_ret"], out.ep_ret)
    assert r["len_median"] == 4 and 0 < r["pose_err"] < 1


def test_rsi_resets_in_the_rollout_carry_the_cursor(recipe_envs):
    """TRPO's rollout with RSI resets on the recipe env, episodes capped at
    2 steps: every reset env restarts at a fresh frame with mocap_idx =
    init_idx, step_count 0 and the obs of that frame, as JAX's rollout
    picks every field of the fresh state."""
    _, tenv = recipe_envs
    env = DPEnvV3(model=tenv.model, **dict(RECIPE, max_episode_steps=2))
    learner = TRPO(env, MlpPolicy(**POLICY),
                   TRPOConfig(horizon=4, num_envs=3, reset_mode="rsi"))
    g = torch.Generator().manual_seed(0)
    st = learner.init(g)
    seg, es, new, _, _ = learner._rollout(st.params, st.env_state, st.new,
                                          Draws(g), st.cur_ep_ret,
                                          st.cur_ep_len)
    assert bool(new.all()) and (seg["ep_lens"].sum(0) == 4).all()
    torch.testing.assert_close(es.mocap_idx, es.init_idx, rtol=0, atol=0)
    assert (es.step_count == 0).all()
    torch.testing.assert_close(es.obs, env.reset_at(es.init_idx).obs,
                               rtol=0, atol=0)


CKPT_MULTI_R4 = os.path.join(os.path.dirname(__file__), "..",
                             "train_ckpt_multiskill_r4", "DPEnvV3",
                             "trpo-walk+run+spinkick-0", "trpo_state.npz")


def test_cli_multi_clip_motion_trains_and_evaluates(tmp_path):
    """Multi-clip ``--motion a,b``: one training iteration of walk+run at
    2 envs x 8 steps on the coerced env (PD-residual control, 2 substeps,
    an imitation reward; warnings for the overridden torque control and
    substeps, and for ``--dynamics mujoco``, which the multi-clip env
    ignores as JAX's CLI does), whose checkpoint carries the clip ids and
    reads back; and the bundled multiskill_r4 policy (walk, run, spinkick;
    71-D obs) evaluated for 2 episodes x 5 steps."""
    with pytest.warns(UserWarning) as caught:
        state = train_trpo.main([
            "--task", "train", "--device", "cpu", "--motion", "walk,run",
            "--num-iters", "1", "--num-envs", "2", "--timesteps-per-batch",
            "8", "--g-step", "1", "--hidden-sizes", "16",
            "--dynamics", "mujoco",
            "--log-dir", str(tmp_path / "logs"),
            "--checkpoint-dir", str(tmp_path / "ckpt")])
    said = " ".join(str(w.message) for w in caught)
    assert "pd_residual" in said and "--dynamics mujoco ignored" in said
    assert state.env_state.obs.shape == (2, 2 + 1 + 11 + 56)
    assert set(state.env_state.clip_id.tolist()) <= {0, 1}
    path = str(tmp_path / "ckpt" / "DPEnvV3" / "trpo-walk+run-0" /
               "trpo_state.npz")
    with np.load(path) as z:
        assert bytes(z["__treedef__"]).decode() == \
            checkpoint.trpo_state_treedef(2, "array")
    res = train_trpo.main([
        "--task", "evaluate", "--device", "cpu", "--motion",
        "walk,run,spinkick", "--eval-episodes", "2", "--eval-horizon", "5",
        "--load-model-path", CKPT_MULTI_R4, *RECIPE_FLAGS])
    assert res.avg_len == 5 and 0.5 < res.avg_ret < 5.0
    assert res.rollout.state.obs.shape == (2, 71)
