"""The port's multi-clip path (``mocap/registry``, ``mocap_hinge_range``,
``EnvState.clip_id``, ``envs/multi_clip.py:DPEnvV3Multi``, the
``rsi_pinned`` reset and the lane evaluation of the bundled ``imit5_r5b``
learners) against the JAX package on the CPU.

Inputs are the bundled clips and checkpoints and numpy draws from a seed,
handed to both stacks.  The env's bookkeeping in every configuration is
held with the physics replaced by the same cheap map in both stacks (the
port's ``_dynamics`` attribute; JAX's module-level ``engine``, patched in
the test).  The JAX side jits two physics programs: the lane tool's
evaluation of ``imit5_r5b``, and one env step with an f32 dual matrix.
Tolerances are stated per test."""

import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepmimic_mujoco_tpu.envs import multi_clip as jmulti
from deepmimic_mujoco_tpu.envs import rewards as jrew
from deepmimic_mujoco_tpu.mocap import registry as jregistry
from deepmimic_mujoco_tpu.models import MlpPolicy as JaxMlpPolicy
from deepmimic_mujoco_tpu.physics import build_humanoid as jax_build
from deepmimic_mujoco_tpu.physics.humanoid import (
    mocap_hinge_range as jax_hinge_range,
)
from deepmimic_mujoco_tpu.utils.running_stats import RunningMeanStd as JRms
from deepmimic_mujoco_torch.algos import lanes
from deepmimic_mujoco_torch.algos.trpo import TRPO, Draws, TRPOConfig
from deepmimic_mujoco_torch.envs.multi_clip import DPEnvV3Multi
from deepmimic_mujoco_torch.envs.types import EnvState
from deepmimic_mujoco_torch.io_utils import checkpoint
from deepmimic_mujoco_torch.mocap import registry
from deepmimic_mujoco_torch.models.policy import MlpPolicy
from deepmimic_mujoco_torch.physics.humanoid import (
    build_humanoid,
    mocap_hinge_range,
)

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
CKPT_IMIT5 = os.path.join(ROOT, "train_ckpt_imit5_r5b", "imit15_state.npz")
IMIT5_CLIPS = ["walk", "run", "spinkick", "backflip", "getup_facedown"]
IMIT_POLICY = dict(ob_dim=83, ac_dim=28, hidden_sizes=(1024, 512),
                   activation="relu", fixed_logstd=-3.0)
TOOL_ENV = dict(control_mode="pd_residual", n_substeps=2,
                max_episode_steps=300, reward_mode="imitation_dm",
                obs_mode="full", termination="fall_contact")


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _close(name, ref, out, atol):
    ref = np.asarray(ref, np.float64)
    out = np.asarray(out.numpy() if isinstance(out, torch.Tensor) else out,
                     np.float64)
    assert ref.shape == out.shape, (name, ref.shape, out.shape)
    err = float(np.abs(out - ref).max())
    assert err <= atol, (name, err, atol)


@pytest.fixture(scope="module")
def hinge_models():
    return jax_hinge_range(), mocap_hinge_range(device="cpu")


@pytest.fixture(scope="module")
def envs15(hinge_models):
    """The lane tool's env over all 15 clips (mocap joint limits), in both
    stacks."""
    jm, tm = hinge_models
    clips = tuple(registry.SKILLS)
    return (jmulti.DPEnvV3Multi(clips=clips, model=jm, **TOOL_ENV),
            DPEnvV3Multi(clips=clips, model=tm, **TOOL_ENV))


# ---------------------------------------------------------------------------
# registry, joint limits, clip tables: exact / 1e-5


def test_registry_and_mocap_hinge_range_match_jax(hinge_models):
    """``SKILLS`` and ``available_clips()`` (prefixed names, sorted) are
    JAX's; the widened hinge ranges equal JAX's exactly, never narrow the
    XML's, and widen some (spinkick and backflip leave the XML ranges)."""
    assert registry.SKILLS == jregistry.SKILLS
    assert registry.available_clips() == jregistry.available_clips()
    assert registry.available_clips()[0] == "humanoid3d_backflip"
    jm, tm = hinge_models
    np.testing.assert_array_equal(tm.hinge_range.numpy(),
                                  np.asarray(jm.hinge_range))
    xml = build_humanoid(device="cpu").hinge_range
    assert (tm.hinge_range[:, 0] <= xml[:, 0]).all()
    assert (tm.hinge_range[:, 1] >= xml[:, 1]).all()
    assert (tm.hinge_range != xml).any()
    assert tm.device == torch.device("cpu")
    two = mocap_hinge_range(build_humanoid(device="cpu"),
                            clips=["walk", "spinkick"], margin=0.2)
    np.testing.assert_array_equal(
        two.hinge_range.numpy(), np.asarray(jax_hinge_range(
            jax_build(), clips=["walk", "spinkick"], margin=0.2).hinge_range))


def test_clip_tables_of_all_15_clips_match_jax(envs15):
    """The padded pose and velocity tables, lengths, scales, wrap flags,
    cycle offsets, RSI weights and the (K, n_cand) fall-contact table are
    JAX's exactly; the end-effector, COM and COM-velocity tracks within
    1e-5."""
    jenv, tenv = envs15
    assert tenv.observation_size == jenv.observation_size == 83
    for f in ("clip_qpos", "clip_qvel", "clip_lens", "clip_wraps",
              "cycle_offset", "clip_scales", "clip_weights", "_fall_cand",
              "_kp", "_kd"):
        np.testing.assert_array_equal(getattr(tenv, f).numpy(),
                                      np.asarray(getattr(jenv, f)),
                                      err_msg=f)
    for f in ("clip_ee", "clip_com", "clip_com_vel"):
        _close(f, getattr(jenv, f), getattr(tenv, f), 1e-5)
    # getup's fall list is empty; some clips pad, some do not loop
    assert not tenv._fall_cand[registry.SKILLS.index("getup_facedown")].any()
    assert tenv._fall_cand.any(1).sum() >= 10
    assert not tenv.clip_wraps.all() and tenv.clip_wraps.any()


@pytest.mark.parametrize("n_substeps", [1, 2, 4])
def test_clip_cursor_of_every_clip_matches_jax(n_substeps, hinge_models):
    """``_clip_index`` (frame, cycles) and ``_clip_over`` of every clip,
    for every integer cursor from 0 to 3·T and the half-step float cursors,
    from the start frames 0, 1, T/2 and T − 1: bit-equal."""
    jm, tm = hinge_models
    clips = tuple(registry.SKILLS)
    jenv = jmulti.DPEnvV3Multi(clips=clips, model=jm, n_substeps=n_substeps,
                               termination="com")
    tenv = DPEnvV3Multi(clips=clips, model=tm, n_substeps=n_substeps,
                        termination="com")
    np.testing.assert_array_equal(tenv.clip_scales.numpy(),
                                  np.asarray(jenv.clip_scales))
    cid, cur, ini = [], [], []
    for k in range(len(clips)):
        T = int(tenv.clip_lens[k])
        c = np.arange(0, 3 * T + 1)
        for init in (0, 1, T // 2, T - 1):
            cid.append(np.full_like(c, k))
            cur.append(c)
            ini.append(np.full_like(c, init))
    cid, cur, ini = map(np.concatenate, (cid, cur, ini))
    for c_j, c_t in ((jnp.asarray(cur, jnp.int32), _t(cur)),
                     (jnp.asarray(cur, jnp.float32) + 0.5,
                      _t(cur).float() + 0.5)):
        j_idx, j_cyc = jenv._clip_index(jnp.asarray(cid), c_j,
                                        jnp.asarray(ini, jnp.int32))
        t_idx, t_cyc = tenv._clip_index(_t(cid), c_t, _t(ini))
        np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
        np.testing.assert_array_equal(t_cyc.numpy(), np.asarray(j_cyc))
        np.testing.assert_array_equal(
            tenv._clip_over(_t(cid), c_t, _t(ini)).numpy(),
            np.asarray(jenv._clip_over(jnp.asarray(cid), c_j,
                                       jnp.asarray(ini, jnp.int32))))


# ---------------------------------------------------------------------------
# the env's bookkeeping, physics swapped for a cheap map: exact / 1e-5


def _jfake(qp, qv, ac):
    t = ac.mean(0) if ac.ndim == 2 else ac
    return qp.at[7:].set(0.5 * qp[7:] + 0.5 * t).at[0].add(0.01), 0.9 * qv


def _tfake(qp, qv, ac):
    t = ac.mean(1) if ac.dim() == 3 else ac
    return (torch.cat([qp[:, :1] + 0.01, qp[:, 1:7], 0.5 * qp[:, 7:] + 0.5 * t],
                      dim=1), 0.9 * qv)


BOOKKEEPING_CLIPS = ("walk", "kick", "getup_facedown", "spinkick")


@pytest.mark.parametrize("kw", [
    dict(TOOL_ENV),
    dict(reward_mode="imitation", control_mode="pd_residual", n_substeps=2,
         pd_target_interp=False, max_episode_steps=4),
    dict(reward_mode="imitation_dm", control_mode="pd", termination="com",
         n_substeps=1),
    dict(reward_mode="imitation", obs_mode="legacy", n_substeps=4,
         clip_velocities="reference", termination="com"),
], ids=["tool-recipe", "imitation-held-target", "dm-pd-com",
        "imitation-legacy-reference-4substeps"])
def test_env_bookkeeping_matches_jax(kw, hinge_models, monkeypatch):
    """5 steps of 8 envs on 4 clips (walk and spinkick loop, kick and
    getup do not), started near each clip's end and at its middle, with the
    same cheap map in place of the physics in both stacks (it moves the
    joints halfway to the mean PD target, so qpos carries the targets):
    cursor, done flags and clip ids (equal), qpos (1e-6), obs and reward
    (1e-5)."""
    jm, tm = hinge_models
    jenv = jmulti.DPEnvV3Multi(clips=BOOKKEEPING_CLIPS, model=jm, **kw)
    tenv = DPEnvV3Multi(clips=BOOKKEEPING_CLIPS, model=tm, **kw)
    assert tenv.observation_size == jenv.observation_size
    t_seen = []
    monkeypatch.setattr(jmulti, "engine", types.SimpleNamespace(
        step_pd=lambda model, qp, qv, target, kp, kd, n_substeps=1:
        _jfake(qp, qv, target)))
    tenv._dynamics = lambda qp, qv, ac: (t_seen.append(ac),
                                         _tfake(qp, qv, ac))[1]
    lens = tenv.clip_lens.numpy()
    cid = np.array([0, 1, 2, 3, 0, 1, 2, 3])
    idx = np.where(np.arange(8) < 4, lens[cid] - 2, lens[cid] // 2)
    js = jax.vmap(jenv.reset_at)(jax.random.split(jax.random.PRNGKey(0), 8),
                                 jnp.asarray(cid), jnp.asarray(idx))
    ts = tenv.reset_at(cid, idx)
    _close("obs at reset", js.obs, ts.obs, 1e-6)
    step = jax.jit(jax.vmap(jenv.step))   # no physics: the cheap map
    rng = np.random.RandomState(4)
    for k in range(5):
        ac = rng.normal(0, 0.1, (8, 28)).astype(np.float32)
        js, ts = step(js, jnp.asarray(ac)), tenv.step(ts, _t(ac))
        for f in ("mocap_idx", "done", "clip_id", "step_count"):
            np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                          np.asarray(getattr(js, f)),
                                          err_msg=f"{f} step {k}")
        _close("qpos", js.qpos, ts.qpos, 1e-6)
        _close("obs", js.obs, ts.obs, 1e-5)
        _close("reward", js.reward, ts.reward, 1e-5)
    interp = (kw.get("control_mode", "pd_residual") == "pd_residual"
              and kw["n_substeps"] > 1 and kw.get("pd_target_interp", True))
    assert t_seen[0].dim() == (3 if interp else 2)
    assert ts.done.any()  # a clip ran out or the cap was reached


def test_rsi_pinned_resets_keep_each_envs_clip(hinge_models):
    """TRPO's rollout with ``rsi_pinned`` on a multi-clip env, episodes
    capped at 2 steps: every env restarts on the clip it ran, at a fresh
    frame with cursor = start frame and the obs of that frame; "rsi" and
    "noise" (this env has no noise reset: its RSI) redraw the clip."""
    _, tm = hinge_models
    env = DPEnvV3Multi(clips=("walk", "run", "kick"), model=tm,
                       max_episode_steps=2)
    cfg = TRPOConfig(horizon=4, num_envs=12, reset_mode="rsi_pinned")
    learner = TRPO(env, MlpPolicy(ob_dim=env.observation_size, ac_dim=28,
                                  hidden_sizes=(16,)), cfg)
    g = torch.Generator().manual_seed(0)
    st = learner.init(g)
    seg, es, new, _, _ = learner._rollout(st.params, st.env_state, st.new,
                                          Draws(g), st.cur_ep_ret,
                                          st.cur_ep_len)
    assert bool(new.all())
    torch.testing.assert_close(es.clip_id, st.env_state.clip_id, rtol=0,
                               atol=0)
    torch.testing.assert_close(es.mocap_idx, es.init_idx, rtol=0, atol=0)
    torch.testing.assert_close(es.obs, env.reset_at(es.clip_id,
                                                    es.init_idx).obs,
                               rtol=0, atol=0)
    for mode in ("rsi", "noise"):
        fresh = TRPO(env, learner.policy, cfg._replace(reset_mode=mode))
        assert fresh._reset_fn == env.reset
    ends = env.reset_keep_clip(torch.Generator().manual_seed(1), es)
    assert torch.equal(ends.clip_id, es.clip_id)
    assert (ends.init_idx < env.clip_lens[es.clip_id]).all()


def test_env_state_where_carries_a_missing_clip_id():
    """``EnvState.where`` keeps ``clip_id`` None for single-clip states and
    picks it per env for multi-clip ones."""
    z = torch.zeros(3)
    base = dict(qpos=torch.zeros(3, 2), qvel=z, obs=z, reward=z,
                done=torch.zeros(3, dtype=torch.bool), mocap_idx=z,
                init_idx=z, step_count=z)
    a, b = EnvState(**base), EnvState(**{**base, "qpos": torch.ones(3, 2)})
    keep = torch.tensor([True, False, True])
    assert a.where(keep, b).clip_id is None
    m = EnvState(**base, clip_id=torch.tensor([4, 5, 6])).where(
        keep, EnvState(**base, clip_id=torch.tensor([7, 8, 9])))
    assert m.clip_id.tolist() == [4, 8, 6]


# ---------------------------------------------------------------------------
# the lane tool's evaluation of imit5_r5b with the real physics


def _jax_lane_params(path):
    """The lane file's params as a lane-stacked JAX pytree."""
    with np.load(path) as z:
        leaf = [z[f"leaf_{i}"] for i in range(16)]

    def layers(flat):
        return [{"b": jnp.asarray(flat[2 * k]), "w": jnp.asarray(flat[2 * k + 1])}
                for k in range(3)]

    return {"logstd": jnp.asarray(leaf[0]),
            "ob_rms": JRms(*(jnp.asarray(x) for x in leaf[1:4])),
            "pol": layers(leaf[4:10]), "vf": layers(leaf[10:16])}


@pytest.fixture(scope="module")
def lane_eval(envs15):
    """The JAX tool's ``eval_lane`` (``tools/imitation15_vmapped.py``),
    vmapped over the 5 lanes of imit5_r5b, 2 episodes x 10 steps each, with
    the per-step obs and rewards as extra outputs; and the port's
    ``lanes.evaluate`` from the frames those keys draw."""
    jenv, tenv = envs15
    B, H = 2, 10
    jpol = JaxMlpPolicy(**IMIT_POLICY)
    lane_ids = np.asarray([registry.SKILLS.index(c) for c in IMIT5_CLIPS])

    def frames_of(lane_id, key):
        ekeys = jax.random.split(key, B)
        idxs = jax.vmap(lambda kk: jax.random.randint(kk, (), 0, 1 << 30))(
            ekeys)
        return ekeys, idxs % jenv.clip_lens[lane_id]

    def eval_lane(lane_params, lane_id, key):
        ekeys, idxs = frames_of(lane_id, key)
        s = jax.vmap(lambda kk, i: jenv.reset_at(kk, lane_id, i))(ekeys, idxs)

        def step_fn(carry, _):
            s, alive, ep_len, rew_sum = carry
            mean, _ = jpol.mean_logstd(lane_params, s.obs)
            nxt = jax.vmap(jenv.step)(s, mean)
            idx = jax.vmap(lambda st: jenv._clip_index(
                st.clip_id, st.mocap_idx, st.init_idx)[0])(nxt)
            ref = jenv.clip_qpos[nxt.clip_id, idx]
            perr = jax.vmap(jrew.weighted_pose_error)(nxt.qpos[:, 7:],
                                                      ref[:, 7:])
            ep_len = ep_len + jnp.where(alive, 1, 0)
            rew_sum = rew_sum + jnp.where(alive, nxt.reward, 0.0)
            alive2 = alive & ~nxt.done
            s2 = jax.tree.map(
                lambda a, b: jnp.where(
                    alive.reshape((-1,) + (1,) * (a.ndim - 1)), a, b),
                nxt, s)
            return (s2, alive2, ep_len, rew_sum), (perr, alive, s.obs,
                                                  nxt.reward)

        carry, outs = jax.lax.scan(
            step_fn, (s, jnp.ones(B, bool), jnp.zeros(B, jnp.int32),
                      jnp.zeros(B, jnp.float32)), None, length=H)
        return carry[2], carry[3], outs

    keys = jax.random.split(jax.random.PRNGKey(11), len(lane_ids))
    ep_len, rew_sum, (perr, alive, obs, rew) = jax.jit(jax.vmap(eval_lane))(
        _jax_lane_params(CKPT_IMIT5), jnp.asarray(lane_ids), keys)
    frames = np.stack([np.asarray(frames_of(k, key)[1])
                       for k, key in zip(lane_ids, keys)])
    tpol = MlpPolicy(**IMIT_POLICY)
    params, _ = checkpoint.load_lane_params(CKPT_IMIT5, tpol, "cpu")
    out = lanes.evaluate(tenv, tpol, params, _t(lane_ids), _t(frames), H,
                         record=True)
    ref = dict(ep_len=np.asarray(ep_len), rew_sum=np.asarray(rew_sum),
               perr=np.asarray(perr), alive=np.asarray(alive),
               obs=np.asarray(obs), rew=np.asarray(rew))
    return ref, out, frames


def test_lane_evaluation_of_imit5_matches_jax(lane_eval):
    """5 lanes x 2 episodes x 10 steps of imit5_r5b on the real physics,
    from the frames JAX's keys draw: equal episode lengths; per-step obs
    within 1e-3 and rewards within 1e-4 (the recipe evaluation's budget,
    test_torch_imitation.py); returns within 1e-3 and the pose error of
    each lane within 1e-4."""
    ref, out, frames = lane_eval
    L, B = frames.shape
    np.testing.assert_array_equal(out.ep_len.numpy(), ref["ep_len"])
    obs, rew = (x.reshape((x.shape[0], L, B) + tuple(x.shape[2:]))
                .transpose(0, 1).numpy() for x in out.traj)
    for k in range(L):
        for e in range(B):
            n = int(ref["ep_len"][k, e])
            assert n > 0
            np.testing.assert_allclose(obs[k, :n, e], ref["obs"][k, :n, e],
                                       atol=1e-3)
            np.testing.assert_allclose(rew[k, :n, e], ref["rew"][k, :n, e],
                                       atol=1e-4)
    np.testing.assert_allclose(out.rew_sum.numpy(), ref["rew_sum"],
                               atol=1e-3)
    m = ref["alive"]
    jerr = (ref["perr"] * m).sum((1, 2)) / np.maximum(m.sum((1, 2)), 1)
    np.testing.assert_allclose(out.pose_err.numpy(), jerr, atol=1e-4)
    assert obs.shape[-1] == 83 and 0.3 < float(rew.mean()) < 1.0


def test_backflip_touchdown_steps_match_jax_with_an_f32_dual(envs15):
    """20 steps of the backflip lane of imit5_r5b from frame 28 (an
    episode of the lane evaluation), in which the floor contacts break and
    form again three times (at steps 6, 12 and 15).  Each step is taken by
    both stacks from JAX's own state and action, with
    the dual matrix stored in f32 (``solver_dtype="f32"``): qpos within
    1e-6 and qvel within 1e-4 at every step.  With the default bf16
    storage the two stacks round f32 matrix entries that differ in their
    last bits to different bf16 values at a touchdown, which is what lets
    the backflip lane's 300-step figures drift apart; with f32 storage
    they do not."""
    import dataclasses

    from deepmimic_mujoco_torch.physics import collision, kinematics

    jenv15, _ = envs15
    clips = tuple(registry.SKILLS)
    jm = dataclasses.replace(jax_hinge_range(), solver_dtype="f32")
    tm = dataclasses.replace(mocap_hinge_range(device="cpu"),
                             solver_dtype="f32")
    jenv = jmulti.DPEnvV3Multi(clips=clips, model=jm, **TOOL_ENV)
    tenv = DPEnvV3Multi(clips=clips, model=tm, **TOOL_ENV)
    lane = IMIT5_CLIPS.index("backflip")
    jp = jax.tree.map(lambda x: x[lane], _jax_lane_params(CKPT_IMIT5))
    jpol = JaxMlpPolicy(**IMIT_POLICY)
    cid = registry.SKILLS.index("backflip")
    s = jax.vmap(lambda k, i: jenv.reset_at(k, cid, i))(
        jax.random.split(jax.random.PRNGKey(0), 1), jnp.asarray([28]))
    step = jax.jit(jax.vmap(jenv.step))
    touched = []
    for k in range(20):
        a = jpol.mean_logstd(jp, s.obs)[0]
        ts = EnvState(**{f: _t(getattr(s, f)) for f in (
            "qpos", "qvel", "obs", "reward", "done")},
            **{f: _t(getattr(s, f)).long() for f in (
                "mocap_idx", "init_idx", "step_count", "clip_id")})
        tn = tenv.step(ts, _t(a))
        s = step(s, a)
        _close(f"qpos step {k}", s.qpos, tn.qpos, 1e-6)
        _close(f"qvel step {k}", s.qvel, tn.qvel, 1e-4)
        touched.append(bool(collision.floor_contacts(
            tm, kinematics.fk(tm, tn.qpos)).active.any()))
    landed = [k for k in range(1, 20) if touched[k] and not touched[k - 1]]
    assert landed == [5, 11, 14], touched
