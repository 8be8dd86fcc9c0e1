"""The port's GAIL (``deepmimic_mujoco_torch/algos/{dataset,adversary,bc,
gail}.py``, ``cli/train_gail.py`` and the GAIL checkpoints) against the JAX
package on the CPU.

Inputs are numpy arrays from a seed, the bundled expert
``assets/expert/walk_expert.npz`` and the bundled r4 GAIL run
``train_ckpt_gail_r4``, handed to both stacks; JAX's random draws are
replayed through the port's seam (``tests/torch_replay.py``).  The JAX side
jits two physics programs: one ``GAIL.iteration`` on the imitation recipe,
and ``runner.evaluate`` of gail_r4.  The legacy d-step runs with the
physics swapped for the same cheap map in both stacks.  Tolerances are
stated per test."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.flatten_util
import jax.numpy as jnp

from deepmimic_mujoco_tpu.algos import dataset as jdataset
from deepmimic_mujoco_tpu.algos.adversary import (
    TransitionClassifier as JaxClassifier,
)
from deepmimic_mujoco_tpu.algos.bc import behavior_clone as jax_bc
from deepmimic_mujoco_tpu.algos.gail import GAIL as JaxGAIL
from deepmimic_mujoco_tpu.algos.gail import GAILConfig as JaxGAILConfig
from deepmimic_mujoco_tpu.algos.runner import evaluate as jax_evaluate
from deepmimic_mujoco_tpu.algos.trpo import TRPOConfig as JaxTRPOConfig
from deepmimic_mujoco_tpu.envs import DPEnvV3 as JaxDPEnvV3
from deepmimic_mujoco_tpu.io_utils import checkpoint as jax_checkpoint
from deepmimic_mujoco_tpu.models import MlpPolicy as JaxMlpPolicy
from deepmimic_mujoco_tpu.physics import build_humanoid as jax_build
from deepmimic_mujoco_torch.algos import dataset, runner
from deepmimic_mujoco_torch.algos.adversary import TransitionClassifier
from deepmimic_mujoco_torch.algos.bc import behavior_clone
from deepmimic_mujoco_torch.algos.gail import GAIL, GAILConfig, disc_leaves
from deepmimic_mujoco_torch.algos.trpo import (
    Draws,
    TRPOConfig,
    flatten,
    policy_leaves,
    vf_leaves,
)
from deepmimic_mujoco_torch.cli import train_gail
from deepmimic_mujoco_torch.envs.dp_env_v3 import DPEnvV3
from deepmimic_mujoco_torch.io_utils import checkpoint
from deepmimic_mujoco_torch.models.policy import MlpPolicy
from deepmimic_mujoco_torch.physics.humanoid import build_humanoid
from deepmimic_mujoco_torch.utils.running_stats import RunningMeanStd
from tests.torch_replay import ReplayDraws, fresh_fn

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
EXPERT = os.path.join(ROOT, "assets", "expert", "walk_expert.npz")
GAIL_R4 = os.path.join(ROOT, "train_ckpt_gail_r4", "DPEnvV3", "gail-walk-0",
                       "gail_state.npz")
# the r4 run's env (tools/r4_chain.sh): the imitation recipe, full obs
RECIPE = dict(clip="walk", reward_mode="imitation_dm",
              control_mode="pd_residual", n_substeps=2,
              max_episode_steps=300, obs_mode="full")
R4_FLAGS = ["--expert-path", EXPERT, "--motion", "walk", "--reward-mode",
            "imitation_dm", "--control-mode", "pd_residual", "--reset-mode",
            "rsi", "--n-substeps", "2", "--obs-mode", "full"]


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _close(out, ref, rel):
    """|out − ref| ≤ rel · max(1, max|ref|)."""
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    ref = np.asarray(ref, np.float64)
    err = float(np.abs(np.asarray(out, np.float64) - ref).max())
    assert err <= rel * max(1.0, float(np.abs(ref).max())), err


def _disc_params(jp):
    """JAX discriminator params → the port's."""
    return {"net": [{"w": _t(layer["w"]), "b": _t(layer["b"])}
                    for layer in jp["net"]],
            "obs_rms": RunningMeanStd(*(_t(x) for x in jp["obs_rms"]))}


@pytest.fixture(scope="module")
def models():
    return jax_build(), build_humanoid(device="cpu")


# ---------------------------------------------------------------------------
# the expert datasets


def _dense_lens_npz(path):
    rng = np.random.RandomState(0)
    obs = rng.randn(5, 7, 3).astype(np.float32)
    acs = rng.randn(5, 7, 2).astype(np.float32)
    np.savez(path, obs=obs, acs=acs, ep_rets=rng.randn(5).astype(np.float32),
             lens=np.array([7, 3, 5, 1, 6]))
    return path


@pytest.mark.parametrize("source", ["walk_expert", "dense_lens"])
@pytest.mark.parametrize("traj_limitation", [-1, 3])
def test_mujoco_dset_matches_jax(source, traj_limitation, tmp_path):
    """The flattened expert arrays, the split, the return statistics and
    twelve ``get_next_batch`` draws of each split (wraps and reshuffles
    included) are equal to JAX's: the three samplers share one
    ``RandomState(seed)``."""
    path = (EXPERT if source == "walk_expert"
            else _dense_lens_npz(str(tmp_path / "dense.npz")))
    kw = dict(traj_limitation=traj_limitation, seed=3)
    jd, td = jdataset.MujocoDset(path, **kw), dataset.MujocoDset(path, **kw)
    np.testing.assert_array_equal(td.obs, jd.obs)
    np.testing.assert_array_equal(td.acs, jd.acs)
    assert (td.num_traj, td.num_transition, td.avg_ret, td.std_ret) == (
        jd.num_traj, jd.num_transition, jd.avg_ret, jd.std_ret)
    if source == "dense_lens":
        assert td.num_transition == (22 if traj_limitation < 0 else 15)
    batch = 128 if source == "walk_expert" else 4
    for k in range(12):
        split = (None, "train", "val")[k % 3]
        for a, b in zip(td.get_next_batch(batch, split),
                        jd.get_next_batch(batch, split)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(td.get_next_batch(-1, "val"),
                    jd.get_next_batch(-1, "val")):
        np.testing.assert_array_equal(a, b)


def test_iterbatches_and_dataset_match_jax():
    """``iterbatches`` (by count and by size, with and without the partial
    batch) and ``Dataset`` (shuffled, three passes) yield JAX's arrays."""
    rng = np.random.RandomState(1)
    x, y = rng.randn(23, 3), rng.randn(23)
    for kw in (dict(num_batches=4), dict(batch_size=5),
               dict(batch_size=5, include_final_partial_batch=False)):
        out = list(dataset.iterbatches((x, y), rng=np.random.RandomState(2),
                                       **kw))
        ref = list(jdataset.iterbatches((x, y), rng=np.random.RandomState(2),
                                        **kw))
        assert len(out) == len(ref)
        for o, r in zip(out, ref):
            for a, b in zip(o, r):
                np.testing.assert_array_equal(a, b)
    td = dataset.Dataset({"x": x.copy(), "y": y.copy()}, seed=4)
    jd = jdataset.Dataset({"x": x.copy(), "y": y.copy()}, seed=4)
    for _ in range(3):
        for o, r in zip(td.iterate_once(6), jd.iterate_once(6)):
            np.testing.assert_array_equal(o["x"], r["x"])
    with pytest.raises(ValueError, match="exactly one"):
        next(dataset.iterbatches((x,), num_batches=2, batch_size=2))


# ---------------------------------------------------------------------------
# the discriminator and BC


@pytest.fixture(scope="module")
def classifiers():
    jc = JaxClassifier(ob_dim=68, ac_dim=28)
    jp = jc.init(jax.random.PRNGKey(3))
    rng = np.random.RandomState(5)
    # an obs-RMS away from its init, so normalization matters
    jp = jc.update_obs_rms(jp, (1.0 + 2.0 * rng.randn(64, 68)).astype(
        np.float32))
    data = [(s * rng.randn(40, d)).astype(np.float32)
            for s, d in ((3.0, 68), (0.5, 28), (3.0, 68), (0.5, 28))]
    return jc, jp, TransitionClassifier(ob_dim=68, ac_dim=28), \
        _disc_params(jp), data


def test_transition_classifier_matches_jax(classifiers):
    """Logits (without the ±5 clip: the obs reach ±15σ here), the total
    loss, its gradient, every metric, the reward and the obs-RMS update:
    1e-5 of max(1, |x|) (f32 sums in another order)."""
    jc, jp, tc, tp, (g_ob, g_ac, e_ob, e_ac) = classifiers
    _close(tc.logits(tp, _t(g_ob), _t(g_ac)), jc.logits(jp, g_ob, g_ac), 1e-5)
    assert float(np.abs((g_ob - np.asarray(jp["obs_rms"].mean))
                        / np.asarray(jp["obs_rms"].std)).max()) > 5.0
    jtotal, jm = jc.loss(jp, g_ob, g_ac, e_ob, e_ac)
    total, m = tc.loss(tp, _t(g_ob), _t(g_ac), _t(e_ob), _t(e_ac))
    _close(total, jtotal, 1e-5)
    assert sorted(m) == sorted(jm)
    for k in jm:
        _close(m[k], jm[k], 1e-5)
    _close(tc.reward(tp, _t(e_ob), _t(e_ac)), jc.reward(jp, e_ob, e_ac), 1e-5)
    for o, r in zip(tc.update_obs_rms(tp, _t(e_ob))["obs_rms"],
                    jc.update_obs_rms(jp, e_ob)["obs_rms"]):
        _close(o, r, 1e-5)

    flat, unravel = jax.flatten_util.ravel_pytree(jp["net"])
    jgrad = jax.grad(lambda th: jc.loss({**jp, "net": unravel(th)}, g_ob,
                                        g_ac, e_ob, e_ac)[0])(flat)
    leaves = [x.clone().requires_grad_(True) for x in disc_leaves(tp)]
    p = {**tp, "net": [{"b": leaves[2 * k], "w": leaves[2 * k + 1]}
                       for k in range(3)]}
    grads = torch.autograd.grad(tc.loss(p, _t(g_ob), _t(g_ac), _t(e_ob),
                                        _t(e_ac))[0], leaves)
    _close(flatten(list(grads)), jgrad, 1e-5)


def test_behavior_clone_matches_jax():
    """20 BC steps of a tanh 100×2 policy on the expert's train split (the
    same batches: one RandomState per dataset, seed 0): pol and logstd
    within 1e-5 of max(1, |x|) (Adam normalizes each step to ~3e-4), ob_rms
    within 1e-5; the loss went down."""
    jpol = JaxMlpPolicy(ob_dim=68, ac_dim=28)
    jp = jpol.init(jax.random.PRNGKey(4))
    jout = jax_bc(jpol, jp, jdataset.MujocoDset(EXPERT), max_iters=20,
                  verbose_every=0)
    tpol = MlpPolicy(ob_dim=68, ac_dim=28)
    tp = checkpoint.from_numpy_params(jax.tree.map(np.asarray, jp), "cpu")
    out = behavior_clone(tpol, tp, dataset.MujocoDset(EXPERT), max_iters=20,
                         verbose_every=0)
    flat = np.asarray(jax.flatten_util.ravel_pytree(
        {"pol": jout["pol"], "logstd": jout["logstd"]})[0])
    _close(flatten(policy_leaves(out)), flat, 1e-5)
    for o, r in zip(out["ob_rms"], jout["ob_rms"]):
        _close(o, r, 1e-5)
    assert float(out["ob_rms"].count) == pytest.approx(0.01 + 20 * 128)
    torch.testing.assert_close(out["vf"][0]["w"], tp["vf"][0]["w"])
    obs, acs = (torch.as_tensor(a) for a in dataset.MujocoDset(
        EXPERT).get_next_batch(512, "val"))
    before = float(tpol.neglogp(tp, obs, acs).mean())
    assert float(tpol.neglogp(out, obs, acs).mean()) < before


# ---------------------------------------------------------------------------
# the slice: one GAIL.iteration on the recipe


B, T, G = 4, 8, 2


def _jfake(qp, qv, ac):
    t = ac.mean(0) if ac.ndim == 2 else ac
    return qp.at[7:].set(0.5 * qp[7:] + 0.5 * t).at[0].add(0.01), 0.9 * qv


def _tfake(qp, qv, ac):
    t = ac.mean(1) if ac.dim() == 3 else ac
    return (torch.cat([qp[:, :1] + 0.01, qp[:, 1:7], 0.5 * qp[:, 7:] + 0.5 * t],
                      dim=1), 0.9 * qv)


def _run(models, tmp_path, d_exact, physics):
    """One ``GAIL.iteration`` of both stacks (4 envs × 8 steps × g_step 2,
    the recipe with 5-step episodes so that RSI resets happen, a tanh
    100×2 policy) from JAX's ``init`` state, read by the port through
    ``load_gail_state`` from JAX's own checkpoint file."""
    jm, tm = models
    env_kw = dict(RECIPE, max_episode_steps=5)
    jenv, tenv = JaxDPEnvV3(model=jm, **env_kw), DPEnvV3(model=tm, **env_kw)
    if not physics:
        jenv._dynamics, tenv._dynamics = _jfake, _tfake
    jd = jdataset.MujocoDset(EXPERT)
    kw = dict(d_step=2 if d_exact else 1, d_exact=d_exact)
    jlearner = JaxGAIL(jenv, JaxMlpPolicy(ob_dim=68, ac_dim=28), jd.obs,
                       jd.acs, JaxGAILConfig(trpo=JaxTRPOConfig(
                           horizon=T, num_envs=B, g_step=G,
                           reset_mode="rsi"), **kw))
    js0 = jlearner.init(jax.random.PRNGKey(7))
    # a cursor near the end of the expert rows: the expert slices wrap
    js0 = type(js0)(trpo=js0.trpo, d_params=js0.d_params, d_adam=js0.d_adam,
                    expert_ptr=jnp.asarray(jd.obs.shape[0] - 20, jnp.int32))
    path = str(tmp_path / f"gail0_{d_exact}.npz")
    jax_checkpoint.save(path, js0)
    js1, jstats = jlearner.iteration(js0)

    tlearner = GAIL(tenv, MlpPolicy(ob_dim=68, ac_dim=28),
                    dataset.MujocoDset(EXPERT).obs,
                    dataset.MujocoDset(EXPERT).acs,
                    GAILConfig(trpo=TRPOConfig(horizon=T, num_envs=B,
                                               g_step=G, reset_mode="rsi"),
                               **kw))
    draws = ReplayDraws(js0.trpo.key, js0.trpo.env_state.key,
                        fresh_fn(jenv, "rsi"))
    ts0 = checkpoint.load_gail_state(path, tlearner, draws)
    ts1, tstats = tlearner.iteration(ts0)
    return jax.tree.map(np.asarray, (js1, jstats)), (ts1, tstats), tlearner


@pytest.fixture(scope="module")
def exact_run(models, tmp_path_factory):
    return _run(models, tmp_path_factory.mktemp("exact"), True, True)


@pytest.fixture(scope="module")
def legacy_run(models, tmp_path_factory):
    return _run(models, tmp_path_factory.mktemp("legacy"), False, False)


def _check_iteration(run, atol_obs):
    (js1, jstats), (ts1, tstats), _ = run
    jt, tt = jstats.trpo, tstats.trpo
    # per-episode records: lengths equal; disc and true returns
    np.testing.assert_array_equal(tt.ep_lens.numpy(), jt.ep_lens)
    assert int(tt.ep_count) == int(jt.ep_count) >= B
    np.testing.assert_allclose(tt.ep_rets.numpy(), jt.ep_rets, atol=1e-3)
    np.testing.assert_allclose(tstats.true_ep_rets.numpy(),
                               jstats.true_ep_rets, atol=1e-3)
    assert not np.allclose(jstats.true_ep_rets, jt.ep_rets)
    _close(tstats.true_ep_ret_sum, jstats.true_ep_ret_sum, 1e-3)
    np.testing.assert_allclose(ts1.trpo.env_state.obs.numpy(),
                               js1.trpo.env_state.obs, atol=atol_obs)
    np.testing.assert_array_equal(ts1.trpo.cur_ep_len.numpy(),
                                  js1.trpo.cur_ep_len)
    # the policy and vf after two TRPO updates
    jp, tp = js1.trpo.params, ts1.trpo.params
    jflat = np.asarray(jax.flatten_util.ravel_pytree(
        {"pol": jp["pol"], "logstd": jp["logstd"]})[0])
    _close(flatten(policy_leaves(tp)), jflat, 1e-4)
    _close(flatten(vf_leaves(tp)),
           np.asarray(jax.flatten_util.ravel_pytree(jp["vf"])[0]), 1e-3)
    for k in ("meankl", "surrgain", "ev_tdlam_before"):
        _close(getattr(tt, k), getattr(jt, k), 1e-3)
    # the discriminator after its d-step
    assert int(ts1.expert_ptr) == int(js1.expert_ptr)
    _close(flatten(disc_leaves(ts1.d_params)),
           np.asarray(jax.flatten_util.ravel_pytree(
               js1.d_params["net"])[0]), 1e-4)
    for o, r in zip(ts1.d_params["obs_rms"], js1.d_params["obs_rms"]):
        _close(o, r, 1e-4)
    for o, r in zip(ts1.d_adam, js1.d_adam):
        _close(o, r, 1e-4)
    for k in ("d_loss", "gen_acc", "exp_acc"):
        _close(getattr(tstats, k), getattr(jstats, k), 1e-4)


def test_iteration_exact_d_step_matches_jax(exact_run):
    """The exact d-step (2 sequential minibatches of the shuffled last
    segment; the expert cursor wraps from 20 rows before the end) after
    two rewarded segments on the recipe's physics: equal episode lengths,
    equal expert cursor; disc and true episode returns within 1e-3, obs
    within 1e-3 (the evaluation's budget); policy within 1e-4, vf within
    1e-3, the discriminator, its obs-RMS and Adam within 1e-4 and its
    loss and accuracies within 1e-4 (relative to max(1, |x|))."""
    _check_iteration(exact_run, 1e-3)
    (js1, _), (ts1, _), _ = exact_run
    assert int(ts1.expert_ptr) == (19200 - 20 + T * B) % 19200 == 12
    assert float(ts1.d_adam.t) == 2.0


def test_iteration_legacy_d_step_matches_jax(legacy_run):
    """The legacy d-step (4 random subsamples without replacement, expert
    rows with replacement; the cursor stays), the physics swapped for the
    same cheap map in both stacks: the same bounds, obs within 1e-5."""
    _check_iteration(legacy_run, 1e-5)
    (js1, _), (ts1, _), _ = legacy_run
    assert int(ts1.expert_ptr) == 19200 - 20
    assert float(ts1.d_adam.t) == 4.0


def test_port_gail_checkpoint_loads_in_jax_strictly(exact_run, tmp_path):
    """The port's ``gail_state.npz`` loads through JAX's strict
    ``checkpoint.load`` into a fresh ``GAILState`` with JAX's dtypes and
    shapes, its leaves equal to the port's state, and reads back through
    ``load_gail_state``."""
    (_, _), (ts1, _), tlearner = exact_run
    path = checkpoint.save(str(tmp_path / "gail_state"), ts1)
    jd = jdataset.MujocoDset(EXPERT)
    like = JaxGAIL(JaxDPEnvV3(**RECIPE), JaxMlpPolicy(ob_dim=68, ac_dim=28),
                   jd.obs, jd.acs, JaxGAILConfig(trpo=JaxTRPOConfig(
                       num_envs=B))).init(jax.random.PRNGKey(0))
    js = jax_checkpoint.load(path, like)
    for a, b in zip(jax.tree.leaves(js), jax.tree.leaves(like)):
        assert (np.asarray(a).dtype, np.shape(a)) == (np.asarray(b).dtype,
                                                      np.shape(b))
    np.testing.assert_array_equal(np.asarray(js.d_params["net"][1]["w"]),
                                  ts1.d_params["net"][1]["w"].numpy())
    assert int(js.expert_ptr) == int(ts1.expert_ptr)
    np.testing.assert_array_equal(np.asarray(js.trpo.params["logstd"]),
                                  ts1.trpo.params["logstd"].numpy())
    back = checkpoint.load_gail_state(path, tlearner, Draws(None))
    for a, b in zip(disc_leaves(back.d_params) + list(back.d_adam),
                    disc_leaves(ts1.d_params) + list(ts1.d_adam)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(back.trpo.env_state.qpos,
                               ts1.trpo.env_state.qpos, rtol=0, atol=0)
    with pytest.raises(ValueError, match="not a GAILState"):
        checkpoint.load_gail_state(
            os.path.join(ROOT, "train_ckpt_walk_r2", "DPEnvV3",
                         "trpo-walk-0", "trpo_state.npz"),
            tlearner, Draws(None))


# ---------------------------------------------------------------------------
# the bundled r4 run


@pytest.fixture(scope="module")
def r4(models):
    jm, tm = models
    jenv = JaxDPEnvV3(model=jm, **RECIPE)
    jd = jdataset.MujocoDset(EXPERT)
    jlearner = JaxGAIL(jenv, JaxMlpPolicy(ob_dim=68, ac_dim=28), jd.obs,
                       jd.acs, JaxGAILConfig(trpo=JaxTRPOConfig(
                           num_envs=64)))
    js = jax_checkpoint.load(GAIL_R4, jlearner.init(jax.random.PRNGKey(0)))
    tenv = DPEnvV3(model=tm, **RECIPE)
    td = dataset.MujocoDset(EXPERT)
    tlearner = GAIL(tenv, MlpPolicy(ob_dim=68, ac_dim=28), td.obs, td.acs,
                    GAILConfig(trpo=TRPOConfig(num_envs=64)))
    ts = checkpoint.load_gail_state(GAIL_R4, tlearner, Draws(None))
    return jenv, jlearner, js, tenv, tlearner, ts


def test_gail_r4_reader_matches_jax_strict_load(r4):
    """Every leaf ``load_gail_state`` reads from the bundled r4 state (its
    structure string has ``None`` for ``clip_id``) equals JAX's strict
    ``checkpoint.load``: 0 error."""
    _, _, js, _, _, ts = r4
    jflat = jax.flatten_util.ravel_pytree(
        {"pol": js.trpo.params["pol"], "logstd": js.trpo.params["logstd"]})[0]
    np.testing.assert_array_equal(flatten(policy_leaves(ts.trpo.params)),
                                  np.asarray(jflat))
    np.testing.assert_array_equal(flatten(disc_leaves(ts.d_params)),
                                  np.asarray(jax.flatten_util.ravel_pytree(
                                      js.d_params["net"])[0]))
    for o, r in [*zip(ts.d_params["obs_rms"], js.d_params["obs_rms"]),
                 *zip(ts.d_adam, js.d_adam), *zip(ts.trpo.vf_adam,
                                                  js.trpo.vf_adam)]:
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    assert int(ts.expert_ptr) == int(js.expert_ptr) == 12800
    np.testing.assert_array_equal(ts.trpo.env_state.step_count.numpy(),
                                  np.asarray(js.trpo.env_state.step_count))
    assert float(ts.d_adam.t) == 800.0


def test_gail_r4_evaluation_matches_jax(r4, tmp_path):
    """JAX's ``runner.evaluate`` of gail_r4's policy (4 RSI episodes × 10
    steps, deterministic) and the port's rollout from the same frames:
    equal episode lengths, obs and actions within 1e-3 (the evaluation's
    budget), per-step rewards within 1e-4."""
    jenv, jlearner, js, tenv, tlearner, ts = r4
    n, horizon, key = 4, 10, jax.random.PRNGKey(5)
    path = str(tmp_path / "eval.npz")
    jax_evaluate(jenv, jlearner.policy, js.trpo.params, key, n_episodes=n,
                 horizon=horizon, save_path=path, reset_mode="rsi")
    with np.load(path, allow_pickle=True) as z:
        ref = {k: z[k] for k in z.files}
    frames = np.asarray(jax.vmap(jenv.reset)(
        jax.random.split(key, n + 1)[1:]).init_idx)
    out = runner.rollout(tenv, tlearner.policy, ts.trpo.params,
                         tenv.reset_at(frames), horizon, record=True)
    np.testing.assert_array_equal(out.ep_len.numpy(), ref["lens"])
    obs, acs, rews = (x.swapaxes(0, 1).numpy() for x in out.traj)
    for e, k in enumerate(ref["lens"]):
        np.testing.assert_allclose(obs[e, :k], ref["obs"][e], atol=1e-3)
        np.testing.assert_allclose(acs[e, :k], ref["acs"][e], atol=1e-3)
        np.testing.assert_allclose(rews[e, :k], ref["rews"][e], atol=1e-4)
    assert 0.2 < float(rews.mean()) < 1.0


# ---------------------------------------------------------------------------
# the CLI


def test_cli_trains_with_bc_and_writes_a_checkpoint_jax_loads(tmp_path,
                                                             capsys):
    """``cli.train_gail`` with the r4 flags at 2 envs × 6 steps, g_step 1,
    BC pretraining, 2 iterations, 4-step episodes: it prints the BC loss
    and the JAX CLI's tabular keys; the monitor records the TRUE returns
    (the mean of its last rows is ``EpTrueRewMean``); its
    ``gail_state.npz`` loads in JAX strictly and reads back in the
    port."""
    state = train_gail.main([
        *R4_FLAGS, "--max-episode-steps", "4", "--device", "cpu", "--num-envs", "2", "--timesteps-per-batch", "6",
        "--g-step", "1", "--num-iters", "2", "--pretrained",
        "--bc-max-iters", "3", "--log-dir", str(tmp_path / "logs"),
        "--checkpoint-dir", str(tmp_path / "ckpt")])
    out = capsys.readouterr().out
    assert "BC iter 0: loss" in out and "BC iter 2: loss" in out
    logs = tmp_path / "logs" / "DPEnvV3" / "gail-walk-0"
    with open(logs / "progress.csv") as fh:
        rows = [line.strip().split(",") for line in fh]
    assert sorted(rows[0]) == sorted([
        "EpLenMean", "EpRewMean", "EpTrueRewMean", "DLoss", "GenAcc",
        "ExpertAcc", "TimestepsSoFar", "TimeElapsed"])
    last = dict(zip(rows[0], map(float, rows[-1])))
    with open(logs / "monitor.json.monitor.csv") as fh:
        mon = [line.strip().split(",") for line in fh.readlines()[2:]]
    true_rets = [float(r[0]) for r in mon]
    assert len(true_rets) >= 2
    assert np.mean(true_rets[-40:]) == pytest.approx(last["EpTrueRewMean"],
                                                     abs=1e-5)
    assert last["EpRewMean"] != pytest.approx(last["EpTrueRewMean"])
    path = str(tmp_path / "ckpt" / "DPEnvV3" / "gail-walk-0" /
               "gail_state.npz")
    jd = jdataset.MujocoDset(EXPERT)
    like = JaxGAIL(JaxDPEnvV3(**RECIPE), JaxMlpPolicy(ob_dim=68, ac_dim=28),
                   jd.obs, jd.acs, JaxGAILConfig(trpo=JaxTRPOConfig(
                       num_envs=2))).init(jax.random.PRNGKey(0))
    js = jax_checkpoint.load(path, like)
    np.testing.assert_array_equal(np.asarray(js.trpo.params["pol"][0]["w"]),
                                  state.trpo.params["pol"][0]["w"].numpy())
    assert int(js.expert_ptr) == int(state.expert_ptr) == 2 * 12


@pytest.mark.parametrize("flags", [
    ["--platform", "cpu"],
    ["--platform", "gpu", "--device", "cpu"],   # --device takes precedence
], ids=["platform-cpu", "device-over-platform"])
def test_cli_env_id_names_the_run_and_platform_picks_the_device(tmp_path,
                                                                flags):
    """``--env-id`` is a free string that names only the log and checkpoint
    directory (the JAX CLI's ``{env_id}/gail-{motion}-{seed}``; the env
    stays DPEnvV3), and ``--platform`` maps to a device as in
    ``cli.train_ppo``."""
    state = train_gail.main([
        *R4_FLAGS, "--max-episode-steps", "4", *flags, "--env-id", "Foo",
        "--num-envs", "2", "--timesteps-per-batch", "4", "--g-step", "1",
        "--num-iters", "2", "--log-dir", str(tmp_path / "logs"),
        "--checkpoint-dir", str(tmp_path / "ckpt")])
    assert state.trpo.params["pol"][0]["w"].device.type == "cpu"
    assert (tmp_path / "logs" / "Foo" / "gail-walk-0" / "progress.csv"
            ).read_text().count("\n") == 3
    assert (tmp_path / "ckpt" / "Foo" / "gail-walk-0" /
            "gail_state.npz").exists()
    assert not (tmp_path / "logs" / "DPEnvV3").exists()


def test_cli_refuses_an_expert_of_another_obs_dim(tmp_path):
    """The expert's 68-D obs against the default env's 56-D."""
    with pytest.raises(ValueError, match="expert obs dim 68 != env obs dim"):
        train_gail.main(["--expert-path", EXPERT, "--device", "cpu",
                         "--num-iters", "1", "--log-dir", str(tmp_path)])


@pytest.mark.slow
def test_gail_r4_64_episodes_match_jax(r4, capsys):
    """The smoke's [gail] evaluation on the CPU, in both stacks: gail_r4's
    policy over 64 RSI episodes × 300 steps from the frames JAX's
    ``runner.evaluate`` draws from ``PRNGKey(0)``, deterministic.  Prints
    the frames and both stacks' mean episode length and reward per step
    (the port's are ``chip_smoke.py``'s ``CPU_GAIL``); they agree within
    0.03 reward per step and 5% EpLen.  Several minutes: not in tier-1."""
    jenv, jlearner, js, tenv, tlearner, ts = r4
    n, horizon, key = 64, 300, jax.random.PRNGKey(0)
    j_len, j_ret = jax_evaluate(jenv, jlearner.policy, js.trpo.params, key,
                                n_episodes=n, horizon=horizon,
                                reset_mode="rsi")
    frames = np.asarray(jax.vmap(jenv.reset)(
        jax.random.split(key, n + 1)[1:]).init_idx)
    out = runner.rollout(tenv, tlearner.policy, ts.trpo.params,
                         tenv.reset_at(frames), horizon)
    t_len, t_ret = float(out.ep_len.double().mean()), float(
        out.ep_ret.double().mean())
    with capsys.disabled():
        print(f"\nframes {','.join(map(str, frames))}\nJAX: EpLen "
              f"{j_len:.2f}, reward per step {j_ret / j_len:.4f}\nport: "
              f"EpLen {t_len:.2f}, reward per step {t_ret / t_len:.4f}")
    assert abs(t_ret / t_len - j_ret / j_len) <= 0.03
    assert abs(t_len - j_len) <= 0.05 * j_len
