"""The port's TRPO training (``deepmimic_mujoco_torch/algos``) against the
JAX package on the CPU.

Every input is made with numpy from a seed, or by the JAX package from a
key, and handed to both stacks.  The two cannot share random streams (JAX
threefry, torch Philox), so the port's draws (action noise, reset states,
vf permutations) are replaced through its one seam, ``trpo.Draws``, by the
draws JAX makes from the same keys in the same split order.  The JAX side
compiles one physics program (its jitted ``TRPO.iteration``).  Tolerances
are stated per test."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.flatten_util
import jax.numpy as jnp

from deepmimic_mujoco_tpu.algos import adam as jadam
from deepmimic_mujoco_tpu.algos.cg import cg as jcg
from deepmimic_mujoco_tpu.algos.gae import add_vtarg_and_adv as jgae
from deepmimic_mujoco_tpu.algos.trpo import TRPO as JTRPO
from deepmimic_mujoco_tpu.algos.trpo import TRPOConfig as JConfig
from deepmimic_mujoco_tpu.envs import DPEnvV3 as JaxDPEnvV3
from deepmimic_mujoco_tpu.io_utils import checkpoint as jcheckpoint
from deepmimic_mujoco_tpu.models import MlpPolicy as JaxMlpPolicy
from deepmimic_mujoco_tpu.models.distributions import diag_gaussian as jdg
from deepmimic_mujoco_tpu.utils import math as jmath
from deepmimic_mujoco_tpu.utils import running_stats as jrs
from deepmimic_mujoco_torch.algos import adam, train_loop, trpo
from deepmimic_mujoco_torch.algos.cg import cg
from deepmimic_mujoco_torch.algos.gae import add_vtarg_and_adv
from deepmimic_mujoco_torch.envs.dp_env_v3 import DPEnvV3
from deepmimic_mujoco_torch.io_utils import checkpoint
from deepmimic_mujoco_torch.models.distributions import diag_gaussian
from deepmimic_mujoco_torch.models.policy import MlpPolicy
from deepmimic_mujoco_torch.utils import math as tmath
from deepmimic_mujoco_torch.utils import running_stats

torch.set_num_threads(1)

REL = 1e-6  # building blocks: f32 sums in another order


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _close(out, ref, rel=REL):
    """|out − ref| ≤ rel · max(1, max|ref|)."""
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    ref = np.asarray(ref, np.float64)
    err = float(np.abs(np.asarray(out, np.float64) - ref).max())
    assert err <= rel * max(1.0, float(np.abs(ref).max())), err


# ---------------------------------------------------------------------------
# building blocks


def test_gae_with_episode_starts_inside_the_segment_matches_jax():
    rng = np.random.RandomState(0)
    T, B = 12, 3
    rew = rng.randn(T, B).astype(np.float32)
    vpred = rng.randn(T, B).astype(np.float32)
    new = np.zeros((T, B), np.float32)
    new[[0, 4, 9], [0, 1, 2]] = 1.0
    new[5, 0] = 1.0
    nextvpred = rng.randn(B).astype(np.float32)
    ref = jgae(rew, vpred, new, nextvpred, 0.995, 0.97)
    out = add_vtarg_and_adv(_t(rew), _t(vpred), _t(new), _t(nextvpred),
                            0.995, 0.97)
    for o, r in zip(out, ref):
        _close(o, r)


def test_cg_on_an_spd_matrix_matches_jax():
    rng = np.random.RandomState(1)
    m = rng.randn(20, 20)
    a = (m @ m.T / 20 + 0.1 * np.eye(20)).astype(np.float32)
    b = rng.randn(20).astype(np.float32)
    ref = jcg(lambda p: jnp.asarray(a) @ p, jnp.asarray(b), cg_iters=10)
    out = cg(lambda p: _t(a) @ p, _t(b), cg_iters=10)
    _close(out, ref, 1e-5)  # ten dependent steps: 1e-5 of max(1, |x|)


def test_three_adam_steps_match_jax():
    rng = np.random.RandomState(2)
    theta = rng.randn(50).astype(np.float32)
    js, ts = jadam.init(50), adam.init(50, "cpu")
    jt, tt = jnp.asarray(theta), _t(theta)
    for k in range(3):
        g = rng.randn(50).astype(np.float32) * 10.0 ** (k - 1)
        jt, js = jadam.update(js, jnp.asarray(g), jt, 1e-3)
        tt, ts = adam.update(ts, _t(g), tt, 1e-3)
    _close(tt, jt)
    for o, r in zip(ts, js):
        _close(o, r)
    assert ts.t.dtype == torch.float32 and float(ts.t) == 3.0


def test_running_stats_update_matches_jax():
    rng = np.random.RandomState(3)
    jr, tr = jrs.init(7), running_stats.init(7, "cpu")
    for n in (5, 128, 1):
        x = (3.0 + 2.0 * rng.randn(n, 7)).astype(np.float32)
        jr, tr = jrs.update(jr, x), running_stats.update(tr, _t(x))
    for o, r in zip(tr, jr):
        _close(o, r)


@pytest.mark.parametrize("fn", ["neglogp", "logp", "kl", "entropy"])
def test_diag_gaussian_matches_jax(fn):
    rng = np.random.RandomState(4)
    m0, m1, x = (rng.randn(9, 28).astype(np.float32) for _ in range(3))
    s0, s1 = (0.3 * rng.randn(9, 28).astype(np.float32) for _ in range(2))
    args = {"neglogp": (m0, s0, x), "logp": (m0, s0, x),
            "kl": (m0, s0, m1, s1), "entropy": (s0,)}[fn]
    ref = getattr(jdg, fn)(*map(jnp.asarray, args))
    out = getattr(diag_gaussian, fn)(*map(_t, args))
    _close(out, ref)


def test_explained_variance_uses_the_population_variance():
    rng = np.random.RandomState(5)
    y = rng.randn(64).astype(np.float32)
    ypred = (y + 0.5 * rng.randn(64)).astype(np.float32)
    _close(tmath.explained_variance(_t(ypred), _t(y)),
           jmath.explained_variance(ypred, y))
    ones = torch.ones(8)
    assert np.isnan(float(tmath.explained_variance(ones, ones)))  # 0/0


@pytest.mark.parametrize("fn", ["discount", "discount_with_boundaries"])
def test_discounts_match_jax(fn):
    rng = np.random.RandomState(6)
    x = rng.randn(15).astype(np.float32)
    new = (rng.rand(15) < 0.2).astype(np.float32)
    args = (x, 0.99) if fn == "discount" else (x, new, 0.99)
    ref = getattr(jmath, fn)(*args)
    out = getattr(tmath, fn)(*(_t(a) if isinstance(a, np.ndarray) else a
                               for a in args))
    _close(out, ref)


def test_policy_methods_match_jax():
    """``neglogp``, ``kl``, ``entropy`` and ``act`` on JAX-initialized
    params; ``init`` keeps the normc init (columns of norm 1, the policy
    head 0.01) and ``logstd0`` from ``fixed_logstd``."""
    jpol = JaxMlpPolicy(ob_dim=56, ac_dim=28)
    jp = jpol.init(jax.random.PRNGKey(7))
    jp2 = jpol.init(jax.random.PRNGKey(8))
    tpol = MlpPolicy(ob_dim=56, ac_dim=28)
    tp = checkpoint.from_numpy_params(jax.tree.map(np.asarray, jp), "cpu")
    tp2 = checkpoint.from_numpy_params(jax.tree.map(np.asarray, jp2), "cpu")
    rng = np.random.RandomState(9)
    ob, ac = rng.randn(11, 56).astype(np.float32), rng.randn(11, 28).astype(
        np.float32)
    _close(tpol.neglogp(tp, _t(ob), _t(ac)), jpol.neglogp(jp, ob, ac), 1e-5)
    _close(tpol.kl(tp, tp2, _t(ob)), jpol.kl(jp, jp2, ob), 1e-5)
    _close(tpol.entropy(tp, _t(ob)), jpol.entropy(jp, ob))
    ac_det, v = tpol.act(tp, None, _t(ob), stochastic=False)
    _close(ac_det, jpol.mean_logstd(jp, ob)[0], 1e-5)
    _close(v, jpol.value(jp, ob), 1e-5)

    fixed = MlpPolicy(ob_dim=56, ac_dim=28, fixed_logstd=-1.6,
                      hidden_sizes=(64, 32))
    p = fixed.init(torch.Generator().manual_seed(0), "cpu")
    assert [tuple(layer["w"].shape) for layer in p["pol"]] == [
        (56, 64), (64, 32), (32, 28)]
    torch.testing.assert_close(p["logstd"], torch.full((28,), -1.6))
    norms = torch.linalg.vector_norm(p["pol"][2]["w"], dim=0)
    torch.testing.assert_close(norms, torch.full((28,), 0.01))
    torch.testing.assert_close(
        torch.linalg.vector_norm(p["vf"][0]["w"], dim=0),
        torch.ones(64))


# ---------------------------------------------------------------------------
# one _segment_update from a synthetic segment


class ReplayDraws(trpo.Draws):
    """The port's draws replaced by JAX's, from JAX's keys in the split
    order of ``deepmimic_mujoco_tpu/algos/trpo.py``: ``key`` is the
    ``TRPOState`` key, ``env_keys`` the env states' keys (B, 2), ``env`` the
    JAX env whose ``reset_init`` makes the post-done states."""

    def __init__(self, key, env_keys=None, env=None):
        super().__init__(None)
        self.key, self.env_keys, self.env = key, env_keys, env
        if env is not None:
            self._fresh = jax.jit(jax.vmap(lambda k: env.reset_init(
                jax.random.split(k)[0])))

    def action_noise(self, mean):
        self.key, k_act = jax.random.split(self.key)
        k_acts = jax.random.split(k_act, mean.shape[0])
        noise = jax.vmap(lambda k: jax.random.normal(
            k, (mean.shape[1],), jnp.float32))(k_acts)
        return _t(noise)

    def fresh_states(self, reset_fn, done):
        fresh = self._fresh(self.env_keys)
        self.env_keys = jnp.where(jnp.asarray(done.numpy())[:, None],
                                  fresh.key, self.env_keys)
        return trpo.EnvState(
            qpos=_t(fresh.qpos), qvel=_t(fresh.qvel), obs=_t(fresh.obs),
            reward=_t(fresh.reward), done=_t(fresh.done),
            mocap_idx=_t(fresh.mocap_idx).long(),
            init_idx=_t(fresh.init_idx).long(),
            step_count=_t(fresh.step_count).long())

    def vf_permutations(self, n, epochs, device):
        self.key, k_vf = jax.random.split(self.key)
        return torch.stack([_t(jax.random.permutation(k, n)).long()
                            for k in jax.random.split(k_vf, epochs)])


def _jax_flat(params):
    return np.asarray(jax.flatten_util.ravel_pytree(
        {"pol": params["pol"], "logstd": params["logstd"]})[0])


def _port_flat(params):
    return trpo.flatten(trpo.policy_leaves(params)).numpy()


class _Spy:
    """Records what each ``jax.lax.while_loop`` returns: JAX's CG (whose
    init carry holds g, and whose result holds the step direction) and line
    search (whose result holds the accepted step size)."""

    def __init__(self, while_loop):
        self.while_loop, self.calls = while_loop, []

    def __call__(self, cond, body, init):
        out = self.while_loop(cond, body, init)
        self.calls.append((init, out))
        return out


def _segment(seed, T, B):
    rng = np.random.RandomState(seed)
    new = (rng.rand(T, B) < 0.1).astype(np.float32)
    new[0] = 1.0
    return {
        "ob": (0.5 + rng.randn(T, B, 56)).astype(np.float32),
        "ac": rng.randn(T, B, 28).astype(np.float32),
        "vpred": (0.1 * rng.randn(T, B)).astype(np.float32),
        "rew": (1.0 + 0.3 * rng.randn(T, B)).astype(np.float32),
        "new": new,
        "nextvpred": (0.1 * rng.randn(B)).astype(np.float32),
    }


@pytest.fixture(scope="module", params=[None, -1.0],
                ids=["learned_logstd", "fixed_logstd"])
def segment_update(request):
    """One ``_segment_update`` of both stacks from the same synthetic
    segment (B = 8, T = 32: 256 rows, two vf minibatches per epoch), the
    same JAX-initialized params and the same key."""
    fixed = request.param
    T, B = 32, 8
    cfg = JConfig(horizon=T, num_envs=B)
    jpol = JaxMlpPolicy(ob_dim=56, ac_dim=28, fixed_logstd=fixed)
    learner = JTRPO(JaxDPEnvV3(clip="walk"), jpol, cfg)
    jp = jpol.init(jax.random.PRNGKey(11))
    n_vf = jax.flatten_util.ravel_pytree(jp["vf"])[0].shape[0]
    seg = _segment(12, T, B)
    key = jax.random.PRNGKey(13)
    spy = _Spy(jax.lax.while_loop)
    jax.lax.while_loop = spy
    try:
        jres = learner._segment_update(jp, jadam.init(n_vf),
                                       jax.tree.map(jnp.asarray, seg), key)
    finally:
        jax.lax.while_loop = spy.while_loop
    (cg_init, cg_out), (_, ls_out) = spy.calls
    jinfo = dict(g=np.asarray(cg_init[2]), stepdir=np.asarray(cg_out[1]),
                 stepsize=float(ls_out[1]), accepted=bool(ls_out[2]))

    tpol = MlpPolicy(ob_dim=56, ac_dim=28, fixed_logstd=fixed)
    tlearner = trpo.TRPO(DPEnvV3(clip="walk", device="cpu"), tpol,
                         trpo.TRPOConfig(horizon=T, num_envs=B))
    tp = checkpoint.from_numpy_params(jax.tree.map(np.asarray, jp), "cpu")
    tres = tlearner._segment_update(tp, adam.init(n_vf, "cpu"),
                                    {k: _t(v) for k, v in seg.items()},
                                    ReplayDraws(key))
    return jp, jres, jinfo, tp, tres


def test_segment_update_gradient_and_step_direction(segment_update):
    """g within 1e-5 of its largest entry (sums over 256 rows in another
    order); the CG step direction within 1e-4 of its norm (CG amplifies
    the FVP's rounding); the same accepted step size, exactly."""
    _, _, jinfo, _, tres = segment_update
    info = tres[4]
    g, ref_g = info.g.numpy(), jinfo["g"]
    assert np.abs(g - ref_g).max() <= 1e-5 * np.abs(ref_g).max()
    # JAX masks the fixed-logstd coordinates after its CG
    mask = np.ones_like(ref_g)
    if segment_update[3]["logstd"][0] == -1.0:
        mask[:28] = 0.0
    sd, ref_sd = info.stepdir.numpy(), jinfo["stepdir"] * mask
    assert np.linalg.norm(sd - ref_sd) <= 1e-4 * np.linalg.norm(ref_sd)
    assert info.stepsize == jinfo["stepsize"]
    assert info.accepted == jinfo["accepted"] is True
    if mask[0] == 0.0:
        assert not sd[:28].any()


def test_segment_update_params_and_ob_rms(segment_update):
    """New pol and logstd within 1e-5, vf within 1e-4 after 6 Adam steps of
    1e-3 (Adam normalizes the gradient, so an entry's step is ~1e-3 whatever
    its size), ob_rms within 1e-6 (relative to max(1, |x|))."""
    jp0, jres, _, tp0, tres = segment_update
    jp, tp = jres[0], tres[0]
    _close(_port_flat(tp), _jax_flat(jp), 1e-5)
    assert np.abs(_port_flat(tp) - _port_flat(tp0)).max() > 1e-4  # it moved
    jvf = np.asarray(jax.flatten_util.ravel_pytree(jp["vf"])[0])
    _close(trpo.flatten(trpo.vf_leaves(tp)), jvf, 1e-4)
    for o, r in zip(tp["ob_rms"], jp["ob_rms"]):
        _close(o, r)
    if tp0["logstd"][0] == -1.0:
        assert torch.equal(tp["logstd"], tp0["logstd"])


def test_segment_update_adam_losses_and_ev(segment_update):
    """Adam's m within 1e-5, v within 1e-6 (relative to max(1, |x|)), t
    equal; the five mean losses and the explained variance within 1e-5."""
    _, jres, _, _, tres = segment_update
    (m, v, t), (jm, jv, jt) = tres[1], jres[1]
    _close(m, jm, 1e-5)
    _close(v, jv)
    assert float(t) == float(jt) == 6.0
    _close(tres[2], jres[2], 1e-5)
    _close(tres[3], jres[3], 1e-5)


# ---------------------------------------------------------------------------
# the slice: one TRPO.iteration on the physics


HORIZON = 40


@pytest.fixture(scope="module")
def iteration():
    """One ``TRPO.iteration`` (B = 8, horizon 40, g_step 1) of both stacks
    from JAX's ``init`` state (RSI starts); the port replays JAX's action
    noise, post-done noise resets and vf permutations."""
    B = 8
    jenv = JaxDPEnvV3(clip="walk")
    jpol = JaxMlpPolicy(ob_dim=56, ac_dim=28)
    learner = JTRPO(jenv, jpol, JConfig(horizon=HORIZON, num_envs=B,
                                        g_step=1))
    js0 = learner.init(jax.random.PRNGKey(21))
    js1, jstats = learner.iteration(js0)

    tenv = DPEnvV3(clip="walk", device="cpu")
    tlearner = trpo.TRPO(tenv, MlpPolicy(ob_dim=56, ac_dim=28),
                         trpo.TRPOConfig(horizon=HORIZON, num_envs=B,
                                         g_step=1))
    np0 = jax.tree.map(np.asarray, js0)
    draws = ReplayDraws(js0.key, js0.env_state.key, jenv)
    ts0 = checkpoint.from_numpy_state(np0, draws, "cpu")
    ts1, tstats = tlearner.iteration(ts0)
    return jax.tree.map(np.asarray, (js1, jstats)), (ts1, tstats), tlearner


def test_iteration_episodes_match_jax(iteration):
    """Each step's done flags and the returns and lengths of the episodes
    that ended are equal (alive reward: returns count steps); at least one
    env finished and was reset inside the segment."""
    (_, jstats), (_, tstats), _ = iteration
    np.testing.assert_array_equal(tstats.ep_lens.numpy(), jstats.ep_lens)
    np.testing.assert_allclose(tstats.ep_rets.numpy(), jstats.ep_rets,
                               atol=1e-4)
    assert int(tstats.ep_count) == int(jstats.ep_count) >= 1
    for k in ("ep_ret_sum", "ep_len_sum", "ep_count", "timesteps",
              "ep_len_sum_last"):
        np.testing.assert_allclose(float(getattr(tstats, k)),
                                   float(getattr(jstats, k)), rtol=1e-6)


def test_iteration_final_env_state_matches_jax(iteration):
    """After 40 steps (resets included) obs within 1e-3 (the evaluation's
    budget: 20-step qpos agreement ~3e-7, amplified in the velocities), and
    the episode accounting equal."""
    (js1, _), (ts1, _), _ = iteration
    np.testing.assert_allclose(ts1.env_state.obs.numpy(), js1.env_state.obs,
                               atol=1e-3)
    np.testing.assert_allclose(ts1.env_state.qpos.numpy(),
                               js1.env_state.qpos, atol=1e-3)
    np.testing.assert_array_equal(ts1.new.numpy(), js1.new)
    np.testing.assert_array_equal(ts1.cur_ep_len.numpy(), js1.cur_ep_len)
    np.testing.assert_array_equal(ts1.env_state.step_count.numpy(),
                                  js1.env_state.step_count)


def test_iteration_params_and_stats_match_jax(iteration):
    """New policy params within 1e-4 (the update sees obs that differ by
    up to 1e-3 in their fastest velocities; a step size halved once more
    would move them by ~1e-2), vf within 1e-3, ob_rms within 1e-4, the
    losses and ev within 1e-3 (relative to max(1, |x|))."""
    (js1, jstats), (ts1, tstats), _ = iteration
    _close(_port_flat(ts1.params), _jax_flat(js1.params), 1e-4)
    jvf = np.concatenate([np.ravel(layer[k]) for layer in js1.params["vf"]
                          for k in ("b", "w")])
    _close(trpo.flatten(trpo.vf_leaves(ts1.params)), jvf, 1e-3)
    for o, r in zip(ts1.params["ob_rms"], js1.params["ob_rms"]):
        _close(o, r, 1e-4)
    for k in ("optimgain", "meankl", "entloss", "surrgain", "entropy",
              "ev_tdlam_before"):
        _close(getattr(tstats, k), getattr(jstats, k), 1e-3)
    assert 0 < float(tstats.meankl) <= 0.015


# ---------------------------------------------------------------------------
# checkpoints


def test_port_checkpoint_loads_in_jax_strictly_and_reads_back(iteration,
                                                             tmp_path):
    """A checkpoint the port writes loads through the JAX package's
    ``checkpoint.load`` into a fresh ``TRPOState`` under the strict
    structure check, with JAX's dtypes; its policy and Adam leaves equal
    the port's.  It reads back through ``load_trpo_params`` and
    ``load_trpo_state``."""
    _, (ts1, _), tlearner = iteration
    path = checkpoint.save(str(tmp_path / "trpo_state"), ts1)
    like = JTRPO(JaxDPEnvV3(clip="walk"), JaxMlpPolicy(ob_dim=56, ac_dim=28),
                 JConfig(num_envs=8)).init(jax.random.PRNGKey(0))
    js = jcheckpoint.load(path, like)
    for a, b in zip(jax.tree.leaves(js), jax.tree.leaves(like)):
        assert (np.asarray(a).dtype, np.shape(a)) == (np.asarray(b).dtype,
                                                      np.shape(b))
    np.testing.assert_array_equal(_jax_flat(js.params),
                                  _port_flat(ts1.params))
    for o, r in zip(ts1.vf_adam, js.vf_adam):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    keys = np.asarray(js.env_state.key)
    assert len({tuple(k) for k in keys} | {tuple(np.asarray(js.key))}) == 9

    params = checkpoint.load_trpo_params(path, tlearner.policy, "cpu")
    np.testing.assert_array_equal(_port_flat(params), _port_flat(ts1.params))
    back = checkpoint.load_trpo_state(path, tlearner, trpo.Draws(None))
    for f in ("qpos", "qvel", "obs", "done", "step_count", "mocap_idx"):
        torch.testing.assert_close(getattr(back.env_state, f),
                                   getattr(ts1.env_state, f), rtol=0, atol=0)
    for a, b in ((back.new, ts1.new), (back.cur_ep_len, ts1.cur_ep_len),
                 (back.cur_ep_ret, ts1.cur_ep_ret),
                 *zip(back.vf_adam, ts1.vf_adam)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_train_resumed_from_a_checkpoint_continues_from_it(iteration,
                                                          tmp_path):
    """``train(resume_from=...)`` starts from the saved state: its first
    iteration receives the saved params, env state, episode accounting and
    Adam moments, and moves the policy from there."""
    _, (ts1, _), _ = iteration
    path = checkpoint.save(str(tmp_path / "saved"), ts1)
    env = DPEnvV3(clip="walk", device="cpu")
    learner = trpo.TRPO(env, MlpPolicy(ob_dim=56, ac_dim=28),
                        trpo.TRPOConfig(horizon=16, num_envs=8, g_step=1))
    seen = []
    run = learner.iteration
    learner.iteration = lambda state: seen.append(state) or run(state)
    out = train_loop.train(learner, seed=1, max_iters=1,
                           ckpt_dir=str(tmp_path / "run"), resume_from=path,
                           verbose=False)
    first = seen[0]
    np.testing.assert_array_equal(_port_flat(first.params),
                                  _port_flat(ts1.params))
    for a, b in ((first.env_state.qpos, ts1.env_state.qpos),
                 (first.cur_ep_len, ts1.cur_ep_len), (first.new, ts1.new),
                 *zip(first.vf_adam, ts1.vf_adam)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float(out.vf_adam.t) == float(ts1.vf_adam.t) + 3  # 128 rows
    assert not np.array_equal(_port_flat(out.params), _port_flat(ts1.params))


def test_train_logs_the_jax_loops_keys(tmp_path, capsys):
    env = DPEnvV3(clip="walk", device="cpu")
    learner = trpo.TRPO(env, MlpPolicy(ob_dim=56, ac_dim=28),
                        trpo.TRPOConfig(horizon=16, num_envs=4, g_step=1))
    train_loop.train(learner, max_iters=2, log_dir=str(tmp_path))
    with open(tmp_path / "progress.csv") as fh:
        header = fh.readline().strip().split(",")
    assert sorted(header) == sorted([
        "optimgain", "meankl", "entloss", "surrgain", "entropy",
        "ev_tdlam_before", "EpLenMean", "EpRewMean", "EpThisIter",
        "EpisodesSoFar", "TimestepsSoFar", "RefCountedSteps", "TimeElapsed"])
    with open(tmp_path / "monitor.json.monitor.csv") as fh:
        assert json.loads(fh.readline()[1:])["env_id"] == "dp_env_v3"
        assert fh.readline().strip() == "r,l,t"
    assert "| meankl" in capsys.readouterr().out
    with pytest.raises(ValueError, match="exactly one"):
        train_loop.train(learner, max_iters=1, max_timesteps=5)
