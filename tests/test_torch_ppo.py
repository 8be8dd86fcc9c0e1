"""The port's vectorized PPO (``deepmimic_mujoco_torch/algos/ppo.py``, its
checkpoints, the train loop with a PPO learner) and the rest of the
distributions module against the JAX package on the CPU.

Inputs are numpy arrays from a seed or JAX's own ``init`` states, handed to
both stacks; JAX's random draws (action noise, noise resets, the epochs'
permutations) are replayed through the port's seam
(``tests/torch_replay.py``).  The JAX side jits two physics programs: its
``PPO.iteration`` with a learned logstd, and with a fixed logstd and
``lr_decay``.  Tolerances are stated per test."""

import numpy as np
import pytest
import torch

import jax
import jax.flatten_util
import jax.numpy as jnp

from deepmimic_mujoco_tpu.algos.ppo import PPO as JaxPPO
from deepmimic_mujoco_tpu.algos.ppo import PPOConfig as JaxPPOConfig
from deepmimic_mujoco_tpu.envs import DPEnvV3 as JaxDPEnvV3
from deepmimic_mujoco_tpu.io_utils import checkpoint as jax_checkpoint
from deepmimic_mujoco_tpu.models import MlpPolicy as JaxMlpPolicy
from deepmimic_mujoco_tpu.models import distributions as jdist
from deepmimic_mujoco_torch.algos import train_loop
from deepmimic_mujoco_torch.algos.ppo import PPO, PPOConfig, train_leaves
from deepmimic_mujoco_torch.algos.trpo import Draws, flatten
from deepmimic_mujoco_torch.cli import train_trpo
from deepmimic_mujoco_torch.envs.dp_env_v3 import DPEnvV3
from deepmimic_mujoco_torch.io_utils import checkpoint
from deepmimic_mujoco_torch.models import distributions as tdist
from deepmimic_mujoco_torch.models.policy import MlpPolicy
from tests.torch_replay import ReplayDraws, fresh_fn

torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(out, ref, rel):
    """|out − ref| ≤ rel · max(1, max|ref|)."""
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    ref = np.asarray(ref, np.float64)
    err = float(np.abs(np.asarray(out, np.float64) - ref).max())
    assert err <= rel * max(1.0, float(np.abs(ref).max())), err


# ---------------------------------------------------------------------------
# distributions

SIZES = (3, 5, 2)


def _dist_args(family, fn):
    rng = np.random.RandomState(0)
    n = {"categorical": 6, "bernoulli": 4,
         "multi_categorical": sum(SIZES)}[family]
    lp, lq = (2.0 * rng.randn(11, n)).astype(np.float32), (
        2.0 * rng.randn(11, n)).astype(np.float32)
    if family == "categorical":
        x = rng.randint(0, n, 11)
    elif family == "bernoulli":
        x = rng.randint(0, 2, (11, n))
    else:
        x = np.stack([rng.randint(0, s, 11) for s in SIZES], axis=-1)
    extra = (SIZES,) if family == "multi_categorical" else ()
    if fn == "neglogp":
        return ((lp,) + extra + (x,)) if extra else (lp, x)
    if fn == "kl":
        return (lp, lq) + extra
    return (lp,) + extra


@pytest.mark.parametrize("fn", ["neglogp", "kl", "entropy"])
@pytest.mark.parametrize("family", ["categorical", "bernoulli",
                                    "multi_categorical"])
def test_distributions_match_jax(family, fn):
    """logp, KL and entropy of each family over logits with entries up to
    ±8 against JAX's: 1e-5 of max(1, |x|)."""
    args = _dist_args(family, fn)
    ref = getattr(getattr(jdist, family), fn)(
        *(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args))
    out = getattr(getattr(tdist, family), fn)(
        *(_t(a) if isinstance(a, np.ndarray) else a for a in args))
    _close(out, ref, 1e-5)


@pytest.mark.parametrize("family", ["categorical", "bernoulli",
                                    "multi_categorical", "diag_gaussian"])
def test_samples_pass_validate_probtype(family):
    """The port's samplers against their own analytic entropy and KL
    (``validate_probtype``: 3 standard errors over 20,000 samples), and the
    categorical's mode against JAX's."""
    rng = np.random.RandomState(1)
    g = torch.Generator().manual_seed(2)
    if family == "diag_gaussian":
        m, s = _t(rng.randn(4).astype(np.float32)), _t(
            0.3 * rng.randn(4).astype(np.float32))
        m2 = m + 0.3
        d = tdist.diag_gaussian
        pa, pb = (m, s), (m2, s)
        sample = lambda gen, n: d.sample(gen, m.expand(n, 4), s.expand(n, 4))
        nlp = lambda p: (lambda x: d.neglogp(p[0], p[1], x))
        ent, kl = d.entropy(s), d.kl(m, s, m2, s)
    else:
        d = getattr(tdist, family)
        n = {"categorical": 5, "bernoulli": 3,
             "multi_categorical": sum(SIZES)}[family]
        la, lb = _t(rng.randn(n).astype(np.float32)), _t(
            rng.randn(n).astype(np.float32))
        extra = (SIZES,) if family == "multi_categorical" else ()
        sample = lambda gen, k: d.sample(gen, la.expand(k, n), *extra)
        nlp = lambda p: (lambda x: d.neglogp(p.expand(len(x), n), *extra,
                                             x))
        pa, pb = la, lb
        ent, kl = d.entropy(la, *extra), d.kl(la, lb, *extra)
    z = tdist.validate_probtype(sample, nlp(pa), nlp(pb), ent, kl, g,
                                n=20_000)
    assert all(v < 3.0 for v in z)
    if family == "categorical":
        logits = rng.randn(7, 5).astype(np.float32)
        np.testing.assert_array_equal(
            tdist.categorical.mode(_t(logits)).numpy(),
            np.asarray(jdist.categorical.mode(logits)))


def test_make_pdtype_matches_jax():
    """Dispatch on the space's class name, as JAX's, with no gym import."""
    def space(name, **kw):
        return type(name, (), {})() if not kw else type(
            name, (), kw)()

    cases = [space("Box", shape=(7,)), space("Discrete", n=4),
             space("MultiDiscrete", nvec=np.array([2, 3])),
             space("MultiBinary", n=5)]
    for sp in cases:
        fam, size, kind = tdist.make_pdtype(sp)
        jfam, jsize, jkind = jdist.make_pdtype(sp)
        assert (fam.__name__, size, kind) == (jfam.__name__, jsize, jkind)
    with pytest.raises(NotImplementedError):
        tdist.make_pdtype(space("Tuple"))
    with pytest.raises(NotImplementedError):
        tdist.make_pdtype(space("Box", shape=(2, 3)))


# ---------------------------------------------------------------------------
# the slice: one PPO.iteration on the walk physics

B, T = 8, 40
CASES = {"learned_logstd": dict(fixed=None, lr_decay=1.0, lr_scale=1.0),
         "fixed_logstd_lr_decay": dict(fixed=-1.0, lr_decay=0.9,
                                       lr_scale=0.5)}


@pytest.fixture(scope="module", params=list(CASES))
def iteration(request, tmp_path_factory):
    """One ``PPO.iteration`` (8 envs × 40 steps, 2 epochs × 4 minibatches
    of 80 rows, noise resets) of both stacks from JAX's ``init`` state
    (RSI starts), read by the port through ``load_ppo_state`` from JAX's
    own checkpoint file; the fixed-logstd case starts at ``lr_scale``
    0.5 with ``lr_decay`` 0.9."""
    case = CASES[request.param]
    jenv = JaxDPEnvV3(clip="walk")
    cfg = dict(horizon=T, num_envs=B, epochs=2, minibatches=4,
               lr_decay=case["lr_decay"])
    jlearner = JaxPPO(jenv, JaxMlpPolicy(ob_dim=56, ac_dim=28,
                                         fixed_logstd=case["fixed"]),
                      JaxPPOConfig(**cfg))
    js0 = jlearner.init(jax.random.PRNGKey(21))
    js0 = type(js0)(**{**vars(js0),
                       "lr_scale": jnp.asarray(case["lr_scale"],
                                               jnp.float32)})
    path = str(tmp_path_factory.mktemp("ppo") / "ppo0.npz")
    jax_checkpoint.save(path, js0)
    js1, jstats = jlearner.iteration(js0)

    tlearner = PPO(DPEnvV3(clip="walk", device="cpu"),
                   MlpPolicy(ob_dim=56, ac_dim=28,
                             fixed_logstd=case["fixed"]), PPOConfig(**cfg))
    draws = ReplayDraws(js0.key, js0.env_state.key, fresh_fn(jenv, "noise"))
    ts0 = checkpoint.load_ppo_state(path, tlearner, draws)
    ts1, tstats = tlearner.iteration(ts0)
    return (jax.tree.map(np.asarray, (js1, jstats)), (ts0, ts1, tstats),
            tlearner, case)


def _jflat(params):
    return np.asarray(jax.flatten_util.ravel_pytree(
        {"pol": params["pol"], "vf": params["vf"],
         "logstd": params["logstd"]})[0])


def test_iteration_rollout_matches_jax(iteration):
    """The rollout's episodes (at least one ends and is reset), the final
    env state (obs within 1e-3, the evaluation's budget) and the episode
    accounting."""
    (js1, jstats), (_, ts1, tstats), _, _ = iteration
    np.testing.assert_array_equal(tstats.ep_lens.numpy(), jstats.ep_lens)
    np.testing.assert_allclose(tstats.ep_rets.numpy(), jstats.ep_rets,
                               atol=1e-4)
    assert int(tstats.ep_count) == int(jstats.ep_count) >= 1
    assert tstats.ep_lens.shape == (1, T, B)
    np.testing.assert_allclose(ts1.env_state.obs.numpy(), js1.env_state.obs,
                               atol=1e-3)
    np.testing.assert_array_equal(ts1.cur_ep_len.numpy(), js1.cur_ep_len)
    np.testing.assert_array_equal(ts1.new.numpy(), js1.new)


def test_iteration_params_opt_and_stats_match_jax(iteration):
    """After 8 Adam steps of lr 3e-4 (or 1.5e-4): the flat {logstd, pol,
    vf} vector within 2e-4 of max(1, |x|) (the update sees obs that differ
    by up to 1e-3 in their fastest velocities, and Adam moves every entry
    by ~lr whatever its gradient's size), Adam's m within 1e-3 and v
    within 1e-5, t equal, ob_rms within 1e-4; the stats (the last
    minibatch's) within 1e-3; a frozen logstd unchanged; lr_scale decayed
    exactly as in JAX."""
    (js1, jstats), (ts0, ts1, tstats), _, case = iteration
    flat = flatten(train_leaves(ts1.params))
    _close(flat, _jflat(js1.params), 2e-4)
    assert np.abs(flat.numpy() - flatten(train_leaves(ts0.params)).numpy()
                  ).max() > 1e-4  # it moved
    (m, v, t), (jm, jv, jt) = ts1.opt, js1.opt
    _close(m, jm, 1e-3)
    _close(v, jv, 1e-5)
    assert float(t) == float(jt) == 8.0
    for o, r in zip(ts1.params["ob_rms"], js1.params["ob_rms"]):
        _close(o, r, 1e-4)
    for k in ("optimgain", "meankl", "entloss", "surrgain", "entropy",
              "ev_tdlam_before", "ep_ret_sum", "ep_len_sum",
              "ep_len_sum_last", "timesteps"):
        _close(getattr(tstats, k), getattr(jstats, k), 1e-3)
    assert float(ts1.lr_scale) == float(js1.lr_scale) == pytest.approx(
        case["lr_scale"] * case["lr_decay"])
    if case["fixed"] is not None:
        assert torch.equal(ts1.params["logstd"], ts0.params["logstd"])
        assert not ts1.opt.m[:28].any()


def test_port_ppo_checkpoint_loads_in_jax_strictly(iteration, tmp_path):
    """The port's PPO checkpoint loads through JAX's strict
    ``checkpoint.load`` into a fresh ``PPOState`` with JAX's dtypes and
    shapes and the port's values, and reads back through
    ``load_ppo_state`` and ``load_ppo_params``; the TRPO readers refuse
    it."""
    _, (_, ts1, _), tlearner, case = iteration
    path = checkpoint.save(str(tmp_path / "ppo_state"), ts1)
    like = JaxPPO(JaxDPEnvV3(clip="walk"),
                  JaxMlpPolicy(ob_dim=56, ac_dim=28,
                               fixed_logstd=case["fixed"]),
                  JaxPPOConfig(num_envs=B)).init(jax.random.PRNGKey(0))
    js = jax_checkpoint.load(path, like)
    for a, b in zip(jax.tree.leaves(js), jax.tree.leaves(like)):
        assert (np.asarray(a).dtype, np.shape(a)) == (np.asarray(b).dtype,
                                                      np.shape(b))
    np.testing.assert_array_equal(_jflat(js.params),
                                  flatten(train_leaves(ts1.params)).numpy())
    assert float(js.lr_scale) == float(ts1.lr_scale)
    back = checkpoint.load_ppo_state(path, tlearner, Draws(None))
    for a, b in (*zip(back.opt, ts1.opt), (back.lr_scale, ts1.lr_scale),
                 (back.env_state.qpos, ts1.env_state.qpos),
                 (back.cur_ep_len, ts1.cur_ep_len)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    params = checkpoint.load_ppo_params(path, tlearner.policy, "cpu")
    torch.testing.assert_close(params["vf"][2]["w"], ts1.params["vf"][2]["w"])
    with pytest.raises(ValueError, match="not a TRPOState"):
        checkpoint.load_trpo_params(path, tlearner.policy, "cpu")


def test_train_loop_resumes_a_ppo_run(iteration, tmp_path):
    """``train`` with a PPO learner resumed from a PPO checkpoint: the
    first iteration receives the saved params, Adam state and lr_scale;
    ``override_logstd`` sets the logstd after loading; the checkpoint it
    writes (``trpo_state.npz``, JAX's name) is a PPOState."""
    _, (_, ts1, _), _, case = iteration
    path = checkpoint.save(str(tmp_path / "saved"), ts1)
    learner = PPO(DPEnvV3(clip="walk", device="cpu"),
                  MlpPolicy(ob_dim=56, ac_dim=28, fixed_logstd=case["fixed"]),
                  PPOConfig(horizon=8, num_envs=B, epochs=1, minibatches=2,
                            lr_decay=case["lr_decay"]))
    seen = []
    run = learner.iteration
    learner.iteration = lambda state: seen.append(state) or run(state)
    out = train_loop.train(learner, seed=1, max_iters=1,
                           ckpt_dir=str(tmp_path / "run"), resume_from=path,
                           verbose=False, override_logstd=-0.5)
    first = seen[0]
    for a, b in (*zip(first.opt, ts1.opt), (first.lr_scale, ts1.lr_scale),
                 (first.params["vf"][0]["w"], ts1.params["vf"][0]["w"])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (first.params["logstd"] == -0.5).all()
    assert float(out.opt.t) == float(ts1.opt.t) + 2
    back = checkpoint.load_ppo_state(str(tmp_path / "run" / "trpo_state.npz"),
                                     learner, Draws(None))
    torch.testing.assert_close(back.lr_scale, out.lr_scale)


def test_cli_evaluates_a_ppo_checkpoint(tmp_path):
    """``--algo ppo --task evaluate`` reads the policy of a PPO checkpoint
    (alive reward: the return counts the steps)."""
    learner = PPO(DPEnvV3(clip="walk", device="cpu"),
                  MlpPolicy(ob_dim=56, ac_dim=28), PPOConfig(num_envs=2))
    path = checkpoint.save(str(tmp_path / "ppo"),
                           learner.init(torch.Generator().manual_seed(0)))
    res = train_trpo.main(["--algo", "ppo", "--task", "evaluate", "--device",
                           "cpu", "--eval-episodes", "2", "--eval-horizon",
                           "3", "--load-model-path", path])
    assert res.avg_len == 3.0 and res.avg_ret == 3.0
    with pytest.raises(ValueError, match="not a TRPOState"):
        train_trpo.main(["--task", "evaluate", "--device", "cpu",
                         "--load-model-path", path])
