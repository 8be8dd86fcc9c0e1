"""The port's original DeepMimic learning stack (``deepmimic_mujoco_torch/
dp_policy/``, ``utils/arg_parser.py``, the dp-policy params of
``io_utils/checkpoint.py``, ``cli/train_ppo.py`` and ``cli/get_action.py``)
against the JAX package on the CPU.

Inputs are numpy arrays from a seed, JAX-initialised params and the
bundled r5 run's params (``train_ckpt_dp_ppo_r5``), handed to both stacks
through the checkpoint files; JAX's random draws (ε-coins, action noise,
resets, test starts, minibatch indices, epoch permutations) are replayed
through the port's seam (``tests/torch_replay.py``).  The JAX side jits two
physics program: the driver's rollout chunk on the walk surface with a
6-step cap; the driver on the non-looping kick clip and its test episodes
run a cheap map in place of the physics in both stacks.  Tolerances are
stated per test."""

import glob
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepmimic_mujoco_tpu.dp_policy import normalizer as jnorm
from deepmimic_mujoco_tpu.dp_policy.exp_params import ExpParams as JExpParams
from deepmimic_mujoco_tpu.dp_policy.path import Path as JPath
from deepmimic_mujoco_tpu.dp_policy.pg_agent import PGAgent as JPGAgent
from deepmimic_mujoco_tpu.dp_policy.ppo_agent import PPOAgent as JPPOAgent
from deepmimic_mujoco_tpu.dp_policy.replay_buffer import (
    ReplayBuffer as JReplayBuffer,
)
from deepmimic_mujoco_tpu.dp_policy.rl_agent import RLAgentDriver as JDriver
from deepmimic_mujoco_tpu.envs import deepmimic_surface as jsurf
from deepmimic_mujoco_tpu.io_utils import checkpoint as jax_checkpoint
from deepmimic_mujoco_tpu.utils.arg_parser import ArgParser as JArgParser
from deepmimic_mujoco_torch.cli import get_action, train_ppo
from deepmimic_mujoco_torch.dp_policy import normalizer
from deepmimic_mujoco_torch.dp_policy.exp_params import ExpParams
from deepmimic_mujoco_torch.dp_policy.path import Path
from deepmimic_mujoco_torch.dp_policy.pg_agent import PGAgent
from deepmimic_mujoco_torch.dp_policy.ppo_agent import (
    PPOAgent,
    td_lambda_targets,
)
from deepmimic_mujoco_torch.dp_policy.replay_buffer import ReplayBuffer
from deepmimic_mujoco_torch.dp_policy.rl_agent import RLAgentDriver
from deepmimic_mujoco_torch.dp_policy.rl_world import ActionGiver
from deepmimic_mujoco_torch.envs import deepmimic_surface as tsurf
from deepmimic_mujoco_torch.io_utils import checkpoint
from deepmimic_mujoco_torch.utils.arg_parser import ArgParser
from tests.torch_replay import AgentReplayDraws, DriverReplayDraws

torch.set_num_threads(1)

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
R5 = os.path.join(ROOT, "train_ckpt_dp_ppo_r5", "deepmimic", "ppo-walk-0",
                  "ppo_params.npz")
R5_LOG = os.path.join(ROOT, "train_logs_dp_ppo_r5", "deepmimic", "ppo-walk-0",
                      "progress.csv")
SPEC = {"BatchSize": 32, "MiniBatchSize": 16, "Epochs": 2}
CAP = 6       # the walk surface's step cap in the driver tests


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(out, ref, rel):
    """|out − ref| ≤ rel · max(1, max|ref|)."""
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    ref = np.asarray(ref, np.float64)
    err = float(np.abs(np.asarray(out, np.float64) - ref).max())
    assert err <= rel * max(1.0, float(np.abs(ref).max())), err


def _leaves(params):
    return checkpoint._dp_leaves(params)


def _close_params(tp, jp, rel, rel_opt):
    """Every leaf of the port's params within ``rel`` of JAX's, the
    momentum leaves (``actor_opt``, ``critic_opt``) within ``rel_opt``."""
    tl, jl = _leaves(tp), jax.tree.leaves(jp)
    assert len(tl) == len(jl) == 38
    momentum = set(range(10, 16)) | set(range(23, 29))
    for i, (a, b) in enumerate(zip(tl, jl)):
        _close(a, b, rel_opt if i in momentum else rel)


# ---------------------------------------------------------------------------
# the numpy copies


def _paths(rng, n):
    """``n`` (port Path, JAX Path) pairs holding the same random path of
    1-6 steps."""
    out = []
    for i in range(n):
        L = rng.randint(1, 7)
        data = dict(states=list(rng.randn(L + 1, 5).astype(np.float32)),
                    actions=list(rng.randn(L, 3).astype(np.float32)),
                    logps=list(rng.randn(L)), rewards=list(rng.rand(L)),
                    flags=list(rng.randint(0, 2, L)), terminate=i % 3)
        pair = (Path(), JPath())
        for P in pair:
            vars(P).update(data)
        out.append(pair)
    return out


def test_path_replay_buffer_exp_params_arg_parser_match_jax():
    """The numpy copies on the same inputs: a ring of 23 records filled
    past its end (wraparound) by paths of 1-6 steps with flags and
    terminates: every array of the ring, the head, the counts, the masks,
    the filtered indices and a seeded sample equal JAX's copy's after each
    store and after ``clear``; ``ExpParams`` and ``ArgParser`` on every arg
    file of ``assets/args`` equal."""
    tbuf, jbuf = ReplayBuffer(23), JReplayBuffer(23)
    for tp, jp in _paths(np.random.RandomState(0), 8):
        assert tp.is_valid() and tp.calc_return() == jp.calc_return()
        assert tbuf.store(tp) == jbuf.store(jp)
        for k in jbuf._store:
            np.testing.assert_array_equal(tbuf._store[k], jbuf._store[k])
        for k in ("_path_id", "_is_end", "_terminate", "_flags"):
            np.testing.assert_array_equal(getattr(tbuf, k), getattr(jbuf, k))
        for k in ("buffer_head", "total_count", "num_paths", "_used"):
            assert getattr(tbuf, k) == getattr(jbuf, k), k
        for m in ("end_mask", "fail_mask", "succ_mask"):
            np.testing.assert_array_equal(getattr(tbuf, m)(),
                                          getattr(jbuf, m)())
        np.testing.assert_array_equal(tbuf.flag_mask(1), jbuf.flag_mask(1))
        np.testing.assert_array_equal(tbuf.get_idx_filtered(1),
                                      jbuf.get_idx_filtered(1))
        assert tbuf.count_filtered(1) == jbuf.count_filtered(1)
        np.testing.assert_array_equal(
            tbuf.sample(7, rng=np.random.RandomState(4)),
            jbuf.sample(7, rng=np.random.RandomState(4)))
    assert tbuf.buffer_head < 23 and tbuf.total_count > 23  # it wrapped
    tbuf.clear(), jbuf.clear()
    assert tbuf.get_current_size() == jbuf.get_current_size() == 0
    np.testing.assert_array_equal(tbuf._path_id, jbuf._path_id)

    for d in ({"Rate": 1, "Noise": 0.05}, {}, {"Temp": 0.3}):
        e, je = ExpParams.from_json(d), JExpParams.from_json(d)
        assert e.lerp(ExpParams(), 0.3) == ExpParams(
            **vars(je.lerp(JExpParams(), 0.3)))

    files = sorted(glob.glob(os.path.join(ROOT, "assets", "args", "*.txt")))
    assert len(files) > 10
    for f in files:
        tp, jp = ArgParser(), JArgParser()
        tp.load_file(f), jp.load_file(f)
        assert tp._table == jp._table, f
        for key in tp._table:
            for m in ("parse_string", "parse_strings", "parse_bool",
                      "parse_bools"):
                assert getattr(tp, m)(key) == getattr(jp, m)(key)
    tp.load_args(["--a", "1", "2", "--b", "x", "--c"])
    assert tp.parse_ints("a") == [1, 2] and tp.parse_floats("a") == [1.0, 2.0]
    assert tp.parse_int("c", 7) == 7 and not tp.has_key("d")


def test_normalizer_with_groups_and_weights_matches_jax():
    """Groups MAIN, 1 and NONE (bypassed), a clip of 3: two weighted
    updates (0/1 row weights) and an unweighted one, then ``normalize``
    and ``unnormalize``, within 1e-6 of max(1, |x|) of JAX's."""
    rng = np.random.RandomState(5)
    groups = np.array([0, 0, 1, -1, 0, 1])
    t, j = (normalizer.make(6, groups, clip=3.0),
            jnorm.make(6, groups, clip=3.0))
    mean0, std0 = rng.randn(6).astype(np.float32), rng.rand(6).astype(
        np.float32) + 0.5
    ts = normalizer.init(6, mean0, std0)
    js = jnorm.init(6, init_mean=mean0, init_std=std0)
    for k in range(3):
        batch = (3 * rng.randn(40, 6) + 1).astype(np.float32)
        w = (rng.rand(40) < 0.6).astype(np.float32) if k < 2 else None
        ts = t.update(ts, _t(batch), weights=None if w is None else _t(w))
        js = j.update(js, jnp.asarray(batch),
                      weights=None if w is None else jnp.asarray(w))
        for a, b in zip(ts, js):
            _close(a, b, 1e-6)
    x = (4 * rng.randn(9, 6)).astype(np.float32)
    _close(t.normalize(ts, _t(x)), j.normalize(js, jnp.asarray(x)), 1e-6)
    _close(t.unnormalize(ts, _t(x)), j.unnormalize(js, jnp.asarray(x)), 1e-6)
    assert (t.normalize(ts, _t(x))[:, 3] == _t(x)[:, 3]).all()


# ---------------------------------------------------------------------------
# the agents


@pytest.fixture(scope="module")
def envs():
    return jsurf.DeepMimicSurfaceEnv(max_episode_steps=CAP), \
        tsurf.DeepMimicSurfaceEnv(max_episode_steps=CAP, device="cpu")


@pytest.fixture(scope="module")
def agents(envs):
    jenv, tenv = envs
    return (JPPOAgent.for_env(jenv, spec=SPEC),
            PPOAgent.for_env(tenv, spec=SPEC))


def test_params_structure_string_is_jax_s(agents):
    """The writer's structure string is ``str(jax.tree.structure(...))``
    of the JAX agent's ``init`` (PPO and PG), byte for byte."""
    jagent, _ = agents
    want = checkpoint.dp_ppo_params_treedef()
    assert str(jax.tree.structure(jagent.init(jax.random.PRNGKey(0)))) == want
    assert str(jax.tree.structure(
        JPGAgent(197, 36).init(jax.random.PRNGKey(1)))) == want


@pytest.fixture(scope="module", params=["jax_init", "r5"])
def params(request, agents, tmp_path_factory):
    """(JAX params, the port's): JAX's ``init(PRNGKey(3))`` or the r5 run's
    params (read by JAX's strict loader), carried across by the port's
    reader from a file JAX wrote; every leaf equal."""
    jagent, tagent = agents
    jp = jagent.init(jax.random.PRNGKey(3))
    if request.param == "r5":
        jp = jax_checkpoint.load(R5, jp)
    path = str(tmp_path_factory.mktemp("dp") / "p.npz")
    jax_checkpoint.save(path, jp)
    tp = checkpoint.load_dp_ppo_params(path, tagent, "cpu")
    for a, b in zip(_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    return jp, tp


def _states(tenv, n=16, seed=6):
    """Surface states of clip frames, jittered."""
    rng = np.random.RandomState(seed)
    st = tenv.reset_at(rng.randint(0, tenv.clip_len, n))
    return (st.obs.numpy() + 0.01 * rng.randn(n, 197)).astype(np.float32)


def test_decide_action_and_losses_match_jax(agents, params, envs):
    """``exp_params_at``, ``decide_action`` (JAX's normal draws replayed;
    exploring and non-exploring rows), ``get_action``, ``eval_critic`` and
    ``losses`` on 16 surface states within 1e-5 of max(1, |x|) of JAX's."""
    jagent, tagent = agents
    jp, tp = params
    s = _states(envs[1])
    rng = np.random.RandomState(7)
    exploring = np.arange(16) % 3 != 0
    keys = jax.random.split(jax.random.PRNGKey(8), 16)
    ja, jlogp = jax.vmap(lambda k, o, e: jagent.decide_action(jp, k, o, e))(
        keys, jnp.asarray(s), jnp.asarray(exploring))
    noise = jax.vmap(lambda k: jax.random.normal(k, (36,), jnp.float32))(keys)
    ta, tlogp = tagent.decide_action(tp, _t(s), _t(exploring), _t(noise))
    _close(ta, ja, 1e-5)
    _close(tlogp, jlogp, 1e-5)
    for x in (0.0, 1.9e7, 7e7):
        for a, b in zip(tagent.exp_params_at(torch.tensor(x)),
                        jagent.exp_params_at(jnp.float32(x))):
            assert float(a) == float(b)
    _close(tagent.get_action(tp, s), jagent.get_action(jp, s), 1e-5)
    _close(tagent.eval_critic(tp, _t(s)), jagent.eval_critic(jp, s), 1e-5)
    a, old = _acted(rng, tagent, tp, s)
    adv = rng.randn(16).astype(np.float32)
    tv = (5 * rng.rand(16)).astype(np.float32)
    out = tagent.losses(tp, *(_t(x) for x in (s, a, old, adv, tv)))
    ref = jagent.losses(jp, *(jnp.asarray(x) for x in (s, a, old, adv, tv)))
    for o, r in zip(out, ref):
        _close(o, r, 1e-5)


def _acted(rng, tagent, tp, states):
    """Actions the agent takes in ``states`` (exploring) and their logps,
    jittered, as a rollout would record them."""
    with torch.no_grad():
        a, lp = tagent.decide_action(tp, _t(states), torch.ones(
            len(states), dtype=torch.bool), _t(rng.randn(len(states), 36)
                                                .astype(np.float32)))
    return ((a.numpy() + 0.05 * rng.randn(*a.shape)).astype(np.float32),
            (lp.numpy() + 0.3 * rng.randn(len(states))).astype(np.float32))


def _path_batch(rng, tagent, tp, n_paths=6, pad=0):
    """A buffer in record layout: paths of 2-9 steps (n + 1 records each)
    ending FAIL, SUCC or NULL, exploring flags, then ``pad`` padding
    records."""
    ends, fail, succ = [], [], []
    for i in range(n_paths):
        L = rng.randint(2, 10)
        ends += [False] * L + [True]
        fail += [False] * L + [i % 3 == 1]
        succ += [False] * L + [i % 3 == 2]
    n = len(ends)
    states = (rng.randn(n + pad, 197)).astype(np.float32)
    actions, logps = _acted(rng, tagent, tp, states)
    rewards = rng.rand(n + pad).astype(np.float32)
    flags = rng.rand(n + pad) < 0.7
    valid = np.arange(n + pad) < n
    is_end = np.array(ends + [True] * pad)
    return dict(states=states, actions=actions, logps=logps, rewards=rewards,
                is_end=is_end, is_fail=np.array(fail + [False] * pad),
                is_succ=np.array(succ + [False] * pad),
                is_exp=flags & ~is_end & valid, valid=valid)


def _train_both(jagent, tagent, jp, tp, batch, seed):
    key = jax.random.PRNGKey(seed)
    jp1, jm = jagent.train_on_batch(
        jp, key, *(jnp.asarray(batch[k]) for k in (
            "states", "actions", "logps", "rewards", "is_end", "is_fail",
            "is_succ", "is_exp")), 2, valid=jnp.asarray(batch["valid"]))
    tp1, tm = tagent.train_on_batch(
        tp, AgentReplayDraws(key), *(_t(batch[k]) for k in (
            "states", "actions", "logps", "rewards", "is_end", "is_fail",
            "is_succ", "is_exp")), 2, valid=_t(batch["valid"]))
    return jp1, jm, tp1, tm


def test_train_on_batch_matches_jax(agents, params):
    """``train_on_batch`` on a padded buffer (6 paths ending FAIL, SUCC and
    NULL, 40 padding records; 2 epochs × 2 minibatches of 16 rows, JAX's
    ``jax.random.choice`` indices replayed): the metrics (in JAX's sorted
    key order) within 1e-4 of max(1, |x|), every parameter, normalizer and
    the sample count within 1e-4, the momentum within 1e-3 (it holds raw
    gradients); the sample count grows by the valid non-end records."""
    jagent, tagent = agents
    jp, tp = params
    batch = _path_batch(np.random.RandomState(9), tagent, tp, pad=40)
    jp1, jm, tp1, tm = _train_both(jagent, tagent, jp, tp, batch, 10)
    assert list(tm) == list(jm) == sorted(jm)
    for k in jm:
        _close(tm[k], jm[k], 1e-4)
    _close_params(tp1, jp1, 1e-4, 1e-3)
    n_new = int((~batch["is_end"] & batch["valid"]).sum())
    assert float(tp1["sample_count"]) == float(
        np.float32(np.float32(tp["sample_count"]) + np.float32(n_new)))
    assert float(tp1["a_norm"].count) == float(tp["a_norm"].count)


@pytest.mark.parametrize("fault", [None, "jitter", "critic", "actor",
                                   "sample_count"])
def test_card_vs_cpu_param_check_catches_planted_faults(envs, fault):
    """``chip_smoke.dp_param_diff``, the smoke's card-vs-CPU check of the
    params, between two CPU runs of ``train_on_batch`` from the r5 params
    with the same minibatch indices: equal runs read 0 in every group; each
    fault ``chip_smoke.plant_fault`` plants in the second run goes over
    ``DP_PARAM_BOUNDS`` in the group that sees it (``steps`` for a skipped
    critic or actor momentum step, ``exact`` for 2 more samples counted).
    ``jitter`` moves the second run's actions by 2e-6 and logps by 1e-7 of
    max(1, max|x|), the card's distance from the CPU in the smoke's
    iteration: the actor's step moves most (its gradient divides the
    action's offset from the mean by the noise's variance), yet every
    group stays within its bound."""
    import chip_smoke
    from deepmimic_mujoco_torch.dp_policy.draws import Draws

    _, tenv = envs
    runs = []
    for planted in (None, fault):
        agent = PPOAgent.for_env(tenv, spec=SPEC)
        tp = checkpoint.load_dp_ppo_params(R5, agent, "cpu")
        batch = _path_batch(np.random.RandomState(9), agent, tp, pad=40)
        if planted == "jitter":
            rng = np.random.RandomState(1)
            for k, rel in (("actions", 2e-6), ("logps", 1e-7)):
                x = batch[k]
                batch[k] = (x + rel * max(1.0, np.abs(x).max())
                            * rng.randn(*x.shape)).astype(np.float32)
        elif planted:
            chip_smoke.plant_fault(agent, planted)
        p1, _ = agent.train_on_batch(
            tp, Draws(torch.Generator().manual_seed(10)),
            *(_t(batch[k]) for k in ("states", "actions", "logps", "rewards",
                                     "is_end", "is_fail", "is_succ",
                                     "is_exp")), 2, valid=_t(batch["valid"]))
        runs.append((tp, p1))
    (p0, ref), (_, p1) = runs
    d = chip_smoke.dp_param_diff(p0, p1, ref)
    over = {k for k, b in chip_smoke.DP_PARAM_BOUNDS.items() if d[k] > b}
    if fault is None:
        assert (d["exact"], d["leaves"], d["steps"]) == (0.0, 0.0, 0.0)
    elif fault == "jitter":
        assert not over and d["exact"] == 0.0 and d["steps"] > 0.0
        assert d["worst"]["steps"].startswith("actor[")
    elif fault == "sample_count":
        assert over == {"exact"} and d["worst"]["exact"] == "sample_count"
    else:
        assert "steps" in over and d["worst"]["steps"].startswith(fault)


def test_td_lambda_scan_matches_jax_scan():
    """The host scan over distances against JAX's ``lax.scan`` body of
    ``train_on_batch`` on a 37,120-record padded buffer (the smoke's size
    at 512 envs: paths of 1-300 steps, 2,000 padding ends): within 1e-5 of
    max(1, |x|)."""
    rng = np.random.RandomState(11)
    ends = []
    while len(ends) < 35_000:
        ends += [False] * rng.randint(1, 300) + [True]
    ends = np.array(ends[:35_120] + [True] * 2_000)
    ends[35_119] = True
    vals = (20 * rng.rand(ends.size)).astype(np.float32)
    rewards = rng.rand(ends.size).astype(np.float32)
    vnext = np.append(vals[1:], vals[-1:])

    def body(carry, xs):
        v, v_n, r, end = xs
        ret = jnp.where(end, v, r + 0.95 * ((1 - 0.95) * v_n + 0.95 * carry))
        return ret, ret

    _, ref = jax.lax.scan(body, jnp.zeros((), jnp.float32),
                          (vals, vnext, rewards, ends), reverse=True)
    out = td_lambda_targets(vals, vnext, rewards, ends, 0.95, 0.95)
    _close(out, ref, 1e-5)


def test_update_and_compute_new_vals_match_jax(agents, params):
    """``PPOAgent.update`` on a 40-step path-structured batch (2 epochs ×
    2 minibatches, JAX's permutations replayed) and its
    ``compute_new_vals``: targets within 1e-5, metrics within 1e-4,
    params within 1e-4 (momentum 1e-3)."""
    jagent, tagent = agents
    jp, tp = params
    rng = np.random.RandomState(12)
    states = rng.randn(41, 197).astype(np.float32)
    actions, logps = _acted(rng, tagent, tp, states[:-1])
    rewards = rng.rand(40).astype(np.float32)
    path_end = rng.rand(40) < 0.15
    vals = (10 * rng.rand(41)).astype(np.float32)
    _close(tagent.compute_new_vals(_t(rewards), _t(vals), _t(path_end)),
           jagent.compute_new_vals(jnp.asarray(rewards), jnp.asarray(vals),
                                   jnp.asarray(path_end)), 1e-5)
    key = jax.random.PRNGKey(13)
    jp1, jm = jagent.update(jp, key, *(jnp.asarray(x) for x in (
        states, actions, logps, rewards, path_end)))
    tp1, tm = tagent.update(tp, AgentReplayDraws(key), *(_t(x) for x in (
        states, actions, logps, rewards, path_end)))
    for k in jm:
        _close(tm[k], jm[k], 1e-4)
    _close_params(tp1, jp1, 1e-4, 1e-3)


def test_pg_agent_train_on_batch_matches_jax(params):
    """``PGAgent`` (the advantage-weighted regression): one
    ``train_on_batch`` as in the PPO test, clip_frac 0."""
    jp, tp = params
    jagent, tagent = JPGAgent(197, 36, spec=SPEC), PGAgent(197, 36, spec=SPEC)
    batch = _path_batch(np.random.RandomState(14), tagent, tp, pad=8)
    jp1, jm, tp1, tm = _train_both(jagent, tagent, jp, tp, batch, 15)
    for k in jm:
        _close(tm[k], jm[k], 1e-4)
    assert float(tm["clip_frac"]) == 0.0
    _close_params(tp1, jp1, 1e-4, 1e-3)


# ---------------------------------------------------------------------------
# the driver


def _snapshot(driver) -> dict:
    """Records the buffer as the train step finds it (it clears it)."""
    rec, train = {}, driver._train

    def wrapped(params):
        buf = driver.replay_buffer
        n = buf.get_current_size()
        rec.update({k: buf.get_all(k).copy() for k in (
            "states", "actions", "logps", "rewards")})
        rec.update(end=buf.end_mask(), terminate=buf._terminate[:n].copy(),
                   flags=buf._flags[:n].copy(),
                   path_id=buf._path_id[:n].copy())
        return train(params)

    driver._train = wrapped
    return rec


def _drivers(jenv, tenv, jagent, tagent, B, chunk, reset_seed=1):
    """Both drivers (JAX's seed 0) and their start states, JAX's RSI from
    ``PRNGKey(reset_seed)`` (the CLI's ``seed + 1``)."""
    jdrv = JDriver(jenv, jagent, num_envs=B, seed=0, chunk=chunk)
    js0 = jax.vmap(jenv.reset)(jax.random.split(
        jax.random.PRNGKey(reset_seed), B))
    tdrv = RLAgentDriver(tenv, tagent, num_envs=B, chunk=chunk,
                         draws=DriverReplayDraws(jdrv._key, js0.key, jenv,
                                                 tenv))
    return jdrv, js0, tdrv, tenv.reset_at(np.asarray(js0.init_idx))


def _check_buffers(trec, jrec):
    for k in ("end", "terminate", "flags", "path_id"):
        np.testing.assert_array_equal(trec[k], jrec[k], err_msg=k)
    for k, tol in (("states", 1e-4), ("actions", 1e-4), ("logps", 1e-4),
                   ("rewards", 1e-5)):
        _close(trec[k], jrec[k], tol)


@pytest.fixture(scope="module")
def driver_run(envs, agents):
    """One ``train_iteration`` of both drivers on the walk surface (8 envs,
    chunks of 8 steps, a 6-step cap, the r5 params, SPEC), JAX's draws
    replayed, with each buffer recorded before the train step."""
    jenv, tenv = envs
    jagent, tagent = agents
    jp = jax_checkpoint.load(R5, jagent.init(jax.random.PRNGKey(0)))
    tp = checkpoint.load_dp_ppo_params(R5, tagent, "cpu")
    jdrv, js0, tdrv, ts0 = _drivers(jenv, tenv, jagent, tagent, 8, 8)
    jrec, trec = _snapshot(jdrv), _snapshot(tdrv)
    jp1, js1, jm = jdrv.train_iteration(jp, js0)
    tp1, ts1, tm = tdrv.train_iteration(tp, ts0)
    return dict(j=(jp1, js1, jm, jrec, jdrv), t=(tp1, ts1, tm, trec, tdrv),
                p0=(jp, tp))


def test_driver_train_iteration_matches_jax(driver_run):
    """The buffer's records as the train step finds them: path ids, end
    records, terminate labels and flags equal; states, actions and logps
    within 1e-4, rewards within 1e-5; the metrics (``avg_path_reward``
    included) within 1e-4; the params within 1e-4 (momentum 1e-3); the
    next env state's obs within 1e-4; ``Samples`` grew by the non-end
    records in f32."""
    jp1, js1, jm, jrec, jdrv = driver_run["j"]
    tp1, ts1, tm, trec, tdrv = driver_run["t"]
    _check_buffers(trec, jrec)
    assert trec["end"].sum() >= 8 and (trec["flags"] == 1).any()
    assert (trec["terminate"][trec["end"]] == 0).all()  # the cap: NULL
    assert list(tm) == list(jm)
    for k in jm:
        _close(tm[k], jm[k], 1e-4)
    _close_params(tp1, jp1, 1e-4, 1e-3)
    _close(ts1.obs, js1.obs, 1e-4)
    n_new = int((~trec["end"]).sum())
    s0 = driver_run["p0"][1]["sample_count"]
    assert float(tp1["sample_count"]) == float(
        np.float32(np.float32(s0) + np.float32(n_new)))
    assert tdrv.iter == jdrv.iter == 1


def _jfake(model, qp, qv, target, kp, kd, n_substeps=1):
    """A cheap stand-in for ``engine.step_pd`` (``test_torch_dp_surface``'s):
    the root pushed forward and, past x = 0.5, down by 0.2 per step."""
    drop = jnp.where(qp[0] > 0.5, 0.2, 0.0)
    return (qp.at[7:].set(0.5 * qp[7:] + 0.5 * target).at[0].add(0.02)
            .at[2].add(-drop), 0.9 * qv)


def _tfake(qp, qv, target):
    drop = torch.where(qp[:, 0] > 0.5, 0.2, 0.0)
    return (torch.cat([qp[:, :1] + 0.02, qp[:, 1:2],
                       qp[:, 2:3] - drop[:, None], qp[:, 3:7],
                       0.5 * qp[:, 7:] + 0.5 * target], dim=1), 0.9 * qv)


@pytest.fixture(scope="module")
def kick_run(agents):
    """Both drivers on the non-looping kick clip (47 frames; ``alive``
    reward, a 6-step cap) with the physics replaced by the same cheap map:
    one ``train_iteration`` (8 envs × chunks of 8, the r5 params, SPEC,
    buffers recorded), then ``test_episodes`` of 4 episodes × horizon 10,
    the port's env steps counted."""
    jagent, tagent = agents
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsurf, "engine", types.SimpleNamespace(step_pd=_jfake))
        jenv = jsurf.DeepMimicSurfaceEnv(clip="kick", reward_mode="alive",
                                         max_episode_steps=CAP)
        tenv = tsurf.DeepMimicSurfaceEnv(clip="kick", reward_mode="alive",
                                         max_episode_steps=CAP, device="cpu")
        tenv._dynamics = _tfake
        jp = jax_checkpoint.load(R5, jagent.init(jax.random.PRNGKey(0)))
        tp = checkpoint.load_dp_ppo_params(R5, tagent, "cpu")
        # starts at frames 46 and 41-42 (the clip ends) and 3-10 (x < 0.2)
        jdrv, js0, tdrv, ts0 = _drivers(jenv, tenv, jagent, tagent, 8, 8,
                                        reset_seed=2)
        jrec, trec = _snapshot(jdrv), _snapshot(tdrv)
        jp1, _, jm = jdrv.train_iteration(jp, js0)
        tp1, _, tm = tdrv.train_iteration(tp, ts0)
        steps, step = [], tenv.step
        tenv.step = lambda st, a: steps.append(1) or step(st, a)
        test = (jdrv.test_episodes(jp1, n_episodes=4, horizon=10),
                tdrv.test_episodes(tp1, n_episodes=4, horizon=10))
    return dict(j=(jp1, jm, jrec), t=(tp1, tm, trec, tdrv), test=test,
                steps=len(steps))


def test_driver_labels_succ_fail_null_like_jax(kick_run):
    """On the kick clip paths end by the clip's end (SUCC, through the
    env's scaled cursor), by a fall (FAIL) and by the cap (NULL), all three
    present; the buffer, the metrics and the params as in the walk test's
    tolerances."""
    jp1, jm, jrec = kick_run["j"]
    tp1, tm, trec, _ = kick_run["t"]
    _check_buffers(trec, jrec)
    labels = set(trec["terminate"][trec["end"]].tolist())
    assert labels == {0, 1, 2}, labels
    for k in jm:
        _close(tm[k], jm[k], 1e-4)
    _close_params(tp1, jp1, 1e-4, 1e-3)


def test_test_episodes_match_jax_with_early_stop(kick_run):
    """``test_episodes`` of 4 episodes × horizon 10 after the train step
    (JAX's starts replayed): every episode ends at the 6-step cap or
    earlier, so the port stops at step 6 at the latest while JAX scans all
    10; the average return and length equal JAX's (within 1e-4)."""
    (jret, jlen), (tret, tlen) = kick_run["test"]
    assert abs(tret - jret) <= 1e-4 * max(1.0, abs(jret))
    assert tlen == jlen and tlen <= CAP and kick_run["steps"] <= CAP
    assert kick_run["t"][3].test_lengths.shape == (4,)


# ---------------------------------------------------------------------------
# checkpoints and the CLIs


def test_r5_checkpoint_both_ways(agents, envs, tmp_path):
    """The r5 file read by both stacks gives equal ``get_action`` on 16
    surface states (within 1e-5); the port's ``save`` of it is the same
    file (every leaf and the structure string byte for byte) and JAX's
    strict loader takes it; the port's reader refuses a TRPO checkpoint."""
    jagent, tagent = agents
    jp = jax_checkpoint.load(R5, jagent.init(jax.random.PRNGKey(0)))
    tp = checkpoint.load_dp_ppo_params(R5, tagent, "cpu")
    s = _states(envs[1], seed=16)
    _close(tagent.get_action(tp, s), jagent.get_action(jp, s), 1e-5)
    path = checkpoint.save(str(tmp_path / "ppo_params"), tp)
    with np.load(R5) as a, np.load(path) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and (a[k] == b[k]).all(), k
    back = jax_checkpoint.load(path, jagent.init(jax.random.PRNGKey(1)))
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    with pytest.raises(ValueError, match="original-stack PPO"):
        checkpoint.load_dp_ppo_params(
            os.path.join(ROOT, "train_ckpt", "DPEnvV3", "trpo-walk-0",
                         "trpo_state.npz"), tagent, "cpu")


def test_cli_trains_both_surfaces_and_resumes(tmp_path, agents):
    """``cli.train_ppo --device cpu`` for 2 iterations at 4 envs with a
    small spec on the deepmimic surface (a test at iteration 2) and on v3:
    the tabular keys are those of the r5 run's ``progress.csv``, in its
    order; ``ppo_params.npz`` loads in JAX strictly; ``--resume`` from the
    first run starts from its params (its ``Samples`` continue)."""
    spec = tmp_path / "spec.json"
    spec.write_text('{"BatchSize": 24, "MiniBatchSize": 8}')
    with open(R5_LOG) as f:
        header = f.readline().strip().split(",")
    common = ["--device", "cpu", "--num-envs", "4", "--num-iters", "2",
              "--agent-spec", str(spec), "--max-episode-steps", "12",
              "--log-dir", str(tmp_path / "logs")]
    runs = {}
    for surface, extra in (("deepmimic", ["--test-every", "2"]),
                           ("v3", ["--save-every", "1"])):
        ck = tmp_path / surface
        train_ppo.main(common + ["--surface", surface,
                                 "--checkpoint-dir", str(ck)] + extra)
        with open(tmp_path / "logs" / surface / "ppo-walk-0"
                  / "progress.csv") as f:
            runs[surface] = [r.strip().split(",") for r in f]
        runs[surface + "_ckpt"] = str(ck / surface / "ppo-walk-0"
                                      / "ppo_params.npz")
    assert runs["deepmimic"][0] == header
    assert runs["v3"][0] == [k for k in header if not k.startswith("Test_")]
    jagent, _ = agents
    jp = jax_checkpoint.load(runs["deepmimic_ckpt"],
                             jagent.init(jax.random.PRNGKey(0)))
    samples = float(runs["deepmimic"][-1][header.index("Samples")])
    assert float(jp["sample_count"]) == samples > 0
    train_ppo.main(common + ["--num-iters", "1", "--resume",
                             runs["deepmimic_ckpt"], "--seed", "1",
                             "--checkpoint-dir", str(tmp_path / "resumed")])
    with open(tmp_path / "logs" / "deepmimic" / "ppo-walk-1"
              / "progress.csv") as f:
        row = dict(zip(*[r.strip().split(",") for r in f]))
    assert float(row["Samples"]) > samples


def test_get_action_cli(capsys):
    """``cli.get_action --device cpu`` with the walk run's arg file
    (``--model_files none``: a fresh agent from the spec file) and with the
    default spec: 36 actions, "shape: (36,)" printed; ``ActionGiver``
    agrees."""
    arg_file = os.path.join(ROOT, "assets", "args",
                            "run_humanoid3d_walk_args.txt")
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        ac = get_action.main(["--device", "cpu", "--arg-file", arg_file])
        giver = ActionGiver(arg_file, device="cpu")
    finally:
        os.chdir(cwd)
    assert ac.shape == (36,) and "shape: (36,)" in capsys.readouterr().out
    np.testing.assert_array_equal(giver.get_ac(np.zeros(197)), ac)
    assert get_action.main(["--device", "cpu"]).shape == (36,)


@pytest.mark.slow
def test_r5_evaluation_matches_jax():
    """The r5 policy in TEST mode against JAX's ``test_episodes``: 16
    episodes × horizon 512 from JAX's starts (seed 0), then the smoke's
    first 64 RSI frames (``chip_smoke.dp_frames()``) × horizon 300 in both
    stacks.  Prints the figures the smoke and PERF.md §6 carry; both
    within 0.03 reward per step and 10% of length of JAX's, and the
    port's 64-episode figure is the smoke's ``CPU_DP``.
    ``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_dp_policy.py -m
    slow -s``."""
    import chip_smoke

    jenv, tenv = jsurf.DeepMimicSurfaceEnv(), tsurf.DeepMimicSurfaceEnv(
        device="cpu")
    jagent, tagent = JPPOAgent.for_env(jenv), PPOAgent.for_env(tenv)
    jp = jax_checkpoint.load(R5, jagent.init(jax.random.PRNGKey(0)))
    tp = checkpoint.load_dp_ppo_params(R5, tagent, "cpu")
    jdrv, js0, tdrv, _ = _drivers(jenv, tenv, jagent, tagent, 16, 32)
    jret, jlen = jdrv.test_episodes(jp, n_episodes=16, horizon=512)
    tret, tlen = tdrv.test_episodes(tp, n_episodes=16, horizon=512)
    print(f"\n16 episodes x 512, JAX's starts: JAX Test_Return {jret:.4f} "
          f"Test_Length {jlen:.4f}; the port {tret:.4f} {tlen:.4f}")
    assert abs(tret / tlen - jret / jlen) <= 0.03
    assert abs(tlen - jlen) <= 0.1 * jlen

    frames = chip_smoke.dp_frames()[:64]
    tdrv.draws.test_starts = lambda reset_fn, n: tenv.reset_at(frames)
    tdrv.test_episodes(tp, n_episodes=64, horizon=300)
    t_ret, t_len = tdrv.test_returns.numpy(), tdrv.test_lengths.numpy()

    # JAX's test_episodes scan (deepmimic_mujoco_tpu/dp_policy/rl_agent.py:
    # test_episodes) from the same starts
    def step_fn(carry, _):
        st, alive, ret, length = carry
        nxt = jax.vmap(jenv.step)(st, jax.vmap(
            lambda o: jagent.get_action(jp, o))(st.obs))
        ret = ret + jnp.where(alive, nxt.reward, 0.0)
        length = length + jnp.where(alive, 1, 0)
        st = jax.tree.map(lambda new, old: jnp.where(
            alive.reshape((-1,) + (1,) * (new.ndim - 1)), new, old), nxt, st)
        return (st, alive & ~nxt.done, ret, length), None

    start = jax.vmap(jenv.reset_at, in_axes=(None, 0))(
        jax.random.PRNGKey(0), jnp.asarray(frames))
    (_, _, j_ret, j_len), _ = jax.jit(lambda s0: jax.lax.scan(
        step_fn, (s0, jnp.ones(64, bool), jnp.zeros(64), jnp.zeros(64,
                                                                  jnp.int32)),
        None, length=300))(start)
    j_ret, j_len = np.asarray(j_ret), np.asarray(j_len)
    print(f"64 smoke frames x 300: the port's CPU reward per step "
          f"{t_ret.sum() / t_len.sum():.4f}, mean length {t_len.mean():.2f}; "
          f"JAX's CPU {j_ret.sum() / j_len.sum():.4f}, {j_len.mean():.2f}")
    assert abs(t_ret.sum() / t_len.sum() - j_ret.sum() / j_len.sum()) <= 0.03
    assert abs(t_len.mean() - j_len.mean()) <= 0.1 * j_len.mean()
    assert (abs(t_ret.sum() / t_len.sum() - chip_smoke.CPU_DP[0]) <= 5e-5
            and abs(t_len.mean() - chip_smoke.CPU_DP[1]) <= 5e-3)
