"""Data-parallel training across processes (``deepmimic_mujoco_torch/
parallel`` and the learners' ``group``) against the JAX package on the CPU.

JAX runs its explicit collectives, ``shard_map`` with ``axis_name="env"`` on
2 of the conftest's 8 host devices, as ``tests/test_parallel.py`` runs
them; the port runs 2 gloo ranks spawned by ``parallel.mesh.launch``, one
launch for every learner's job (``tests/torch_dist_workers.py``, which
imports no JAX).  The two shards get different segments, made with numpy
from a seed.  JAX's replicated key gives both shards the same draws: they
are computed here, from the keys in JAX's split order, and fed to both
ranks.  Tolerances: the replicas within 1e-6 of each other; the port
within 1e-3 (absolute and relative) of JAX, as JAX's own
sharded-against-unsharded test allows.  The JAX side compiles one physics
program (the whole TRPO iteration)."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.flatten_util
import jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from deepmimic_mujoco_tpu.algos import adam as jadam
from deepmimic_mujoco_tpu.algos.gail import GAIL as JGAIL
from deepmimic_mujoco_tpu.algos.gail import GAILConfig as JGAILConfig
from deepmimic_mujoco_tpu.algos.gail import GAILState as JGAILState
from deepmimic_mujoco_tpu.algos.ppo import PPO as JPPO
from deepmimic_mujoco_tpu.algos.ppo import PPOConfig as JPPOConfig
from deepmimic_mujoco_tpu.algos.ppo import PPOState as JPPOState
from deepmimic_mujoco_tpu.algos.trpo import TRPO as JTRPO
from deepmimic_mujoco_tpu.algos.trpo import TRPOConfig as JConfig
from deepmimic_mujoco_tpu.algos.trpo import TRPOState as JTRPOState
from deepmimic_mujoco_tpu.dp_policy import normalizer as jnorm
from deepmimic_mujoco_tpu.dp_policy.ppo_agent import PPOAgent as JPPOAgent
from deepmimic_mujoco_tpu.envs import DPEnvV3 as JaxDPEnvV3
from deepmimic_mujoco_tpu.io_utils import checkpoint as jcheckpoint
from deepmimic_mujoco_tpu.models import MlpPolicy as JaxMlpPolicy
from deepmimic_mujoco_tpu.utils import running_stats as jrs
from deepmimic_mujoco_torch.algos import adam, trpo
from deepmimic_mujoco_torch.algos.gail import GAILConfig, disc_leaves
from deepmimic_mujoco_torch.algos.ppo import PPOConfig, train_leaves
from deepmimic_mujoco_torch.dp_policy.ppo_agent import PPOAgent
from deepmimic_mujoco_torch.io_utils import checkpoint
from deepmimic_mujoco_torch.models.policy import MlpPolicy
from deepmimic_mujoco_torch.parallel import dryrun, mesh
from deepmimic_mujoco_torch.utils.running_stats import RunningMeanStd
from tests import torch_dist_workers as W
from tests.torch_replay import fresh_fn, port_env_state

torch.set_num_threads(1)

WORLD = 2
REPLICA = 1e-6      # the ranks against each other
PARITY = 1e-3       # the port against JAX (atol and rtol)
T, B = 32, 8        # per-shard segment of the TRPO, PPO and GAIL jobs
SPEC = {"BatchSize": 32, "MiniBatchSize": 16, "Epochs": 2}
H_ITER = 8          # the whole iteration: 2 envs per rank x 8 steps
ITER_CFG = dict(horizon=H_ITER, num_envs=2, g_step=1, cg_iters=2, vf_iters=1,
                vf_batch_size=4, line_search_steps=2)


def _t(x):
    return torch.as_tensor(np.array(x))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _parity(out, ref):
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=PARITY,
                               rtol=PARITY)


def _replicas(a, b):
    np.testing.assert_allclose(_np(a), _np(b), atol=REPLICA, rtol=0)


def _jflat(tree):
    return np.asarray(jax.flatten_util.ravel_pytree(tree)[0])


def _pol(p):
    return trpo.flatten(trpo.policy_leaves(p))


def _vf(p):
    return trpo.flatten(trpo.vf_leaves(p))


def _segment(seed, T, B, ob_dim=56, ac_dim=28):
    rng = np.random.RandomState(seed)
    new = (rng.rand(T, B) < 0.1).astype(np.float32)
    new[0] = 1.0
    return {
        "ob": (0.5 + rng.randn(T, B, ob_dim)).astype(np.float32),
        "ac": rng.randn(T, B, ac_dim).astype(np.float32),
        "vpred": (0.1 * rng.randn(T, B)).astype(np.float32),
        "rew": (1.0 + 0.3 * rng.randn(T, B)).astype(np.float32),
        "new": new,
        "nextvpred": (0.1 * rng.randn(B)).astype(np.float32),
    }


def _stack(segs):
    return {k: jnp.asarray(np.stack([s[k] for s in segs])) for k in segs[0]}


def _perms(key, n, epochs):
    return np.stack([np.asarray(jax.random.permutation(k, n))
                     for k in jax.random.split(key, epochs)])


@pytest.fixture(scope="module")
def mesh2():
    return Mesh(np.asarray(jax.devices()[:WORLD]), ("env",))


def _smap(m, body, in_specs, out_specs):
    """``body`` under ``shard_map``, jitted (an eager ``shard_map`` runs
    its ops one by one)."""
    return jax.jit(shard_map(body, mesh=m, in_specs=in_specs,
                             out_specs=out_specs, check_rep=False))


def _leaves(tree) -> list:
    out = []
    mesh.tree_map(out.append, tree)
    return out


# ---------------------------------------------------------------------------
# JAX's side, job by job; each returns (JAX's per-shard results, the port
# job's per-rank arguments)


def _stats_case(m):
    rng = np.random.RandomState(0)
    scale = np.arange(1.0, 6.0)
    batches = (1.0 + rng.randn(WORLD, 40, 5) * scale).astype(np.float32)
    batches[1] += 3.0     # the shards' data differ
    nb = (rng.randn(WORLD, 30, 4) * 2 + 1).astype(np.float32)
    w = (rng.rand(WORLD, 30) < 0.7).astype(np.float32)
    norm = jnorm.make(4, groups_ids=[0, 0, -1, 0])

    def body(b, nb_, w_):
        rms = jrs.update(jrs.init(5), b[0], "env")
        st = norm.update(jnorm.init(4), nb_[0], "env", weights=w_[0])
        return (jax.tree.map(lambda x: x[None], rms),
                jax.tree.map(lambda x: x[None], st),
                norm.check_synced(st, "env")[None])

    rms, st, synced = _smap(m, body, (P("env"),) * 3, P("env"))(
        jnp.asarray(batches), jnp.asarray(nb), jnp.asarray(w))
    ref = {"rms": [np.asarray(x) for x in rms],
           "norm": [np.asarray(x) for x in st],
           "synced": np.asarray(synced)}
    return ref, [(batches[r], nb[r], w[r]) for r in range(WORLD)]


def _segment_case(m):
    jpol = JaxMlpPolicy(ob_dim=56, ac_dim=28)
    cfg = JConfig(horizon=T, num_envs=B)
    learner = JTRPO(None, jpol, cfg, axis_name="env")
    jp = jpol.init(jax.random.PRNGKey(11))
    n_vf = _jflat(jp["vf"]).shape[0]
    segs = [_segment(12 + r, T, B) for r in range(WORLD)]
    key = jax.random.PRNGKey(13)

    def body(params, vf_adam, seg, key):
        seg = jax.tree.map(lambda a: a[0], seg)
        p, _, losses, ev, _ = learner._segment_update(params, vf_adam, seg,
                                                      key)
        out = ({"pol": p["pol"], "logstd": p["logstd"]}, p["vf"],
               p["ob_rms"], losses, ev)
        return jax.tree.map(lambda x: x[None], out)

    out = _smap(m, body, (P(), P(), P("env"), P()), P("env"))(
        jp, jadam.init(n_vf), _stack(segs), key)
    pol, vf, rms, losses, ev = out
    ref = {"pol": np.asarray(jax.vmap(
               lambda t: jax.flatten_util.ravel_pytree(t)[0])(pol)),
           "vf": np.asarray(jax.vmap(
               lambda t: jax.flatten_util.ravel_pytree(t)[0])(vf)),
           "ob_rms": [np.asarray(x) for x in rms],
           "losses": np.asarray(losses), "ev": np.asarray(ev)}
    tpol = MlpPolicy(ob_dim=56, ac_dim=28)
    tp = checkpoint.from_numpy_params(jax.tree.map(np.asarray, jp), "cpu")
    perms = _perms(jax.random.split(key)[1], T * B, cfg.vf_iters)
    tcfg = trpo.TRPOConfig(horizon=T, num_envs=B)
    return ref, [(tpol, tp, segs[r], perms, tcfg) for r in range(WORLD)]


def _ppo_case(m):
    Tp, Bp = 16, 8
    jpol = JaxMlpPolicy(ob_dim=56, ac_dim=28)
    cfg = JPPOConfig(horizon=Tp, num_envs=Bp, epochs=2, minibatches=4)
    learner = JPPO(None, jpol, cfg, axis_name="env")
    jp = jpol.init(jax.random.PRNGKey(21))
    segs = [_segment(22 + r, Tp, Bp) for r in range(WORLD)]
    extra = dict(neglogp=np.zeros((Tp, Bp), np.float32),
                 ep_rets=np.zeros((Tp, Bp), np.float32),
                 ep_lens=np.zeros((Tp, Bp), np.int32),
                 ep_ret_sum=np.float32(0), ep_len_sum=np.float32(0),
                 ep_count=np.int32(0))
    stacked = _stack([{**s, **extra} for s in segs])

    def fake_rollout(params, env_state, new, key, ep_ret, ep_len):
        seg = jax.tree.map(lambda a: a[jax.lax.axis_index("env")], stacked)
        return seg, env_state, new, key, ep_ret, ep_len

    learner._rollout = fake_rollout
    key = jax.random.PRNGKey(23)
    n = _jflat({"pol": jp["pol"], "vf": jp["vf"],
                "logstd": jp["logstd"]}).shape[0]
    zeros = jnp.zeros(WORLD * Bp)
    state = JPPOState(params=jp, opt=jadam.init(n), env_state=zeros,
                      new=zeros.astype(bool), key=key, cur_ep_ret=zeros,
                      cur_ep_len=zeros.astype(jnp.int32),
                      lr_scale=jnp.ones(()))
    specs = JPPOState(params=P(), opt=P(), env_state=P("env"),
                      new=P("env"), key=P(), cur_ep_ret=P("env"),
                      cur_ep_len=P("env"), lr_scale=P())

    def body(state):
        s2, stats = learner.iteration(state)
        p = s2.params
        flat = jax.flatten_util.ravel_pytree(
            {"pol": p["pol"], "vf": p["vf"], "logstd": p["logstd"]})[0]
        return jax.tree.map(lambda x: x[None], (
            flat, p["ob_rms"], s2.opt.m, stats.meankl))

    flat, rms, opt_m, kl = _smap(m, body, (specs,), P("env"))(state)
    ref = {"flat": np.asarray(flat), "ob_rms": [np.asarray(x) for x in rms],
           "opt_m": np.asarray(opt_m), "meankl": np.asarray(kl)}
    tpol = MlpPolicy(ob_dim=56, ac_dim=28)
    tp = checkpoint.from_numpy_params(jax.tree.map(np.asarray, jp), "cpu")
    perms = _perms(jax.random.split(key)[1], Tp * Bp, cfg.epochs)
    tcfg = PPOConfig(horizon=Tp, num_envs=Bp, epochs=2, minibatches=4)
    return ref, [(tpol, tp, segs[r], perms, tcfg) for r in range(WORLD)]


class _Dims:
    observation_size, action_size = 56, 28


def _gail_case(m):
    jpol = JaxMlpPolicy(ob_dim=56, ac_dim=28)
    tcfg = JConfig(horizon=T, num_envs=B)
    rng = np.random.RandomState(31)
    expert = {"obs": (0.5 + rng.randn(96, 56)).astype(np.float32),
              "acs": rng.randn(96, 28).astype(np.float32)}
    gail = JGAIL(_Dims(), jpol, expert["obs"], expert["acs"],
                 JGAILConfig(trpo=tcfg, d_step=2), axis_name="env")
    segs = []
    for r in range(WORLD):
        s = _segment(32 + r, T, B)
        s["ob"] = s["ob"] + 2.0 * r     # the ranks' obs statistics differ
        segs.append(s)
    z = np.zeros((T, B), np.float32)
    extra = dict(ep_rets=z, ep_lens=z.astype(np.int32), ep_true=z,
                 ep_ret_sum=np.float32(0), ep_len_sum=np.float32(0),
                 ep_count=np.int32(0), true_ep_ret_sum=np.float32(0))
    stacked = _stack([{"ob": s["ob"], "ac": s["ac"], **extra} for s in segs])

    def fake_rollout(d_params, params, env_state, new, key, ep_ret, ep_len):
        seg = jax.tree.map(lambda a: a[jax.lax.axis_index("env")], stacked)
        return seg, env_state, new, key, ep_ret, ep_len

    gail._rollout_with_disc_reward = fake_rollout
    gail.trpo._segment_update = lambda p, a, seg, key: (
        p, a, jnp.zeros(5), jnp.zeros(()), key)
    key = jax.random.PRNGKey(33)
    jp = jpol.init(jax.random.PRNGKey(34))
    d0 = gail.disc.init(jax.random.PRNGKey(35))
    n_d = _jflat(d0["net"]).shape[0]
    zeros = jnp.zeros(WORLD * B)
    state = JGAILState(
        trpo=JTRPOState(params=jp, vf_adam=jadam.init(1), env_state=zeros,
                        new=zeros.astype(bool), key=key, cur_ep_ret=zeros,
                        cur_ep_len=zeros.astype(jnp.int32)),
        d_params=d0, d_adam=jadam.init(n_d),
        expert_ptr=jnp.zeros((), jnp.int32))
    env_spec = P("env")
    specs = JGAILState(
        trpo=JTRPOState(params=P(), vf_adam=P(), env_state=env_spec,
                        new=env_spec, key=P(), cur_ep_ret=env_spec,
                        cur_ep_len=env_spec),
        d_params=P(), d_adam=P(), expert_ptr=P())

    def body(state):
        s2, stats = gail.iteration(state)
        return jax.tree.map(lambda x: x[None], (
            jax.flatten_util.ravel_pytree(s2.d_params["net"])[0],
            s2.d_params["obs_rms"], s2.d_adam.m, s2.expert_ptr,
            stats.d_loss))

    net, rms, d_m, ptr, d_loss = _smap(m, body, (specs,), P("env"))(state)
    ref = {"net": np.asarray(net), "obs_rms": [np.asarray(x) for x in rms],
           "d_m": np.asarray(d_m), "ptr": np.asarray(ptr),
           "d_loss": np.asarray(d_loss)}
    tpol = MlpPolicy(ob_dim=56, ac_dim=28)
    td = {"net": [{"w": _t(layer["w"]), "b": _t(layer["b"])}
                  for layer in d0["net"]],
          "obs_rms": RunningMeanStd(*(_t(x) for x in d0["obs_rms"]))}
    d_perm = np.asarray(jax.random.permutation(jax.random.split(key)[1],
                                               T * B))
    cfg = GAILConfig(trpo=trpo.TRPOConfig(horizon=T, num_envs=B), d_step=2)
    return ref, [(tpol, td, segs[r]["ob"].reshape(T * B, 56),
                  segs[r]["ac"].reshape(T * B, 28), expert, d_perm, cfg)
                 for r in range(WORLD)]


def _dp_batch(rng, n_paths=4):
    ends, fail = [], []
    for i in range(n_paths):
        L = rng.randint(2, 8)
        ends += [False] * L + [True]
        fail += [False] * L + [i % 2 == 1]
    n = len(ends)
    is_end = np.array(ends)
    return dict(states=rng.randn(n, 197).astype(np.float32),
                rewards=rng.rand(n).astype(np.float32), is_end=is_end,
                is_fail=np.array(fail), is_succ=np.zeros(n, bool),
                is_exp=(rng.rand(n) < 0.7) & ~is_end)


def _dp_case(m, tmp_path):
    jagent = JPPOAgent(state_size=197, action_size=36, spec=SPEC,
                       axis_name="env")
    tagent = PPOAgent(197, 36, spec=SPEC)
    jp = jagent.init(jax.random.PRNGKey(41))
    path = str(tmp_path / "dp.npz")
    jcheckpoint.save(path, jp)
    tp = checkpoint.load_dp_ppo_params(path, tagent, "cpu")
    rng = np.random.RandomState(42)
    batches = []
    # the same record count per rank (shard_map splits evenly)
    while len(batches) < WORLD:
        b = _dp_batch(rng)
        if not batches or len(b["rewards"]) == len(batches[0]["rewards"]):
            batches.append(b)
    for b in batches:
        n = len(b["rewards"])
        noise = torch.as_tensor(rng.randn(n, 36).astype(np.float32))
        with torch.no_grad():
            a, lp = tagent.decide_action(tp, _t(b["states"]),
                                         _t(b["is_exp"]), noise)
        b["actions"], b["logps"] = a.numpy(), lp.numpy()
    keys = ("states", "actions", "logps", "rewards", "is_end", "is_fail",
            "is_succ", "is_exp")
    key = jax.random.PRNGKey(43)

    def body(*cols):
        p, mt = jagent.train_on_batch(jp, key, *cols, 2)
        return jax.tree.map(lambda x: x[None], (p, mt))

    cat = [jnp.asarray(np.concatenate([b[k] for b in batches])) for k in keys]
    p1, mt = _smap(m, body, (P("env"),) * len(keys), P("env"))(*cat)
    ref = {"params": p1, "metrics": mt}
    args = []
    for b in batches:
        # JAX's minibatch draws from the replicated key, on this shard's
        # probabilities
        is_end = jnp.asarray(b["is_end"])
        exp_w = (jnp.asarray(b["is_exp"]) & ~is_end).astype(jnp.float32)
        valid_w = (~is_end).astype(jnp.float32)
        pc = valid_w / jnp.maximum(jnp.sum(valid_w), 1.0)
        pa = exp_w / jnp.maximum(jnp.sum(exp_w), 1.0)
        c_idx, a_idx = [], []
        for k_ep in jax.random.split(key, SPEC["Epochs"]):
            for k_mb in jax.random.split(k_ep, 2):
                k_c, k_a = jax.random.split(k_mb)
                size, n = SPEC["MiniBatchSize"], pc.shape[0]
                c_idx.append(np.asarray(jax.random.choice(k_c, n, (size,),
                                                          p=pc)))
                a_idx.append(np.asarray(jax.random.choice(k_a, n, (size,),
                                                          p=pa)))
        args.append((SPEC, tp, b, np.stack(c_idx), np.stack(a_idx)))
    return ref, args


def _iteration_case(m):
    jenv = JaxDPEnvV3(clip="walk")
    jpol = JaxMlpPolicy(ob_dim=56, ac_dim=28)
    cfg = JConfig(**ITER_CFG)
    state = JTRPO(jenv, jpol, cfg._replace(num_envs=2 * WORLD)).init(
        jax.random.PRNGKey(0))
    expl = JTRPO(jenv, jpol, cfg, axis_name="env")

    def body(state):
        s2, stats = expl.iteration(state)
        p = s2.params
        return jax.tree.map(lambda x: x[None], (
            {"pol": p["pol"], "logstd": p["logstd"]}, p["vf"], p["ob_rms"],
            stats, s2.env_state.obs, s2.new))

    env_spec = P("env")
    specs = JTRPOState(params=P(), vf_adam=P(), env_state=env_spec,
                       new=env_spec, key=P(), cur_ep_ret=env_spec,
                       cur_ep_len=env_spec)
    pol, vf, rms, stats, obs, new = _smap(m, body, (specs,), P("env"))(state)
    ravel = jax.vmap(lambda t: jax.flatten_util.ravel_pytree(t)[0])
    ref = {"pol": np.asarray(ravel(pol)), "vf": np.asarray(ravel(vf)),
           "ob_rms": [np.asarray(x) for x in rms],
           "stats": jax.tree.map(np.asarray, stats), "obs": np.asarray(obs),
           "new": np.asarray(new)}
    # the draws: the replicated key's action noise and vf permutations,
    # each shard's post-done resets from its envs' keys
    key, noise = state.key, []
    for _ in range(H_ITER):
        key, k_act = jax.random.split(key)
        noise.append(np.asarray(jax.vmap(lambda k: jax.random.normal(
            k, (28,), jnp.float32))(jax.random.split(k_act, 2))))
    perms = _perms(jax.random.split(key)[1], H_ITER * 2, cfg.vf_iters)
    fresh = fresh_fn(jenv, "noise")
    tstate = checkpoint.from_numpy_state(jax.tree.map(np.asarray, state),
                                         trpo.Draws(None), "cpu")
    tpol = MlpPolicy(ob_dim=56, ac_dim=28)
    tcfg = trpo.TRPOConfig(**ITER_CFG)
    args = []
    for r in range(WORLD):
        env_keys, states = state.env_state.key[2 * r:2 * r + 2], []
        for t in range(H_ITER):
            f = fresh(env_keys)
            states.append(port_env_state(f))
            done = ref["stats"].ep_lens[r, 0, t] > 0
            env_keys = jnp.where(jnp.asarray(done)[:, None], f.key, env_keys)
        feed = {"noise": noise, "fresh": states, "perms": [perms]}
        args.append((tpol, dryrun.shard_state(tstate, r, WORLD,
                                              trpo.Draws(None)), feed, tcfg))
    return ref, args


def _episodes_case(_):
    """The port alone: 3 test episodes per rank of a stub env whose
    episode i of rank r lasts r + i + 1 steps at reward 1."""
    agent = PPOAgent(197, 36, spec=SPEC)
    params = agent.init(torch.Generator().manual_seed(51), "cpu")
    return None, [(SPEC, params, 3)] * WORLD


@pytest.fixture(scope="module")
def both(mesh2, tmp_path_factory):
    """JAX's results and the port's, each job run in one 2-rank launch."""
    cases = {"stats": _stats_case, "segment": _segment_case,
             "ppo": _ppo_case, "gail": _gail_case,
             "dp": lambda m: _dp_case(m, tmp_path_factory.mktemp("dp")),
             "iteration": _iteration_case, "segment:cat": _cat_case,
             "episodes": _episodes_case}
    refs, jobs = {}, {}
    for name, case in cases.items():
        refs[name], jobs[name] = case(mesh2)
    ranks = mesh.launch(W.learners_rank, WORLD, "gloo", args=(jobs,),
                        timeout=600)
    return refs, ranks, jobs


def test_running_stats_and_normalizer_psum_match_jax(both):
    """``running_stats.update`` and the normalizer's weighted update sum
    count, sum and sum of squares over the ranks: the same statistics on
    both ranks, JAX's within 1e-3; ``check_synced`` is true, and false for
    a planted offset of one rank's mean."""
    refs, ranks, _ = both
    ref = refs["stats"]
    for r in range(WORLD):
        out = ranks[r]["stats"]
        for a, b in zip(out["rms"], ref["rms"]):
            _parity(a, b[r])
        for a, b in zip(out["norm"], ref["norm"]):
            _parity(a, b[r])
        assert out["synced"] and bool(ref["synced"][r])
        assert not out["planted_synced"]
    for a, b in zip(ranks[0]["stats"]["rms"] + ranks[0]["stats"]["norm"],
                    ranks[1]["stats"]["rms"] + ranks[1]["stats"]["norm"]):
        _replicas(a, b)


def test_trpo_segment_update_matches_jax(both):
    """``TRPO._segment_update`` of two different 32 x 8 segments: policy,
    vf, ob_rms, losses and explained variance (the rank's own, as in JAX)
    within 1e-3 of JAX's shard; the replicas' parameters and losses
    within 1e-6; the policy moved."""
    refs, ranks, jobs = both
    ref = refs["segment"]
    for r in range(WORLD):
        out = ranks[r]["segment"]
        _parity(_pol(out["params"]), ref["pol"][r])
        _parity(_vf(out["params"]), ref["vf"][r])
        for a, b in zip(out["params"]["ob_rms"], ref["ob_rms"]):
            _parity(a, b[r])
        _parity(out["losses"], ref["losses"][r])
        _parity(out["ev"], ref["ev"][r])
    a, b = ranks[0]["segment"], ranks[1]["segment"]
    _replicas(_pol(a["params"]), _pol(b["params"]))
    _replicas(_vf(a["params"]), _vf(b["params"]))
    _replicas(a["losses"], b["losses"])
    assert a["ev"] != b["ev"]      # each rank's own rows
    p0 = jobs["segment"][0][1]
    assert float((_pol(a["params"]) - _pol(p0)).abs().max()) > 1e-4


B_CAT = 20          # envs per rank of the 1-process comparison: a
                    # multiple of 5, so that the FVP's every-5th-row
                    # subsample picks the same rows across ranks and in one
                    # process, and T·B_CAT a multiple of the vf minibatch
                    # (128), so that no rank drops a partial minibatch


def _cat_case(_):
    """The port alone: rank 0's segment, and rank 1's holding the same
    envs in reverse order (so each rank's advantages have the global mean
    and std), for :func:`test_two_rank_segment_update_matches_one_process`;
    no JAX result."""
    seg = _segment(14, T, B_CAT)
    rev = {k: np.ascontiguousarray(v[..., ::-1] if v.ndim == 1
                                   else v[:, ::-1]) for k, v in seg.items()}
    tpol = MlpPolicy(ob_dim=56, ac_dim=28)
    tp = tpol.init(torch.Generator().manual_seed(15), "cpu")
    perms = np.stack([np.random.RandomState(e).permutation(T * B_CAT)
                      for e in range(3)])
    tcfg = trpo.TRPOConfig(horizon=T, num_envs=B_CAT)
    return None, [(tpol, tp, s, perms, tcfg) for s in (seg, rev)]


def test_two_rank_segment_update_matches_one_process(both):
    """The 2-rank ``_segment_update`` against the port's own 1-process
    update on the two ranks' segments side by side (32 steps x 40 envs):
    the policy leaves and ob_rms within 1e-3.  The ranks hold the same envs
    in another order, so that per-rank advantage standardization (JAX's
    semantics) agrees with the global one, and 20 envs each (``B_CAT``), so
    that the Fisher-vector product reads the same rows and the vf epochs
    the same number: what remains is the averaging itself."""
    _, ranks, jobs = both
    tpol, tp, _, _, _ = jobs["segment:cat"][0]
    segs = [jobs["segment:cat"][r][2] for r in range(WORLD)]
    cat = {k: np.concatenate([s[k] for s in segs], axis=0 if k == "nextvpred"
                             else 1) for k in segs[0]}
    learner = trpo.TRPO(W.StubEnv(56, 28), tpol,
                        trpo.TRPOConfig(horizon=T, num_envs=WORLD * B_CAT))
    perms = np.stack([np.random.RandomState(e).permutation(
        T * B_CAT * WORLD) for e in range(3)])
    n_vf = sum(x.numel() for x in trpo.vf_leaves(tp))
    p, *_ = learner._segment_update(tp, adam.init(n_vf, "cpu"),
                                    {k: _t(v) for k, v in cat.items()},
                                    W.Feed({"perms": [perms]}))
    for r in range(WORLD):
        out = ranks[r]["segment:cat"]["params"]
        np.testing.assert_allclose(_np(_pol(out)), _np(_pol(p)), atol=1e-3)
        for a, b in zip(out["ob_rms"], p["ob_rms"]):
            np.testing.assert_allclose(_np(a), _np(b), atol=1e-3, rtol=1e-3)
    assert float((_pol(p) - _pol(tp)).abs().max()) > 1e-3     # it moved


def test_ppo_update_matches_jax(both):
    """``PPO.iteration`` on each rank's segment (2 epochs x 4 minibatches,
    JAX's permutations fed): the flat {logstd, pol, vf}, ob_rms and Adam's
    m within 1e-3 of JAX's; the replicas within 1e-6; meankl (the rank's
    last minibatch, as in JAX) within 1e-3."""
    refs, ranks, _ = both
    ref = refs["ppo"]
    for r in range(WORLD):
        out = ranks[r]["ppo"]
        flat = trpo.flatten(train_leaves(out["params"]))
        _parity(flat, ref["flat"][r])
        for a, b in zip(out["params"]["ob_rms"], ref["ob_rms"]):
            _parity(a, b[r])
        _parity(out["opt"].m, ref["opt_m"][r])
        _parity(out["meankl"], ref["meankl"][r])
    a, b = (ranks[r]["ppo"] for r in range(WORLD))
    _replicas(trpo.flatten(train_leaves(a["params"])),
              trpo.flatten(train_leaves(b["params"])))
    _replicas(a["opt"].m, b["opt"].m)


def test_gail_d_step_matches_jax_and_its_obs_rms_is_per_rank(both):
    """GAIL's d-step (2 minibatches, JAX's permutation fed): the
    discriminator's net and Adam m within 1e-3 of JAX's and within 1e-6
    across the ranks; its obs-RMS is each rank's own (JAX's d-step updates
    it with no axis_name): equal to JAX's shard's, and different between
    the ranks, whose generator obs differ by 2 (half of each minibatch:
    the other half is the same expert rows)."""
    refs, ranks, _ = both
    ref = refs["gail"]
    for r in range(WORLD):
        out = ranks[r]["gail"]
        _parity(trpo.flatten(disc_leaves(out["d_params"])), ref["net"][r])
        _parity(out["d_adam"].m, ref["d_m"][r])
        for a, b in zip(out["d_params"]["obs_rms"], ref["obs_rms"]):
            _parity(a, b[r])
        assert out["ptr"] == int(ref["ptr"][r])
        _parity(out["rec"][0], ref["d_loss"][r])
    a, b = (ranks[r]["gail"] for r in range(WORLD))
    _replicas(trpo.flatten(disc_leaves(a["d_params"])),
              trpo.flatten(disc_leaves(b["d_params"])))
    m0, m1 = a["d_params"]["obs_rms"].mean, b["d_params"]["obs_rms"].mean
    assert float((m1 - m0).mean()) > 0.5


def test_dp_ppo_train_on_batch_matches_jax(both):
    """dp-PPO ``train_on_batch`` on each rank's records (JAX's minibatch
    indices fed): every parameter leaf, the mean losses and the clip
    fraction within 1e-3 of JAX's; the nets, momentum, normalizers and
    stepsize within 1e-6 across the ranks; the advantage statistics and
    sample counts are each rank's own."""
    refs, ranks, _ = both
    ref = refs["dp"]
    jleaves = jax.tree.leaves(ref["params"])
    for r in range(WORLD):
        out = ranks[r]["dp"]
        tl = checkpoint._dp_leaves(out["params"])
        assert len(tl) == len(jleaves)
        for a, b in zip(tl, jleaves):
            _parity(a, np.asarray(b)[r])
        for k, v in out["metrics"].items():
            _parity(v, np.asarray(ref["metrics"][k])[r])
        assert out["s_synced"]
    a, b = (ranks[r]["dp"]["params"] for r in range(WORLD))
    for k in a:
        if k != "sample_count":
            for x, y in zip(_leaves(a[k]), _leaves(b[k])):
                _replicas(x, y)
    ma, mb = ranks[0]["dp"]["metrics"], ranks[1]["dp"]["metrics"]
    for k in ("actor_loss", "critic_loss", "clip_frac", "actor_stepsize"):
        assert ma[k] == pytest.approx(mb[k], abs=REPLICA)
    assert ma["adv_mean"] != mb["adv_mean"]


def test_whole_trpo_iteration_matches_jax(both):
    """One ``TRPO.iteration`` of the walk, 2 envs per rank x 8 steps, the
    draws of JAX's replicated key fed to both ranks and each shard's
    resets from its envs' keys: episode lengths equal, the final obs
    within 1e-3, the policy, vf, ob_rms and losses within 1e-3 of JAX's;
    the replicas within 1e-6."""
    refs, ranks, _ = both
    ref = refs["iteration"]
    for r in range(WORLD):
        out = ranks[r]["iteration"]
        st = out["stats"]
        np.testing.assert_array_equal(_np(st.ep_lens), ref["stats"].ep_lens[r])
        _parity(out["obs"], ref["obs"][r])
        np.testing.assert_array_equal(_np(out["new"]), ref["new"][r])
        _parity(_pol(out["params"]), ref["pol"][r])
        _parity(_vf(out["params"]), ref["vf"][r])
        for a, b in zip(out["params"]["ob_rms"], ref["ob_rms"]):
            _parity(a, b[r])
        for k in ("optimgain", "meankl", "entloss", "surrgain", "entropy"):
            _parity(getattr(st, k), getattr(ref["stats"], k)[r])
        assert np.isfinite(float(st.meankl))
    a, b = (ranks[r]["iteration"] for r in range(WORLD))
    _replicas(_pol(a["params"]), _pol(b["params"]))
    _replicas(_vf(a["params"]), _vf(b["params"]))
    assert not torch.equal(a["obs"], b["obs"])


def test_test_episodes_average_over_every_rank(both):
    """``RLAgentDriver.test_episodes`` sums the returns, lengths and counts
    over the ranks (JAX's multi-host accounting, ``rl_agent.py:257-264``):
    episodes of 1, 2, 3 steps on rank 0 and 2, 3, 4 on rank 1 average 2.5
    on both."""
    _, ranks, _ = both
    for r in range(WORLD):
        assert ranks[r]["episodes"] == (2.5, 2.5)


# ---------------------------------------------------------------------------
# the collectives and the launcher


@pytest.mark.parametrize("world", [1, 2])
def test_collectives(world, tmp_path):
    """At world 1 every collective is the identity; at world 2: the mean
    and sum over the ranks, ``all_gather`` in rank order, ``share_bytes``
    of rank 0's blob (and of an empty one), ``share_file`` to another
    path, ``sync_check`` true on equal sums and false on every rank for a
    planted divergence; every call counted."""
    ranks = mesh.launch(W.collectives_rank, world, "gloo",
                        args=(str(tmp_path),), timeout=120)
    want = np.mean(np.arange(1, world + 1))
    for out in ranks:
        np.testing.assert_allclose(out["mean"][0], np.full(3, want))
        np.testing.assert_allclose(out["mean"][1], np.arange(4.0) * want)
        assert out["sum"] == sum(range(1, world + 1))
        np.testing.assert_array_equal(out["gathered"][:, 0],
                                      np.arange(world, dtype=np.float32))
        assert out["blob"] == b"ckpt\x00\x01payload"
        assert out["empty"] == b""
        assert out["copied"] == b"weights"
        assert out["same"] is True
        assert out["planted"] is (world == 1)
        # pmean, psum, all_gather and 2 x sync_check at any world size;
        # at world 2 also 2 x share_bytes and share_file, two broadcasts
        # each
        assert out["calls"] == (5 if world == 1 else 11)


def test_a_rank_that_raises_fails_the_launch():
    """Rank 1 raises while rank 0 waits in an all-reduce it will never
    complete: the launcher terminates rank 0 and raises with rank 1's
    traceback, well inside its timeout."""
    with pytest.raises(RuntimeError, match="planted failure on rank 1"):
        mesh.launch(W.raising_rank, 2, "gloo", timeout=120)


def test_mesh_helpers():
    """``rank_slice`` splits evenly or raises; ``shard_batch`` takes each
    tensor's rows; ``initialize_distributed`` without arguments or
    torchrun's variables is a no-op returning 0, and refuses an unnamed
    backend."""
    assert mesh.rank_slice(8, 1, 2) == slice(4, 8)
    with pytest.raises(ValueError):
        mesh.rank_slice(7, 0, 2)
    tree = {"a": torch.arange(6), "b": [torch.ones(6, 2)], "c": 3}
    out = mesh.shard_batch(tree, 2, 3)
    assert out["a"].tolist() == [4, 5] and out["b"][0].shape == (2, 2)
    assert out["c"] == 3
    assert mesh.initialize_distributed() == 0
    with pytest.raises(ValueError, match="backend"):
        mesh.initialize_distributed(None, "file:///nonexistent", 1, 0)


def test_dryrun_cli_at_two_cpu_ranks():
    """``python -m deepmimic_mujoco_torch.parallel.dryrun --nproc 2
    --device cpu --backend gloo``: JAX's summary line, 16 timesteps."""
    res = subprocess.run(
        [sys.executable, "-m", "deepmimic_mujoco_torch.parallel.dryrun",
         "--nproc", "2", "--device", "cpu", "--backend", "gloo"],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    line = res.stdout.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip(2): OK — meankl=")
    assert "timesteps=16," in line
