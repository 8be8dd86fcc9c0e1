"""Independent TRPO learners as lanes of one batch
(``deepmimic_mujoco_torch/algos/lanes.py``) against ``jax.vmap`` of the JAX
package's ``TRPO.iteration`` on the CPU, and the lane checkpoints of the
lane tool (``tools/imitation15_vmapped.py``).

The two stacks cannot share random streams (JAX threefry, torch Philox), so
each lane's draws (action noise, the ``rsi_pinned`` reset states, the vf
permutations) are replaced through its own ``Draws`` by the draws JAX makes
from that lane's keys in JAX's split order.  The JAX side jits one physics
program (the vmapped iteration).  Tolerances are stated per test."""

import dataclasses
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.flatten_util
import jax.numpy as jnp

from deepmimic_mujoco_tpu.algos.trpo import TRPO as JTRPO
from deepmimic_mujoco_tpu.algos.trpo import TRPOConfig as JConfig
from deepmimic_mujoco_tpu.envs import multi_clip as jmulti
from deepmimic_mujoco_tpu.io_utils import checkpoint as jcheckpoint
from deepmimic_mujoco_tpu.models import MlpPolicy as JaxMlpPolicy
from deepmimic_mujoco_tpu.physics.humanoid import (
    mocap_hinge_range as jax_hinge_range,
)
from deepmimic_mujoco_torch.algos import adam, lanes, trpo
from deepmimic_mujoco_torch.envs.multi_clip import DPEnvV3Multi
from deepmimic_mujoco_torch.envs.types import EnvState
from deepmimic_mujoco_torch.io_utils import checkpoint
from deepmimic_mujoco_torch.mocap.registry import SKILLS
from deepmimic_mujoco_torch.models.policy import MlpPolicy
from deepmimic_mujoco_torch.physics.humanoid import mocap_hinge_range

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
CKPT_IMIT5 = os.path.join(ROOT, "train_ckpt_imit5_r5b", "imit15_state.npz")
CKPT_IMIT15 = os.path.join(ROOT, "train_ckpt_imit15_r5b", "imit15_state.npz")
IMIT5_CLIPS = ["walk", "run", "spinkick", "backflip", "getup_facedown"]
IMIT_POLICY = dict(ob_dim=83, ac_dim=28, hidden_sizes=(1024, 512),
                   activation="relu", fixed_logstd=-3.0)
CLIPS = ("walk", "kick", "spinkick")           # the case's env and lanes
ENV = dict(control_mode="pd_residual", n_substeps=2, max_episode_steps=5,
           reward_mode="imitation_dm", obs_mode="full",
           termination="fall_contact")
E, T = 2, 8                                    # envs per lane, horizon
# tests/test_algos.py's lane case (hidden 32, 8 steps, 2 envs, 3 CG
# iterations, the recipe's fixed logstd): its lanes' line searches halve
# 2, 2 and 1 times
CFG = dict(horizon=T, num_envs=E, g_step=1, cg_iters=3, vf_iters=1,
           vf_batch_size=4, reset_mode="rsi_pinned")
POLICY = dict(hidden_sizes=(32,), fixed_logstd=-3.0)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _close(out, ref, rel):
    """|out − ref| ≤ rel · max(1, max|ref|)."""
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    ref = np.asarray(ref, np.float64)
    err = float(np.abs(np.asarray(out, np.float64) - ref).max())
    assert err <= rel * max(1.0, float(np.abs(ref).max())), err


def _port_state(es, dtype_ids=torch.int64) -> EnvState:
    return EnvState(qpos=_t(es.qpos), qvel=_t(es.qvel), obs=_t(es.obs),
                    reward=_t(es.reward), done=_t(es.done),
                    mocap_idx=_t(es.mocap_idx).long(),
                    init_idx=_t(es.init_idx).long(),
                    step_count=_t(es.step_count).long(),
                    clip_id=_t(es.clip_id).to(dtype_ids))


class ReplayDraws(trpo.Draws):
    """One lane's draws replaced by JAX's, from the lane's keys in the
    split order of ``deepmimic_mujoco_tpu/algos/trpo.py``: ``key`` is the
    lane's ``TRPOState`` key, ``env_keys`` its envs' keys (E, 2), ``fresh``
    the jitted ``reset_keep_clip`` of the JAX env."""

    def __init__(self, key, env_keys, fresh):
        super().__init__(None)
        self.key, self.env_keys, self._fresh = key, env_keys, fresh

    def action_noise(self, mean):
        self.key, k_act = jax.random.split(self.key)
        k_acts = jax.random.split(k_act, mean.shape[0])
        return _t(jax.vmap(lambda k: jax.random.normal(
            k, (mean.shape[1],), jnp.float32))(k_acts))

    def fresh_states(self, reset_fn, done, state=None):
        assert reset_fn.__name__ == "reset_keep_clip"
        fresh = self._fresh(self.env_keys, jnp.asarray(state.clip_id.numpy()))
        self.env_keys = jnp.where(jnp.asarray(done.numpy())[:, None],
                                  fresh.key, self.env_keys)
        return _port_state(fresh)

    def vf_permutations(self, n, epochs, device):
        self.key, k_vf = jax.random.split(self.key)
        return torch.stack([_t(jax.random.permutation(k, n)).long()
                            for k in jax.random.split(k_vf, epochs)])


class _Spy:
    """Keeps what each ``jax.lax.while_loop`` traced inside one function
    returns, so that the function can return it too: JAX's line search
    (the loop with a 3-element carry) gives each lane's step size."""

    def __init__(self):
        self.while_loop, self.outs = jax.lax.while_loop, []

    def __call__(self, cond, body, init):
        out = self.while_loop(cond, body, init)
        self.outs.append(out)
        return out


def _start_frames(lens):
    """Lane k's E start frames: the clip's middle and two before its end
    (kick does not loop: that env's motion ends inside the segment)."""
    return np.stack([[int(n) // 2, int(n) - 2] for n in lens])


@pytest.fixture(scope="module")
def lane_iteration():
    """One lane iteration of both stacks on the physics: 3 lanes, lane k
    pinned to clip k, from JAX's ``init`` of each lane (key fold_in(0, k))
    with its envs moved to fixed frames; the port replays each lane's JAX
    draws."""
    jm, tm = jax_hinge_range(), mocap_hinge_range(device="cpu")
    jenv = jmulti.DPEnvV3Multi(clips=CLIPS, model=jm, **ENV)
    tenv = DPEnvV3Multi(clips=CLIPS, model=tm, **ENV)
    jpol = JaxMlpPolicy(ob_dim=jenv.observation_size, ac_dim=28, **POLICY)
    learner = JTRPO(jenv, jpol, JConfig(**CFG))
    frames = _start_frames(jenv.clip_lens)
    lane_states = []
    for k in range(len(CLIPS)):
        st = learner.init(jax.random.fold_in(jax.random.PRNGKey(0), k))
        ekeys = jax.random.split(jax.random.PRNGKey(100 + k), E)
        es = jax.vmap(lambda kk, i: jenv.reset_at(kk, k, i))(
            ekeys, jnp.asarray(frames[k]))
        lane_states.append(dataclasses.replace(st, env_state=es))
    js0 = jax.tree.map(lambda *xs: jnp.stack(xs), *lane_states)

    spy = _Spy()
    raw = JTRPO.iteration.__wrapped__

    def iteration(state):
        spy.outs.clear()
        state, stats = raw(learner, state)
        ls = [o for o in spy.outs if len(o) == 3]
        return state, stats, ls[0][1], ls[0][2]

    jax.lax.while_loop = spy
    try:
        js1, jstats, jstep, jacc = jax.jit(jax.vmap(iteration))(js0)
    finally:
        jax.lax.while_loop = spy.while_loop

    np0 = jax.tree.map(np.asarray, js0)
    fresh = jax.jit(jax.vmap(lambda kk, c: jenv.reset_keep_clip(
        jax.random.split(kk)[0], types.SimpleNamespace(clip_id=c))))
    draws = [ReplayDraws(js0.key[k], js0.env_state.key[k], fresh)
             for k in range(len(CLIPS))]
    tpol = MlpPolicy(ob_dim=tenv.observation_size, ac_dim=28, **POLICY)
    tlearner = lanes.LaneTRPO(tenv, tpol, trpo.TRPOConfig(**CFG),
                              lanes=len(CLIPS))
    single = [checkpoint.from_numpy_params(
        jax.tree.map(lambda x, k=k: x[k], np0.params), "cpu")
        for k in range(len(CLIPS))]
    ts0 = lanes.LaneState(
        params=lanes.stack_params(single),
        vf_adam=adam.AdamState(*(_t(x) for x in np0.vf_adam)),
        env_state=_port_state(jax.tree.map(
            lambda x: x.reshape((-1,) + x.shape[2:]), np0.env_state)),
        new=_t(np0.new), draws=draws, cur_ep_ret=_t(np0.cur_ep_ret),
        cur_ep_len=_t(np0.cur_ep_len))
    infos = []
    update = tlearner._policy_update

    def spy_update(*args):
        out = update(*args)
        infos.append(out[2])
        return out

    tlearner._policy_update = spy_update
    ts1, tstats = tlearner.iteration(ts0)
    jres = jax.tree.map(np.asarray, (js1, jstats, jstep, jacc))
    return jres, (ts1, tstats, infos[0]), tlearner


def test_lane_iteration_episodes_and_stats_match_jax(lane_iteration):
    """Per lane: the episodes that ended (each step's returns within 1e-5,
    lengths equal) and the episode stats within rtol 1e-6; the losses and
    the explained variance within rtol 1e-5 (measured up to 3.7e-6: the
    f32 sums of the MLPs, CG and the means run in another order, and
    differ so even with the physics replaced by the same map in both
    stacks); at least one env of every lane finished and was reset on its
    own clip."""
    (js1, jstats, _, _), (ts1, tstats, _), _ = lane_iteration
    np.testing.assert_array_equal(tstats.ep_lens.numpy(), jstats.ep_lens)
    np.testing.assert_allclose(tstats.ep_rets.numpy(), jstats.ep_rets,
                               atol=1e-5)
    assert (np.asarray(jstats.ep_count) >= 1).all()
    for k in ("ep_ret_sum", "ep_len_sum", "ep_count", "timesteps",
              "ep_len_sum_last"):
        np.testing.assert_allclose(getattr(tstats, k).numpy(),
                                   getattr(jstats, k), rtol=1e-6, atol=0,
                                   err_msg=k)
    for k in ("optimgain", "meankl", "entloss", "surrgain", "entropy",
              "ev_tdlam_before"):
        np.testing.assert_allclose(getattr(tstats, k).numpy(),
                                   getattr(jstats, k), rtol=1e-5, atol=0,
                                   err_msg=k)
    np.testing.assert_array_equal(
        ts1.env_state.clip_id.numpy().reshape(len(CLIPS), E),
        np.asarray(js1.env_state.clip_id))
    np.testing.assert_array_equal(ts1.env_state.step_count.numpy(),
                                  js1.env_state.step_count.reshape(-1))


def test_lane_iteration_params_and_line_search_match_jax(lane_iteration):
    """Per lane: the new policy and vf parameters within 1e-4 of
    max(1, |x|), ob_rms and Adam's moments within 1e-5, the same step size
    (the same number of line-search halvings) and acceptance; the lanes do
    not all halve the same number of times."""
    (js1, _, jstep, jacc), (ts1, _, info), _ = lane_iteration
    for k in range(len(CLIPS)):
        tp = lanes.lane_params(ts1.params, k)
        jp = jax.tree.map(lambda x, k=k: x[k], js1.params)
        _close(trpo.flatten(trpo.policy_leaves(tp)),
               jax.flatten_util.ravel_pytree(
                   {"pol": jp["pol"], "logstd": jp["logstd"]})[0], 1e-4)
        _close(trpo.flatten(trpo.vf_leaves(tp)),
               jax.flatten_util.ravel_pytree(jp["vf"])[0], 1e-4)
        for o, r in zip(tp["ob_rms"], jp["ob_rms"]):
            _close(o, r, 1e-5)
    for o, r in zip(ts1.vf_adam, js1.vf_adam):
        _close(o, r, 1e-5)
    np.testing.assert_array_equal(info.stepsize.numpy(), jstep)
    np.testing.assert_array_equal(info.accepted.numpy(), jacc)
    halvings = -np.log2(jstep)
    assert len(set(halvings.tolist())) >= 2, halvings


def test_lanes_are_independent_and_keep_a_nan_lane_to_itself():
    """Lane A trained alone equals lane A trained beside two other lanes,
    one of them with NaN parameters, within 1e-6 (same generator, same
    clip); lane A stays finite and the NaN lane is reported."""
    tm = mocap_hinge_range(device="cpu")
    env = DPEnvV3Multi(clips=CLIPS, model=tm, **ENV)
    pol = MlpPolicy(ob_dim=env.observation_size, ac_dim=28, **POLICY)
    cfg = trpo.TRPOConfig(**CFG)
    out = {}
    for lanes_ in ((1,), (0, 1, 2)):
        learner = lanes.LaneTRPO(env, pol, cfg, lanes=len(lanes_))
        gens = [torch.Generator().manual_seed(10 + k) for k in lanes_]
        st = learner.init(gens, lane_clip_ids=list(lanes_))
        if len(lanes_) == 3:
            p = lanes.lane_params(st.params, 2)
            bad = {**p, "pol": [{k: torch.full_like(v, float("nan"))
                                 for k, v in layer.items()}
                                for layer in p["pol"]]}
            st = dataclasses.replace(st, params=lanes.stack_params(
                [lanes.lane_params(st.params, 0),
                 lanes.lane_params(st.params, 1), bad]))
        st, stats = learner.iteration(st)
        a = lanes_.index(1)
        out[len(lanes_)] = (lanes.lane_params(st.params, a), stats, a,
                            st.env_state.qpos.reshape(len(lanes_), E, -1)[a])
    (p1, s1, a1, q1), (p3, s3, a3, q3) = out[1], out[3]
    f1 = trpo.flatten(trpo.policy_leaves(p1) + trpo.vf_leaves(p1))
    f3 = trpo.flatten(trpo.policy_leaves(p3) + trpo.vf_leaves(p3))
    assert bool(torch.isfinite(f3).all())
    _close(f3, f1.numpy(), 1e-6)
    _close(q3, q1.numpy(), 1e-6)
    for k in ("meankl", "surrgain", "ev_tdlam_before", "ep_ret_sum"):
        _close(getattr(s3, k)[a3], getattr(s1, k)[a1].numpy(), 1e-6)
    assert lanes.nonfinite_lanes(s3) == [2] and lanes.nonfinite_lanes(s1) == []


def _cheap(qp, qv, ac):
    t = ac.mean(1) if ac.dim() == 3 else ac
    return (torch.cat([qp[:, :1] + 0.01, qp[:, 1:7], 0.5 * qp[:, 7:] + 0.5 * t],
                      dim=1), 0.9 * qv)


@pytest.mark.parametrize("n_lanes", [1, 3])
def test_one_adam_step_per_minibatch_and_one_env_step_per_control_step(
        n_lanes, monkeypatch):
    """Whatever the lane count, an iteration makes vf_iters·⌊E·T/128⌋ Adam
    updates (one lane-batched step per minibatch) and one ``env.step``
    call per control step (cheap dynamics)."""
    env = DPEnvV3Multi(clips=CLIPS, model=mocap_hinge_range(device="cpu"),
                       **ENV)
    env._dynamics = _cheap
    steps, updates = [], []
    step, update = env.step, adam.update
    env.step = lambda s, a: (steps.append(a.shape[0]), step(s, a))[1]
    monkeypatch.setattr(adam, "update", lambda *a, **k: (
        updates.append(a[1].shape), update(*a, **k))[1])
    cfg = trpo.TRPOConfig(horizon=16, num_envs=16, g_step=1, vf_iters=3,
                          reset_mode="rsi_pinned")
    learner = lanes.LaneTRPO(env, MlpPolicy(ob_dim=env.observation_size,
                                            ac_dim=28, hidden_sizes=(16,)),
                             cfg, lanes=n_lanes)
    st = learner.init([torch.Generator().manual_seed(k)
                       for k in range(n_lanes)], list(range(n_lanes)))
    learner.iteration(st)
    assert steps == [n_lanes * 16] * 16
    assert len(updates) == 3 * (16 * 16 // 128) == 6
    assert all(u[0] == n_lanes for u in updates)


# ---------------------------------------------------------------------------
# lane checkpoints


@pytest.mark.parametrize("path,clips", [
    (CKPT_IMIT5, IMIT5_CLIPS), (CKPT_IMIT15, SKILLS)], ids=["imit5", "imit15"])
def test_lane_checkpoints_read_as_stored(path, clips):
    """The port reads the lane tool's checkpoints: every lane's leaves
    equal the raw npz arrays, and each lane's envs run the clip of its
    place in the tool's clip order (over the 15-clip env)."""
    pol = MlpPolicy(**IMIT_POLICY)
    raw = checkpoint.read_lanes(path, pol)
    with np.load(path) as z:
        leaves = [z[f"leaf_{i}"] for i in range(len(z.files) - 1)]
    L = len(clips)
    params, vf_adam = checkpoint.load_lane_params(path, pol, "cpu")
    for k in range(L):
        p = lanes.lane_params(params, k)
        flat = [p["logstd"], *p["ob_rms"]] + [
            x for head in ("pol", "vf") for layer in p[head]
            for x in (layer["b"], layer["w"])]
        for i, x in enumerate(flat):
            np.testing.assert_array_equal(x.numpy(), leaves[i][k])
        for i, x in zip((16, 17, 18), vf_adam):
            np.testing.assert_array_equal(x[k].numpy(), leaves[i][k])
    np.testing.assert_array_equal(raw.env_state.clip_id, leaves[28])
    want = np.asarray([SKILLS.index(c) for c in clips])
    assert (raw.env_state.clip_id == want[:, None]).all()
    np.testing.assert_array_equal(raw.cur_ep_len, leaves[32])
    if L == 5:
        env = DPEnvV3Multi(clips=tuple(SKILLS),
                           model=mocap_hinge_range(device="cpu"))
        learner = lanes.LaneTRPO(env, pol, trpo.TRPOConfig(num_envs=160),
                                 lanes=5)
        st = checkpoint.load_lane_state(path, learner, [None] * 5)
        np.testing.assert_array_equal(st.env_state.qpos.numpy(),
                                      leaves[19].reshape(800, 35))
        np.testing.assert_array_equal(st.env_state.clip_id.numpy(),
                                      leaves[28].reshape(-1))


def test_port_lane_and_multi_clip_files_load_in_jax_strictly(
        lane_iteration, tmp_path):
    """JAX's strict ``checkpoint.load`` takes the port's lane file (into a
    lane-stacked JAX ``TRPOState``) and a multi-clip single-policy file
    (into ``TRPO(DPEnvV3Multi).init``), with JAX's dtypes and shapes."""
    (js1, _, _, _), (ts1, _, _), tlearner = lane_iteration
    jenv = jmulti.DPEnvV3Multi(clips=CLIPS, model=jax_hinge_range(), **ENV)
    jpol = JaxMlpPolicy(ob_dim=jenv.observation_size, ac_dim=28, **POLICY)
    jl = JTRPO(jenv, jpol, JConfig(**CFG))
    like = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        jl.init(jax.random.PRNGKey(k)) for k in range(len(CLIPS))])
    path = checkpoint.save(str(tmp_path / "imit15_state"), ts1)
    js = jcheckpoint.load(path, like)   # strict: raises on any drift
    for a, b in zip(jax.tree.leaves(js), jax.tree.leaves(like)):
        assert (np.asarray(a).dtype, np.shape(a)) == (np.asarray(b).dtype,
                                                      np.shape(b))
    np.testing.assert_array_equal(np.asarray(js.env_state.clip_id),
                                  np.asarray(js1.env_state.clip_id))
    np.testing.assert_array_equal(np.asarray(js.params["pol"][1]["w"]),
                                  ts1.params["pol"][1]["w"].numpy())

    # one lane as a single learner's TRPOState of the multi-clip env
    sl = slice(0, E)
    single = trpo.TRPOState(
        params=lanes.lane_params(ts1.params, 0),
        vf_adam=adam.AdamState(*(x[0] for x in ts1.vf_adam)),
        env_state=ts1.env_state.map(lambda x: x[sl]), new=ts1.new[0],
        draws=None, cur_ep_ret=ts1.cur_ep_ret[0], cur_ep_len=ts1.cur_ep_len[0])
    path = checkpoint.save(str(tmp_path / "trpo_state"), single)
    like1 = jl.init(jax.random.PRNGKey(0))
    js = jcheckpoint.load(path, like1)
    for a, b in zip(jax.tree.leaves(js), jax.tree.leaves(like1)):
        assert (np.asarray(a).dtype, np.shape(a)) == (np.asarray(b).dtype,
                                                      np.shape(b))
    back = checkpoint.load_trpo_state(path, trpo.TRPO(
        tlearner.env, tlearner.policy, trpo.TRPOConfig(**CFG)),
        trpo.Draws(None))
    torch.testing.assert_close(back.env_state.clip_id,
                               ts1.env_state.clip_id[sl], rtol=0, atol=0)
