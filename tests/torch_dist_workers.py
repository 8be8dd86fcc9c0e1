"""Rank functions of ``tests/test_torch_parallel.py``, run by
``deepmimic_mujoco_torch.parallel.mesh.launch`` in spawned gloo ranks on the
CPU.  This module imports torch and the port only (the spawned ranks import
it by name, and JAX has no place in them): the JAX side's draws arrive as
arrays through :class:`Feed` and :class:`DpFeed`."""

import dataclasses
import os

import torch
import torch.distributed as dist

from deepmimic_mujoco_torch.algos import adam, trpo
from deepmimic_mujoco_torch.dp_policy import draws as dp_draws
from deepmimic_mujoco_torch.dp_policy import normalizer
from deepmimic_mujoco_torch.parallel import collectives
from deepmimic_mujoco_torch.utils import running_stats


def _t(x):
    return torch.as_tensor(x)


class Feed(trpo.Draws):
    """Draws handed over in order: ``noise`` (action noise per step),
    ``fresh`` (the fresh-start ``EnvState`` per step), ``perms`` (vf or PPO
    epoch permutations per update) and ``d_perm`` (GAIL's d-step order)."""

    def __init__(self, feed: dict):
        super().__init__(None)
        self.feed = {k: list(v) for k, v in feed.items()}

    def action_noise(self, mean):
        return _t(self.feed["noise"].pop(0))

    def fresh_states(self, reset_fn, done, state=None):
        return self.feed["fresh"].pop(0)

    def vf_permutations(self, n, epochs, device):
        return _t(self.feed["perms"].pop(0)).long()

    def d_permutation(self, n, device):
        return _t(self.feed["d_perm"].pop(0)).long()


class DpFeed(dp_draws.Draws):
    """``train_on_batch``'s minibatch indices handed over."""

    def __init__(self, c_idx, a_idx):
        super().__init__(None)
        self.idx = (_t(c_idx).long(), _t(a_idx).long())

    def minibatch_indices(self, p_critic, p_actor, epochs, n_mb, size):
        return self.idx


class StubEnv:
    """What a learner reads of an env when no rollout runs."""

    def __init__(self, ob_dim: int, ac_dim: int):
        self.observation_size, self.action_size = ob_dim, ac_dim
        self.device = torch.device("cpu")

    def reset(self, generator, n):
        raise AssertionError("no reset expected")


def _group():
    return dist.group.WORLD


# ---------------------------------------------------------------------------
# the learners


def stats_job(rank, batch, nbatch, weights):
    """``running_stats.update`` and the normalizer's weighted update of the
    rank's batches, with ``check_synced`` before and after."""
    rms = running_stats.update(running_stats.init(batch.shape[-1], "cpu"),
                               _t(batch), _group())
    norm = normalizer.make(nbatch.shape[-1], groups_ids=[0, 0, -1, 0])
    st = norm.update(normalizer.init(nbatch.shape[-1]), _t(nbatch),
                     weights=_t(weights), group=_group())
    planted = st._replace(mean=st.mean + rank)
    return {"rms": [x.numpy() for x in rms],
            "norm": [x.numpy() for x in st],
            "synced": norm.check_synced(st, _group()),
            "planted_synced": norm.check_synced(planted, _group())}


def segment_job(rank, policy, params, seg, perms, config):
    """``TRPO._segment_update`` of the rank's segment."""
    learner = trpo.TRPO(StubEnv(policy.ob_dim, policy.ac_dim), policy,
                        config, _group())
    n_vf = sum(x.numel() for x in trpo.vf_leaves(params))
    p, vf_adam, losses, ev, info = learner._segment_update(
        params, adam.init(n_vf, "cpu"), {k: _t(v) for k, v in seg.items()},
        Feed({"perms": [perms]}))
    return {"params": p, "vf_adam": vf_adam, "losses": losses,
            "ev": float(ev), "g": info.g, "stepsize": info.stepsize}


def ppo_job(rank, policy, params, seg, perms, config):
    """``PPO.iteration`` whose rollout returns the rank's segment."""
    from deepmimic_mujoco_torch.algos.ppo import PPO, PPOState, train_leaves

    learner = PPO(StubEnv(policy.ob_dim, policy.ac_dim), policy, config,
                  _group())
    T, B = seg["rew"].shape
    seg = {k: _t(v) for k, v in seg.items()}
    seg.update(ep_rets=torch.zeros(T, B), ep_lens=torch.zeros(T, B),
               ep_ret_sum=torch.zeros(()), ep_len_sum=torch.zeros(()),
               ep_count=torch.zeros((), dtype=torch.int64))
    learner._rollout = lambda p, e, new, d, r, n_: (seg, e, new, r, n_)
    n = sum(x.numel() for x in train_leaves(params))
    state = PPOState(params=params, opt=adam.init(n, "cpu"), env_state=None,
                     new=torch.zeros(B, dtype=torch.bool),
                     draws=Feed({"perms": [perms]}),
                     cur_ep_ret=torch.zeros(B),
                     cur_ep_len=torch.zeros(B, dtype=torch.int32),
                     lr_scale=torch.ones(()))
    state, stats = learner.iteration(state)
    return {"params": state.params, "opt": state.opt,
            "meankl": float(stats.meankl), "entropy": float(stats.entropy)}


def gail_job(rank, policy, d_params, ob, ac, expert, d_perm, config):
    """GAIL's d-step on the rank's rows."""
    from deepmimic_mujoco_torch.algos.gail import GAIL, disc_leaves

    gail = GAIL(StubEnv(policy.ob_dim, policy.ac_dim), policy,
                expert["obs"], expert["acs"], config, group=_group())
    n_d = sum(x.numel() for x in disc_leaves(d_params))
    d_params, d_adam, ptr, rec = gail._d_update(
        d_params, adam.init(n_d, "cpu"), torch.zeros((), dtype=torch.int64),
        _t(ob), _t(ac), Feed({"d_perm": [d_perm]}))
    return {"d_params": d_params, "d_adam": d_adam, "ptr": int(ptr),
            "rec": rec}


def dp_job(rank, spec, params, batch, c_idx, a_idx):
    """dp-PPO ``train_on_batch`` of the rank's records."""
    from deepmimic_mujoco_torch.dp_policy.ppo_agent import PPOAgent

    agent = PPOAgent(batch["states"].shape[1], batch["actions"].shape[1],
                     spec=spec, group=_group())
    p, m = agent.train_on_batch(
        params, DpFeed(c_idx, a_idx), *(_t(batch[k]) for k in (
            "states", "actions", "logps", "rewards", "is_end", "is_fail",
            "is_succ", "is_exp")), 2)
    return {"params": p, "metrics": {k: float(v) for k, v in m.items()},
            "s_synced": agent.s_norm.check_synced(p["s_norm"], _group())}


def iteration_job(rank, policy, state, feed, config):
    """A whole ``TRPO.iteration`` of the walk from the rank's envs with the
    draws fed."""
    from deepmimic_mujoco_torch.envs.dp_env_v3 import DPEnvV3

    learner = trpo.TRPO(DPEnvV3(clip="walk", device="cpu"), policy, config,
                        _group())
    state = dataclasses.replace(state, draws=Feed(feed))
    state, stats = learner.iteration(state)
    return {"params": state.params, "vf_adam": state.vf_adam,
            "stats": stats, "obs": state.env_state.obs, "new": state.new}


class CountEnv:
    """A stub env for ``test_episodes``: reward 1 per step; episode i of
    rank r ends after r + i + 1 steps."""

    def __init__(self, rank: int, state_size: int):
        self.rank, self.state_size = rank, state_size
        self.device = torch.device("cpu")

    def reset(self, generator, n):
        from deepmimic_mujoco_torch.envs.types import EnvState

        z = torch.zeros(n, dtype=torch.int64)
        return EnvState(qpos=torch.zeros(n, 1), qvel=torch.zeros(n, 1),
                        obs=torch.zeros(n, self.state_size),
                        reward=torch.zeros(n), done=z.bool(), mocap_idx=z,
                        init_idx=z, step_count=z)

    def step(self, state, action):
        count = state.step_count + 1
        limit = self.rank + 1 + torch.arange(count.shape[0])
        return dataclasses.replace(state, step_count=count,
                                   reward=torch.ones(count.shape[0]),
                                   done=count >= limit)


def episodes_job(rank, spec, params, n):
    """``RLAgentDriver.test_episodes`` of ``n`` episodes of
    :class:`CountEnv` with the group's averages."""
    from deepmimic_mujoco_torch.dp_policy.ppo_agent import PPOAgent
    from deepmimic_mujoco_torch.dp_policy.rl_agent import RLAgentDriver

    agent = PPOAgent(197, 36, spec=spec, group=_group())
    driver = RLAgentDriver(CountEnv(rank, 197), agent, num_envs=n)
    return driver.test_episodes(params, n_episodes=n, horizon=20)


JOBS = {"episodes": episodes_job, "stats": stats_job, "segment": segment_job, "ppo": ppo_job,
        "gail": gail_job, "dp": dp_job, "iteration": iteration_job}


def learners_rank(rank, world, jobs: dict) -> dict:
    """Every job of ``jobs`` (name → per-rank argument tuples) in one
    launch; a job's name's prefix names its function."""
    torch.manual_seed(0)
    return {name: JOBS[name.split(":")[0]](rank, *args[rank])
            for name, args in jobs.items()}


# ---------------------------------------------------------------------------
# the collectives


def collectives_rank(rank, world, tmp: str) -> dict:
    """The collectives at this world size: the mean and sum of a
    rank-dependent tensor list, ``all_gather``, ``share_bytes`` (rank 0's
    blob; the others pass None), ``share_file`` into a per-rank directory,
    ``sync_check`` on equal vectors and with rank 1's planted off by 1, and
    the tally of calls."""
    g = _group()
    collectives.tally.reset()
    x = [torch.full((3,), float(rank + 1)), torch.arange(4.0) * (rank + 1)]
    mean = collectives.maybe_pmean(x, g)
    total = collectives.maybe_psum(torch.tensor([rank + 1.0]), g)
    gathered = collectives.all_gather(torch.tensor([float(rank)]), g)
    blob = collectives.share_bytes(b"ckpt\x00\x01payload" if rank == 0
                                   else None, g)
    empty = collectives.share_bytes(b"" if rank == 0 else None, g)
    src = os.path.join(tmp, "rank0", "model.bin")
    path = src if rank == 0 else os.path.join(tmp, f"rank{rank}", "model.bin")
    if rank == 0:
        os.makedirs(os.path.dirname(src), exist_ok=True)
        with open(src, "wb") as fh:
            fh.write(b"weights")
        collectives.share_file(src, g)
        copied = b"weights"
    else:
        # share_file writes at the path it is given: each rank its own
        collectives.share_file(path, g)
        with open(path, "rb") as fh:
            copied = fh.read()
    p, o = torch.ones(16), torch.ones(8)
    same = collectives.sync_check(p, o, g)
    planted = collectives.sync_check(p + (1.0 if rank == 1 else 0.0), o, g)
    return {"mean": [t.numpy() for t in mean], "sum": float(total),
            "gathered": gathered.numpy(), "blob": blob, "empty": empty,
            "copied": copied, "same": same, "planted": planted,
            "calls": collectives.tally.calls}


def raising_rank(rank, world) -> None:
    """Rank 1 raises; rank 0 waits in an all-reduce that rank 1 never
    joins."""
    if rank == 1:
        raise ValueError("planted failure on rank 1")
    collectives.maybe_psum(torch.ones(1), _group())


def collectives_cuda_rank(rank, world) -> dict:
    """:func:`collectives_rank`'s collectives on tensors on the card."""
    g, dev = _group(), torch.device("cuda", torch.cuda.current_device())
    mean = collectives.maybe_pmean([torch.full((3,), float(rank + 1),
                                               device=dev)], g)
    total = collectives.maybe_psum(torch.tensor([rank + 1.0], device=dev), g)
    gathered = collectives.all_gather(torch.tensor([float(rank)],
                                                   device=dev), g)
    blob = collectives.share_bytes(b"ckpt\x00\x01payload" if rank == 0
                                   else None, g)
    p, o = torch.ones(16, device=dev), torch.ones(8, device=dev)
    return {"devices": [x.device.type for x in (mean[0], total, gathered)],
            "mean": [t.cpu().numpy() for t in mean],
            "sum": float(total), "gathered": gathered.cpu().numpy(),
            "blob": blob, "same": collectives.sync_check(p, o, g),
            "planted": collectives.sync_check(
                p + (1.0 if rank == 1 else 0.0), o, g)}
