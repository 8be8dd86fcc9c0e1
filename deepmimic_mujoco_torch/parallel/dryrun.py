"""Data-parallel dry run (port of ``__graft_entry__.dryrun_multichip``).

One TRPO iteration (``DPEnvV3`` walk), one GAIL iteration (the imitation
recipe's env and the bundled walk expert, ``assets/expert/
walk_expert.npz``) and one dp-PPO ``train_on_batch`` (the 197-D DeepMimic
surface), each with its env batch or records split over the ranks and its
parameters replicated, at the JAX dry run's widths: 2 envs per rank × 4
steps, 16 records per rank.  Every rank checks that the KL and the losses
are finite and that the replicas agree (:func:`~deepmimic_mujoco_torch.
parallel.collectives.sync_check` over what JAX keeps replicated, and the
normalizers' ``check_synced``); the summary line is JAX's.

On one machine, the ranks spawned::

    python -m deepmimic_mujoco_torch.parallel.dryrun --nproc 2 --device cpu --backend gloo

On a machine with N cards, rank r on ``cuda:<local rank>``::

    torchrun --nproc-per-node N -m deepmimic_mujoco_torch.parallel.dryrun --backend nccl

The module also holds the rank functions that run TRPO at other widths
across ranks (:func:`trpo_rank`, :func:`segment_rank`).
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from deepmimic_mujoco_torch.algos import adam
from deepmimic_mujoco_torch.algos.trpo import (
    TRPO,
    Draws,
    TRPOConfig,
    flatten,
    policy_leaves,
    vf_leaves,
)
from deepmimic_mujoco_torch.parallel import collectives
from deepmimic_mujoco_torch.parallel.collectives import sync_check
from deepmimic_mujoco_torch.parallel.mesh import (
    initialize_distributed,
    launch,
    rank_device,
    rank_slice,
    replicate,
    shard_batch,
    tree_map,
)

SEED = 0
EXPERT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                      "assets", "expert", "walk_expert.npz")
# the JAX dry run's TRPO: 2 envs per rank, 4 steps, one short update
DRY_CONFIG = TRPOConfig(horizon=4, num_envs=2, g_step=1, cg_iters=2,
                        vf_iters=1, vf_batch_size=4, line_search_steps=2)
DP_RECORDS = 16             # dp-PPO records per rank
SEG_KEYS = ("ob", "ac", "vpred", "rew", "new", "nextvpred")


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def rank_draws(seed: int, rank: int, device: torch.device,
               draws_cls=Draws):
    """Rank ``rank``'s draws: the rollout's from its own stream (seed
    ``seed + 10000·(rank + 1)``, the baselines idiom's per-worker offset),
    the update's from a stream seeded alike on every rank (``seed + 1``)."""
    return draws_cls(_generator(device, seed + 10000 * (rank + 1)),
                     shared=_generator(device, seed + 1))


def shard_state(state, rank: int, world: int, draws):
    """Rank ``rank``'s envs of a global ``TRPOState`` (or ``PPOState``),
    with ``draws`` in place of the global state's."""
    def mine(x):
        return shard_batch(x, rank, world)
    return dataclasses.replace(
        state, env_state=mine(state.env_state), new=mine(state.new),
        cur_ep_ret=mine(state.cur_ep_ret), cur_ep_len=mine(state.cur_ep_len),
        draws=draws)


def trpo_flat(params: dict, vf_adam: adam.AdamState):
    """(parameters, optimizer state) as flat vectors for ``sync_check``:
    the policy, the vf and ob_rms; the vf Adam moments."""
    rms = params["ob_rms"]
    p = flatten(policy_leaves(params) + vf_leaves(params)
                + [rms.mean, rms.var, rms.count])
    return p, torch.cat([vf_adam.m, vf_adam.v])


def _finite(what: str, **values) -> None:
    bad = {k: float(v) for k, v in values.items()
           if not math.isfinite(float(v))}
    if bad:
        raise AssertionError(f"{what}: non-finite {bad}")


def _synced(what: str, *flags: bool) -> None:
    if not all(flags):
        raise AssertionError(f"{what}: the replicas diverged ({flags})")


# ---------------------------------------------------------------------------
# the dry run


def _dry_trpo(rank, world, dev, group) -> dict:
    from deepmimic_mujoco_torch.envs.dp_env_v3 import DPEnvV3
    from deepmimic_mujoco_torch.models.policy import MlpPolicy

    env = DPEnvV3(clip="walk", device=dev)
    policy = MlpPolicy(ob_dim=env.observation_size, ac_dim=env.action_size)
    glob = TRPO(env, policy, DRY_CONFIG._replace(num_envs=2 * world))
    state = shard_state(glob.init(_generator(dev, SEED)), rank, world,
                        rank_draws(SEED, rank, dev))
    replicate(state.params, group)
    state, stats = TRPO(env, policy, DRY_CONFIG, group).iteration(state)
    _finite("TRPO", **{k: getattr(stats, k) for k in (
        "optimgain", "meankl", "entloss", "surrgain", "entropy")})
    _synced("TRPO", sync_check(*trpo_flat(state.params, state.vf_adam),
                               group))
    return {"meankl": float(stats.meankl),
            "timesteps": int(stats.timesteps) * world}


def _dry_gail(rank, world, dev, group) -> dict:
    from deepmimic_mujoco_torch.algos.dataset import MujocoDset
    from deepmimic_mujoco_torch.algos.gail import GAIL, GAILConfig, disc_leaves
    from deepmimic_mujoco_torch.envs.dp_env_v3 import DPEnvV3
    from deepmimic_mujoco_torch.models.policy import MlpPolicy

    env = DPEnvV3(clip="walk", reward_mode="imitation_dm",
                  control_mode="pd_residual", n_substeps=2,
                  max_episode_steps=300, device=dev)
    policy = MlpPolicy(ob_dim=env.observation_size, ac_dim=env.action_size)
    dset = MujocoDset(EXPERT, traj_limitation=4)
    if dset.obs.shape[1] != env.observation_size:
        raise ValueError(f"expert obs {dset.obs.shape} against the env's "
                         f"{env.observation_size}")
    exp_obs = dset.obs[:256].astype(np.float32)
    exp_acs = dset.acs[:256].astype(np.float32)
    cfg = GAILConfig(trpo=DRY_CONFIG, d_batches=2)
    glob = GAIL(env, policy, exp_obs, exp_acs,
                cfg._replace(trpo=DRY_CONFIG._replace(num_envs=2 * world)))
    state = glob.init(_generator(dev, SEED + 1))
    state = dataclasses.replace(state, trpo=shard_state(
        state.trpo, rank, world, rank_draws(SEED + 1, rank, dev)))
    replicate([state.trpo.params, state.d_params["net"]], group)
    gail = GAIL(env, policy, exp_obs, exp_acs, cfg, group=group)
    state, stats = gail.iteration(state)
    _finite("GAIL", meankl=stats.trpo.meankl, d_loss=stats.d_loss)
    # the discriminator's obs-RMS is each rank's own (JAX updates it with
    # no axis_name): left out of the check
    p, o = trpo_flat(state.trpo.params, state.trpo.vf_adam)
    _synced("GAIL", sync_check(
        torch.cat([p, flatten(disc_leaves(state.d_params))]),
        torch.cat([o, state.d_adam.m, state.d_adam.v]), group))
    return {"gail_dloss": float(stats.d_loss),
            "gail_meankl": float(stats.trpo.meankl)}


def dp_flat(params: dict):
    """The dp-PPO parameters JAX keeps replicated, flat for
    ``sync_check``: the nets and the actor stepsize; the momentum
    accumulators."""
    def leaves(layers):
        return [x for layer in layers for x in layer.values()]
    p = flatten(leaves(params["actor"]) + leaves(params["critic"])
                + [params["actor_stepsize"]])
    o = flatten(leaves(params["actor_opt"].m) + leaves(params["critic_opt"].m))
    return p, o


def _dry_dp_ppo(rank, world, dev, group) -> dict:
    from deepmimic_mujoco_torch.dp_policy import draws as dp_draws
    from deepmimic_mujoco_torch.dp_policy.ppo_agent import PPOAgent
    from deepmimic_mujoco_torch.envs.deepmimic_surface import (
        DeepMimicSurfaceEnv,
    )

    env = DeepMimicSurfaceEnv(clip="walk", n_substeps=2, device=dev)
    n_rec = DP_RECORDS * world
    agent = PPOAgent(state_size=env.state_size, action_size=env.action_size,
                     spec={"BatchSize": n_rec, "MiniBatchSize": 8,
                           "Epochs": 1}, group=group)
    params = replicate(agent.init(_generator(dev, SEED + 2), dev), group)
    # records from the surface: a batched reset, the policy's actions
    # (exploring on every other record) and one step.  JAX's records carry
    # zero actions with logp 0, far above the actor's own, so its ratio and
    # actor loss overflow (its dry run checks the critic loss alone); these
    # carry the actor's logps, so every loss is finite
    s0 = env.reset(_generator(dev, SEED + 4), n_rec)
    is_exp = torch.zeros(n_rec, dtype=torch.bool, device=dev)
    is_exp[::2] = True
    noise = torch.randn((n_rec, env.action_size),
                        generator=_generator(dev, SEED + 5), device=dev)
    with torch.no_grad():
        actions, logps = agent.decide_action(params, s0.obs, is_exp, noise)
        s1 = env.step(s0, actions)
    is_end = torch.zeros(n_rec, dtype=torch.bool, device=dev)
    is_end[-1] = True
    rows = rank_slice(n_rec, rank, world)
    params, m = agent.train_on_batch(
        params, rank_draws(SEED + 3, rank, dev, dp_draws.Draws),
        s0.obs[rows], actions[rows], logps[rows], s1.reward[rows],
        is_end[rows], is_end[rows], torch.zeros_like(is_end)[rows],
        is_exp[rows], 2)
    _finite("dp-PPO", **m)
    _synced("dp-PPO", sync_check(*dp_flat(params), group),
            agent.s_norm.check_synced(params["s_norm"], group),
            agent.val_norm.check_synced(params["val_norm"], group))
    return {"dp_ppo_closs": float(m["critic_loss"])}


def dryrun_rank(rank: int, world: int, device: str) -> dict:
    """One rank of the dry run: its TRPO, GAIL and dp-PPO steps; raises
    on a non-finite value or a diverged replica."""
    dev = rank_device(device)
    group = dist.group.WORLD
    collectives.tally.reset()
    out = {}
    for step in (_dry_trpo, _dry_gail, _dry_dp_ppo):
        out.update(step(rank, world, dev, group))
    out["collectives"] = collectives.tally.calls
    return out


def summary(world: int, res: dict) -> str:
    """JAX's summary line."""
    return (f"dryrun_multichip({world}): OK — meankl={res['meankl']:.5f}, "
            f"timesteps={res['timesteps']}, "
            f"gail_dloss={res['gail_dloss']:.4f}, "
            f"dp_ppo_closs={res['dp_ppo_closs']:.4f}")


# ---------------------------------------------------------------------------
# TRPO across ranks at other widths


def walk_learner(dev, n_envs: int, horizon: int, group=None) -> TRPO:
    """bench.py's TRPO learner: the walk on ``build_humanoid()``, a 56 → 28
    tanh 100×2 policy, g_step 1, on ``dev``."""
    from deepmimic_mujoco_torch.envs.dp_env_v3 import DPEnvV3
    from deepmimic_mujoco_torch.models.policy import MlpPolicy
    from deepmimic_mujoco_torch.physics.humanoid import build_humanoid

    return TRPO(DPEnvV3(model=build_humanoid(device=dev)),
                MlpPolicy(ob_dim=56, ac_dim=28),
                TRPOConfig(horizon=horizon, num_envs=n_envs, g_step=1),
                group)


def run_trpo(group, rank: int, world: int, device: str, n_global: int,
             horizon: int, seed: int = SEED,
             keep_segment: bool = False) -> dict:
    """One ``TRPO.iteration`` of the walk (bench.py's TRPO: 56 → 28 tanh
    100×2 policy, g_step 1) with ``n_global`` envs split over ``world``
    ranks (``group`` None: this process alone, ``world`` 1), from the
    global init of ``seed``, with :func:`rank_draws`.  Returns, on the
    host: the flat params (policy, vf, ob_rms; and the policy and ob_rms
    alone), ``sync_check``'s verdict,
    the stats, the wall seconds, the collectives made and their seconds,
    the APGD kernels' launches (none on the CPU) and, with
    ``keep_segment``, the rank's segment."""
    dev = rank_device(device)
    n_local = n_global // world
    rows = rank_slice(n_global, rank, world)
    state = walk_learner(dev, n_global, horizon).init(
        _generator(dev, seed))
    state = shard_state(state, rank, world, rank_draws(seed, rank, dev))
    learner = walk_learner(dev, n_local, horizon, group)
    replicate(state.params, group)
    rollout, kept = learner._rollout, {}

    def keep(*args, **kw):
        out = rollout(*args, **kw)
        kept["seg"] = {k: out[0][k].cpu() for k in SEG_KEYS}
        return out
    if keep_segment:
        learner._rollout = keep
    from deepmimic_mujoco_torch.ops import apgd as ops
    kernels = (ops.apgd_solve, ops.apgd_solve_lanes, ops.apgd_solve_wide)
    for fn in kernels:
        fn.launches = 0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    collectives.tally.reset()
    collectives.tally.timing = True
    t0 = time.perf_counter()
    state, stats = learner.iteration(state)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    collectives.tally.timing = False
    rec = {"rank": rank, "rows": (rows.start, rows.stop),
           "seconds": seconds, "env_steps": n_local * horizon,
           "collectives": collectives.tally.calls,
           "collective_s": collectives.tally.seconds,
           "flat": trpo_flat(state.params, state.vf_adam)[0].cpu(),
           "pol": flatten(policy_leaves(state.params)).cpu(),
           "ob_rms": [x.cpu() for x in state.params["ob_rms"]],
           "synced": sync_check(*trpo_flat(state.params, state.vf_adam),
                                group),
           **{k: float(getattr(stats, k)) for k in (
               "optimgain", "meankl", "entloss", "surrgain", "entropy",
               "ev_tdlam_before")}}
    rec["launches"] = {fn.__name__: fn.launches for fn in kernels}
    if keep_segment:
        rec["segment"] = kept["seg"]
    return rec


def trpo_rank(rank: int, world: int, device: str, n_global: int,
              horizon: int, seed: int = SEED,
              keep_segment: bool = False) -> dict:
    """:func:`run_trpo` on the launched group (for :func:`~deepmimic_mujoco_
    torch.parallel.mesh.launch`)."""
    return run_trpo(dist.group.WORLD, rank, world, device, n_global, horizon,
                    seed, keep_segment)


class FixedPerms(Draws):
    """The vf permutations given (the update's only draw)."""

    def __init__(self, perms: torch.Tensor):
        super().__init__(None)
        self.perms = perms

    def vf_permutations(self, n, epochs, device):
        return self.perms.to(device)


def segment_rank(rank: int, world: int, device: str, params: dict,
                 segs: list, perms: torch.Tensor) -> dict:
    """One ``TRPO._segment_update`` of the walk learner on the launched
    group from ``segs[rank]`` (host tensors, (T, B, ·)) and the shared
    params and vf permutations; returns, on the host, the policy, vf and
    ob_rms, Adam's m, the mean losses, the explained variance, the
    search's step, and ``sync_check``'s verdict."""
    dev = rank_device(device)
    seg = {k: v.to(dev) for k, v in segs[rank].items()}
    T, B = seg["rew"].shape
    learner = walk_learner(dev, B, T, dist.group.WORLD)
    params = tree_map(lambda x: x.to(dev), params)
    n_vf = sum(x.numel() for x in vf_leaves(params))
    p, vf_adam, losses, ev, info = learner._segment_update(
        params, adam.init(n_vf, dev), seg, FixedPerms(perms))
    return {"pol": flatten(policy_leaves(p)).cpu(),
            "vf": flatten(vf_leaves(p)).cpu(),
            "ob_rms": [x.cpu() for x in p["ob_rms"]],
            "adam_m": vf_adam.m.cpu(), "losses": losses.cpu(),
            "ev": ev.cpu(), "stepsize": info.stepsize,
            "accepted": info.accepted,
            "synced": sync_check(*trpo_flat(p, vf_adam), dist.group.WORLD)}


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="One TRPO, GAIL and dp-PPO step with the env batch "
                    "split over ranks (the JAX dryrun_multichip).")
    ap.add_argument("--nproc", type=int, default=None,
                    help="ranks to spawn on this machine; leave out under "
                         "torchrun")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl")
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds before the spawned ranks are stopped")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu")
    if args.nproc is not None:
        res = launch(dryrun_rank, args.nproc, args.backend,
                     args=(args.device,), device=args.device,
                     timeout=args.timeout)
        print(summary(args.nproc, res[0]))
        return 0
    if "WORLD_SIZE" not in os.environ:
        ap.error("give --nproc, or run under torchrun")
    if args.device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    rank = initialize_distributed(args.backend)
    try:
        res = dryrun_rank(rank, dist.get_world_size(), args.device)
        if rank == 0:
            print(summary(dist.get_world_size(), res))
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
