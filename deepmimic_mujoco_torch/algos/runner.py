"""Batched policy evaluation with optional trajectory export (port of
``deepmimic_mujoco_tpu/algos/runner.py:evaluate``)."""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from deepmimic_mujoco_torch.algos.trpo import pick_reset_fn
from deepmimic_mujoco_torch.envs.types import EnvState
from deepmimic_mujoco_torch.models import distributions


class Rollout(NamedTuple):
    ep_ret: torch.Tensor    # (B,) return until each env's first done
    ep_len: torch.Tensor    # (B,) length until each env's first done
    state: EnvState         # final state (finished envs frozen at their done)
    traj: Optional[tuple]   # (obs, acs, rews), each (T, B, ·), when recorded


class EvalResult(NamedTuple):
    avg_len: float
    avg_ret: float
    rollout: Rollout


def rollout(env, policy, params: dict, state: EnvState, horizon: int,
            stochastic: bool = False,
            generator: Optional[torch.Generator] = None,
            record: bool = False,
            keep: Optional[Callable[[int, EnvState, torch.Tensor],
                                    None]] = None) -> Rollout:
    """Run every env of ``state`` for ``horizon`` steps.  After an env's
    first done its state is frozen and it adds nothing to its return and
    length (the JAX rollout's alive mask).  Actions are the policy mean, or
    samples from ``generator`` when ``stochastic``.  ``keep(t, state,
    action)``, when given, sees each step's state and action before the
    step (the divergence checks of ``utils/divergence.py``)."""
    B = state.qpos.shape[0]
    alive = torch.ones(B, dtype=torch.bool, device=state.qpos.device)
    ep_ret = torch.zeros(B, device=state.qpos.device)
    ep_len = torch.zeros(B, dtype=torch.int64, device=state.qpos.device)
    obs, acs, rews = [], [], []
    for t in range(horizon):
        ob = state.obs
        mean, logstd = policy.mean_logstd(params, ob)
        ac = (distributions.diag_gaussian.sample(generator, mean, logstd)
              if stochastic else distributions.diag_gaussian.mode(mean, logstd))
        if keep is not None:
            keep(t, state, ac)
        nxt = env.step(state, ac)
        ep_ret = ep_ret + torch.where(alive, nxt.reward,
                                      torch.zeros_like(nxt.reward))
        ep_len = ep_len + alive.long()
        if record:
            obs.append(ob)
            acs.append(ac)
            rews.append(nxt.reward)
        state = nxt.where(alive, state)
        alive = alive & ~nxt.done
    traj = ((torch.stack(obs), torch.stack(acs), torch.stack(rews))
            if record else None)
    return Rollout(ep_ret, ep_len, state, traj)


def evaluate(env, policy, params: dict, generator: torch.Generator,
             n_episodes: int = 100, horizon: int = 1024,
             stochastic: bool = False, save_path: Optional[str] = None,
             reset_mode: str = "rsi") -> EvalResult:
    """Run ``n_episodes`` envs in parallel for up to ``horizon`` steps each.
    ``reset_mode``: 'rsi' starts from random mocap frames (the reference
    runner), 'noise' from the training distribution.  ``save_path`` writes
    the per-episode obs/acs/rews (cut at each episode's length), ep_rets and
    lens as ``.npz``, like the JAX export."""
    state = pick_reset_fn(env, reset_mode)(generator, n_episodes)
    out = rollout(env, policy, params, state, horizon, stochastic=stochastic,
                  generator=generator, record=save_path is not None)
    avg_len = float(out.ep_len.float().mean())
    avg_ret = float(out.ep_ret.mean())
    if save_path is not None:
        obs, acs, rews = (t.swapaxes(0, 1).cpu().numpy() for t in out.traj)
        lens = out.ep_len.cpu().numpy()

        def ragged(arrs):
            res = np.empty(len(arrs), dtype=object)
            for i, a in enumerate(arrs):
                res[i] = a
            return res

        np.savez(save_path,
                 obs=ragged([o[:n] for o, n in zip(obs, lens)]),
                 acs=ragged([a[:n] for a, n in zip(acs, lens)]),
                 rews=ragged([r[:n] for r, n in zip(rews, lens)]),
                 ep_rets=out.ep_ret.cpu().numpy(), lens=lens)
    return EvalResult(avg_len, avg_ret, out)
