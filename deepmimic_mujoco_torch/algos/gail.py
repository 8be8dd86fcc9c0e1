"""GAIL, adversarial imitation on the TRPO core (port of
``deepmimic_mujoco_tpu/algos/gail.py``).

Against plain TRPO:

* the rollout's learning signal is the discriminator's reward
  −log(1−σ(D(ob, ac))) (a reward hook on TRPO's rollout); the env's true
  reward is summed on the side (``ep_true``) for the episode records;
* after the ``g_step`` policy updates, the discriminator takes its Adam
  steps (lr ``d_stepsize``) on the last segment against expert batches,
  updating its obs-RMS from the generator and expert obs of each minibatch
  before that minibatch's gradient.

The d-step's exact mode (``d_exact``, the CLI's default) shuffles the last
segment once and sweeps it in ``d_step`` sequential minibatches, pairing
each with the next sequential slice of the expert arrays (a cursor,
``expert_ptr``, that wraps); the legacy mode draws ``d_step·d_batches``
random subsamples.  Every draw goes through the TRPO state's ``Draws``; the
cursor and every statistic stay on the device, and an iteration reads
nothing back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from deepmimic_mujoco_torch.algos import adam
from deepmimic_mujoco_torch.algos.adversary import TransitionClassifier
from deepmimic_mujoco_torch.algos.trpo import (
    TRPO,
    Draws,
    IterStats,
    TRPOConfig,
    TRPOState,
    _layers,
    _unflatten,
    flatten,
)
from deepmimic_mujoco_torch.utils import running_stats


class GAILConfig(NamedTuple):
    trpo: TRPOConfig = TRPOConfig(horizon=1024, num_envs=1)
    d_step: int = 1
    d_stepsize: float = 3e-4
    d_batches: int = 4      # minibatches per d_step (d_exact=False)
    d_exact: bool = True


@dataclasses.dataclass(frozen=True)
class GAILState:
    trpo: TRPOState
    d_params: dict              # net / obs_rms of the discriminator
    d_adam: adam.AdamState
    expert_ptr: torch.Tensor    # () int64: the sequential expert cursor


class GAILStats(NamedTuple):
    trpo: IterStats             # ep_rets and ep_ret_sum: discriminator returns
    d_loss: Any
    gen_acc: Any
    exp_acc: Any
    true_ep_ret_sum: Any
    true_ep_rets: Any = None    # (g_step, T, B) TRUE env returns, aligned
                                # with trpo.ep_lens


def disc_leaves(d_params: dict) -> list[torch.Tensor]:
    """The discriminator's ``net`` flattened as JAX does: b, w per layer."""
    return [layer[k] for layer in d_params["net"] for k in ("b", "w")]


class GAIL:
    """A TRPO learner whose rollouts are rewarded by a discriminator
    trained against ``expert_obs`` / ``expert_acs`` (numpy or tensors,
    moved to the env's device)."""

    def __init__(self, env, policy, expert_obs, expert_acs,
                 config: GAILConfig = GAILConfig(),
                 adversary_hidden: int = 100,
                 adversary_entcoeff: float = 1e-3):
        self.cfg = config
        self.trpo = TRPO(env, policy, config.trpo)
        self.env = env
        self.policy = policy
        self.device = env.device
        self.disc = TransitionClassifier(
            ob_dim=env.observation_size, ac_dim=env.action_size,
            hidden_size=adversary_hidden, entcoeff=adversary_entcoeff)
        self.expert_obs = torch.as_tensor(np.asarray(expert_obs, np.float32),
                                          device=self.device)
        self.expert_acs = torch.as_tensor(np.asarray(expert_acs, np.float32),
                                          device=self.device)

    def init(self, generator: torch.Generator) -> GAILState:
        """TRPO's init, then random discriminator parameters, from
        ``generator``."""
        trpo_state = self.trpo.init(generator)
        d_params = self.disc.init(generator, self.device)
        n_d = sum(x.numel() for x in disc_leaves(d_params))
        return GAILState(
            trpo=trpo_state, d_params=d_params,
            d_adam=adam.init(n_d, self.device),
            expert_ptr=torch.zeros((), dtype=torch.int64, device=self.device))

    # ------------------------------------------------------------------
    def _d_indices(self, n: int, expert_ptr: torch.Tensor, draws: Draws):
        """(g_idx, e_idx), each (n_mb, mb), and the advanced cursor."""
        cfg, n_exp = self.cfg, self.expert_obs.shape[0]
        if cfg.d_exact:
            mb, n_mb = max(1, n // cfg.d_step), cfg.d_step
            perm = draws.d_permutation(n, self.device)
            g_idx = perm[:n_mb * mb].reshape(n_mb, mb)
            e_idx = (expert_ptr + torch.arange(
                n_mb * mb, device=self.device).reshape(n_mb, mb)) % n_exp
            return g_idx, e_idx, (expert_ptr + n_mb * mb) % n_exp
        mb, n_mb = max(1, n // cfg.d_batches), cfg.d_step * cfg.d_batches
        g_idx, e_idx = draws.d_subsamples(n, n_exp, n_mb, mb, self.device)
        return g_idx, e_idx, expert_ptr

    def _d_update(self, d_params: dict, d_adam: adam.AdamState,
                  expert_ptr: torch.Tensor, ob: torch.Tensor,
                  ac: torch.Tensor, draws: Draws):
        """The discriminator's Adam steps on the segment's rows ``ob``,
        ``ac`` (time-major (T·B, ·)): returns (d_params, d_adam, expert_ptr,
        [mean loss, mean generator accuracy, mean expert accuracy])."""
        g_idx, e_idx, expert_ptr = self._d_indices(ob.shape[0], expert_ptr,
                                                   draws)
        like = disc_leaves(d_params)
        d_flat = flatten(like).detach()
        obs_rms = d_params["obs_rms"]
        g_obs, g_acs = ob[g_idx], ac[g_idx]
        e_obs, e_acs = self.expert_obs[e_idx], self.expert_acs[e_idx]
        records = []
        for k in range(g_idx.shape[0]):
            obs_rms = running_stats.update(obs_rms,
                                           torch.cat([g_obs[k], e_obs[k]]))
            theta = d_flat.requires_grad_(True)
            p = {"net": _layers(_unflatten(theta, like)), "obs_rms": obs_rms}
            loss, metrics = self.disc.loss(p, g_obs[k], g_acs[k], e_obs[k],
                                           e_acs[k])
            grad = torch.autograd.grad(loss, theta)[0]
            with torch.no_grad():
                d_flat, d_adam = adam.update(d_adam, grad, theta.detach(),
                                             self.cfg.d_stepsize)
            records.append(torch.stack([loss.detach(),
                                        metrics["generator_acc"],
                                        metrics["expert_acc"]]))
        d_params = {"net": _layers(_unflatten(d_flat.detach(), like)),
                    "obs_rms": obs_rms}
        return d_params, d_adam, expert_ptr, torch.stack(records).mean(0)

    # ------------------------------------------------------------------
    def iteration(self, state: GAILState) -> tuple[GAILState, GAILStats]:
        """``g_step`` segments rewarded by the discriminator, each followed
        by a TRPO update, then the d-step on the last segment."""
        cfg = self.trpo.cfg
        t = state.trpo
        params, vf_adam, draws = t.params, t.vf_adam, t.draws
        env_state, new = t.env_state, t.new
        ep_ret, ep_len = t.cur_ep_ret, t.cur_ep_len
        d_params = state.d_params
        rets, lens, trues = [], [], []

        def reward_fn(ob, ac):
            return self.disc.reward(d_params, ob, ac)

        for _ in range(cfg.g_step):
            seg, env_state, new, ep_ret, ep_len = self.trpo._rollout(
                params, env_state, new, draws, ep_ret, ep_len,
                reward_fn=reward_fn)
            params, vf_adam, meanlosses, ev, _ = self.trpo._segment_update(
                params, vf_adam, seg, draws)
            rets.append(seg["ep_rets"])
            lens.append(seg["ep_lens"])
            trues.append(seg["ep_true"])
        d_params, d_adam, expert_ptr, d_rec = self._d_update(
            d_params, state.d_adam, state.expert_ptr,
            seg["ob"].reshape(-1, seg["ob"].shape[-1]),
            seg["ac"].reshape(-1, seg["ac"].shape[-1]), draws)
        rets, lens, trues = (torch.stack(x) for x in (rets, lens, trues))
        stats = GAILStats(
            trpo=IterStats(
                optimgain=meanlosses[0], meankl=meanlosses[1],
                entloss=meanlosses[2], surrgain=meanlosses[3],
                entropy=meanlosses[4], ev_tdlam_before=ev,
                ep_ret_sum=rets.sum(), ep_len_sum=lens.sum(),
                ep_count=(lens > 0).sum().float(),
                timesteps=torch.tensor(float(cfg.g_step * cfg.horizon
                                             * cfg.num_envs),
                                       device=self.device),
                ep_len_sum_last=lens[-1].sum().float(),
                ep_rets=rets, ep_lens=lens),
            d_loss=d_rec[0], gen_acc=d_rec[1], exp_acc=d_rec[2],
            true_ep_ret_sum=trues.sum(), true_ep_rets=trues)
        new_trpo = TRPOState(params=params, vf_adam=vf_adam,
                             env_state=env_state, new=new, draws=draws,
                             cur_ep_ret=ep_ret, cur_ep_len=ep_len)
        return GAILState(trpo=new_trpo, d_params=d_params, d_adam=d_adam,
                         expert_ptr=expert_ptr), stats
