"""Vectorized clipped-surrogate PPO (port of ``deepmimic_mujoco_tpu/algos/
ppo.py``): a rollout of every env → GAE(λ) → obs-RMS update → ``epochs``
epochs of shuffled-minibatch Adam on ``L_clip + vf_coef·L_vf −
ent_coef·H`` over the flat ``{logstd, pol, vf}`` vector (JAX's ravel
order), with global grad-norm clipping.

JAX's details kept: the old policy's neglogp is recomputed under the
UPDATED obs-RMS before the epochs; the frozen-logstd mask is applied to
the gradient before the norm clip; the advantage is standardized per
minibatch with the population std plus 1e-8; the stats are those of the
last minibatch of the last epoch; ``lr_scale`` is multiplied by
``lr_decay`` after each iteration.  The rollout is TRPO's, whose action
noise, reset states and the epochs' permutations go through ``Draws``.
Across ranks (``group``) the obs-RMS sums are summed and each minibatch's
gradient averaged over the group, as JAX's ``axis_name`` collectives do;
the minibatch stats stay the rank's own.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from deepmimic_mujoco_torch.algos import adam
from deepmimic_mujoco_torch.algos.gae import add_vtarg_and_adv
from deepmimic_mujoco_torch.algos.trpo import (
    TRPO,
    Draws,
    IterStats,
    _layers,
    _unflatten,
    flatten,
    pick_reset_fn,
    policy_leaves,
    vf_leaves,
)
from deepmimic_mujoco_torch.envs.types import EnvState
from deepmimic_mujoco_torch.models import distributions
from deepmimic_mujoco_torch.parallel.collectives import maybe_pmean
from deepmimic_mujoco_torch.utils.math import explained_variance


class PPOConfig(NamedTuple):
    """The JAX package's defaults."""

    horizon: int = 64
    num_envs: int = 256
    gamma: float = 0.95
    lam: float = 0.95
    clip_ratio: float = 0.2
    epochs: int = 4
    minibatches: int = 8
    lr: float = 3e-4
    vf_coef: float = 0.5
    ent_coef: float = 0.0
    max_grad_norm: float = 0.5
    reset_mode: str = "noise"
    lr_decay: float = 1.0   # lr multiplied by this after each iteration


@dataclasses.dataclass(frozen=True)
class PPOState:
    params: dict
    opt: adam.AdamState         # over the flat {logstd, pol, vf} vector
    env_state: EnvState
    new: torch.Tensor
    draws: Draws                # in place of the JAX state's PRNG key
    cur_ep_ret: torch.Tensor
    cur_ep_len: torch.Tensor
    lr_scale: torch.Tensor      # () float32


def train_leaves(params: dict) -> list[torch.Tensor]:
    """``{logstd, pol, vf}`` flattened as JAX does (keys sorted)."""
    return policy_leaves(params) + vf_leaves(params)


def _with_train(params: dict, theta: torch.Tensor, like: list) -> dict:
    """``params`` with logstd, pol and vf taken from the flat ``theta``."""
    leaves = _unflatten(theta, like)
    n_pol = len(policy_leaves(params))
    return {**params, "logstd": leaves[0], "pol": _layers(leaves[1:n_pol]),
            "vf": _layers(leaves[n_pol:])}


class PPO:
    """Couples a batched env and an ``MlpPolicy`` with the PPO update."""

    # TRPO's rollout: JAX's PPO._rollout repeats it and also records each
    # action's neglogp, which the update recomputes under the new obs-RMS
    # before any use, so the port records none
    _rollout = TRPO._rollout

    def __init__(self, env, policy, config: PPOConfig = PPOConfig(),
                 group=None):
        self.env = env
        self.policy = policy
        self.cfg = config
        self.group = group
        self.device = env.device
        self._reset_fn = pick_reset_fn(env, config.reset_mode)

    def init(self, generator: torch.Generator) -> PPOState:
        """Random policy parameters and RSI starts, from ``generator``."""
        B = self.cfg.num_envs
        params = self.policy.init(generator, self.device)
        n = sum(x.numel() for x in train_leaves(params))
        return PPOState(
            params=params, opt=adam.init(n, self.device),
            env_state=self.env.reset(generator, B),
            new=torch.ones(B, dtype=torch.bool, device=self.device),
            draws=Draws(generator),
            cur_ep_ret=torch.zeros(B, device=self.device),
            cur_ep_len=torch.zeros(B, dtype=torch.int32, device=self.device),
            lr_scale=torch.ones((), device=self.device))

    # ------------------------------------------------------------------
    def _loss(self, params: dict, theta: torch.Tensor, like: list,
              ob, ac, adv, ret, nlp_old):
        """(loss, [pg_loss, vf_loss, entropy, clipfrac, kl]) at ``theta``."""
        cfg = self.cfg
        p = _with_train(params, theta, like)
        mean, logstd = self.policy.mean_logstd(p, ob)
        nlp = distributions.diag_gaussian.neglogp(mean, logstd, ac)
        ratio = torch.exp(nlp_old - nlp)
        a = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        clipped = torch.clamp(ratio, 1.0 - cfg.clip_ratio,
                              1.0 + cfg.clip_ratio)
        pg_loss = -torch.mean(torch.minimum(ratio * a, clipped * a))
        vf_loss = torch.mean(torch.square(self.policy.value(p, ob) - ret))
        ent = torch.mean(distributions.diag_gaussian.entropy(logstd))
        loss = pg_loss + cfg.vf_coef * vf_loss - cfg.ent_coef * ent
        clipfrac = torch.mean(
            (torch.abs(ratio - 1.0) > cfg.clip_ratio).float())
        kl = torch.mean(nlp - nlp_old)   # E[log(old/new)]
        return loss, torch.stack([pg_loss, vf_loss, ent, clipfrac, kl])

    def _update(self, params: dict, opt: adam.AdamState, ob, ac, adv, ret,
                nlp_old, lr, draws: Draws):
        """``epochs`` × ``minibatches`` Adam steps: returns (params, opt,
        the last minibatch's [pg_loss, vf_loss, entropy, clipfrac, kl])."""
        cfg = self.cfg
        like = train_leaves(params)
        theta = flatten(like).detach()
        mask = None
        if self.policy.fixed_logstd is not None:
            mask = torch.ones_like(theta)
            mask[:like[0].numel()] = 0.0
        n = ob.shape[0]
        mb = n // cfg.minibatches
        aux = None
        for perm in draws.epoch_permutations(n, cfg.epochs, ob.device):
            idx = perm[:cfg.minibatches * mb].reshape(cfg.minibatches, mb)
            mbs = [x[idx] for x in (ob, ac, adv, ret, nlp_old)]
            for k in range(cfg.minibatches):
                th = theta.requires_grad_(True)
                loss, aux = self._loss(params, th, like,
                                       *(x[k] for x in mbs))
                g = maybe_pmean(torch.autograd.grad(loss, th)[0],
                                self.group)
                with torch.no_grad():
                    # the frozen-logstd mask before the norm clip, so the
                    # clip's norm holds no discarded component
                    if mask is not None:
                        g = g * mask
                    gnorm = torch.linalg.vector_norm(g)
                    g = g * torch.clamp(
                        cfg.max_grad_norm / torch.clamp(gnorm, min=1e-8),
                        max=1.0)
                    theta, opt = adam.update(opt, g, th.detach(), lr)
        return _with_train(params, theta, like), opt, aux.detach()

    def iteration(self, state: PPOState) -> tuple[PPOState, IterStats]:
        """One rollout of every env, then the epochs of minibatch Adam."""
        cfg = self.cfg
        seg, env_state, new, ep_ret, ep_len = self._rollout(
            state.params, state.env_state, state.new, state.draws,
            state.cur_ep_ret, state.cur_ep_len)
        ob = seg["ob"].reshape(-1, seg["ob"].shape[-1])
        ac = seg["ac"].reshape(-1, seg["ac"].shape[-1])
        adv, tdlamret = add_vtarg_and_adv(seg["rew"], seg["vpred"],
                                          seg["new"], seg["nextvpred"],
                                          cfg.gamma, cfg.lam)
        adv, ret = adv.reshape(-1), tdlamret.reshape(-1)
        params = self.policy.update_ob_rms(state.params, ob, self.group)
        with torch.no_grad():
            nlp_old = self.policy.neglogp(params, ob, ac)
        params, opt, aux = self._update(params, state.opt, ob, ac, adv, ret,
                                        nlp_old, cfg.lr * state.lr_scale,
                                        state.draws)
        pg_l, _, ent, _, kl = aux
        stats = IterStats(
            optimgain=-pg_l, meankl=kl, entloss=-cfg.ent_coef * ent,
            surrgain=-pg_l, entropy=ent,
            ev_tdlam_before=explained_variance(seg["vpred"].reshape(-1), ret),
            ep_ret_sum=seg["ep_ret_sum"], ep_len_sum=seg["ep_len_sum"],
            ep_count=seg["ep_count"].float(),
            timesteps=torch.tensor(float(cfg.horizon * cfg.num_envs),
                                   device=self.device),
            ep_len_sum_last=seg["ep_len_sum"].float(),
            ep_rets=seg["ep_rets"][None], ep_lens=seg["ep_lens"][None])
        return PPOState(params=params, opt=opt, env_state=env_state, new=new,
                        draws=state.draws, cur_ep_ret=ep_ret,
                        cur_ep_len=ep_len,
                        lr_scale=state.lr_scale * cfg.lr_decay), stats
