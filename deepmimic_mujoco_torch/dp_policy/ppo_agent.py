"""PPO agent of the original DeepMimic learning stack (port of
``deepmimic_mujoco_tpu/dp_policy/ppo_agent.py``).

* fc_2layers_1024units actor and critic on normalized states;
* fixed exploration noise: a = mean + noise·a_norm.std·N(0, 1), with the
  logp of the *normalized* noise;
* critic loss ½·mean((norm(target) − norm(V))²); actor loss the clipped
  surrogate plus the bound loss on the normalized mean plus weight decay;
* TD(λ) targets per path, bounded to [val_min, val_max] from the reward
  bounds; advantages standardized over the exploring records and clipped
  to ±NormAdvClip;
* TF momentum for the critic and the actor, each with its own state;
* the actor stepsize adapted to the clip fraction (off at TarClipFrac −1);
* hyperparameters from the JSON spec format.

Parameters are a dict with JAX's keys and leaves (``io_utils/checkpoint``
reads and writes them in JAX's layout).  The gradients come from
``torch.autograd``; the random draws from a :class:`~deepmimic_mujoco_torch.
dp_policy.draws.Draws`.  Across ranks (``group``) the critic's and the
actor's gradients and the mean losses are averaged over the group and the
normalizers' sums summed, at JAX's ``axis_name`` points; the advantage
statistics and the sample count stay the rank's own, as in JAX."""

from __future__ import annotations

import json
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from deepmimic_mujoco_torch.dp_policy import normalizer
from deepmimic_mujoco_torch.dp_policy.draws import Draws
from deepmimic_mujoco_torch.dp_policy.exp_params import ExpParams
from deepmimic_mujoco_torch.dp_policy.nets import apply_relu_mlp, build_net
from deepmimic_mujoco_torch.models.mlp import normc_init
from deepmimic_mujoco_torch.parallel.collectives import maybe_pmean

_LOG2PI = float(np.log(2.0 * np.pi))


class MomentumState(NamedTuple):
    """TF MomentumOptimizer accumulator: one tensor per parameter, in the
    parameters' list-of-layers layout."""

    m: Any


def momentum_update(state: MomentumState, grads: list, params: list, lr,
                    momentum: float = 0.9):
    """m ← μ·m + g, p ← p − lr·m, per leaf of a list of layer dicts."""
    m = [{k: momentum * a[k] + g[k] for k in a}
         for a, g in zip(state.m, grads)]
    params = [{k: p[k] - lr * a[k] for k in p} for p, a in zip(params, m)]
    return params, MomentumState(m=m)


DEFAULT_SPEC = {
    "AgentType": "PPO",
    "ActorNet": "fc_2layers_1024units",
    "ActorStepsize": 2.5e-6,
    "ActorMomentum": 0.9,
    "ActorWeightDecay": 0.0005,
    "ActorInitOutputScale": 0.01,
    "CriticNet": "fc_2layers_1024units",
    "CriticStepsize": 0.01,
    "CriticMomentum": 0.9,
    "CriticWeightDecay": 0,
    "Discount": 0.95,
    "BatchSize": 4096,
    "MiniBatchSize": 256,
    "Epochs": 1,
    "ReplayBufferSize": 500000,
    "RatioClip": 0.2,
    "NormAdvClip": 4,
    "TDLambda": 0.95,
    "TarClipFrac": -1,
    "ActorStepsizeDecay": 0.5,
    "ExpAnnealSamples": 64000000,
    "ExpParamsBeg": {"Rate": 1, "Noise": 0.05},
    "ExpParamsEnd": {"Rate": 0.2, "Noise": 0.05},
}


def _with_grad(layers: list) -> list:
    return [{k: v.detach().requires_grad_() for k, v in layer.items()}
            for layer in layers]


def _grads(loss: torch.Tensor, layers: list, group=None) -> list:
    """d loss / d layers, averaged over ``group``'s ranks where given."""
    leaves = [v for layer in layers for v in layer.values()]
    g = iter(maybe_pmean(list(torch.autograd.grad(loss, leaves)), group))
    return [{k: next(g) for k in layer} for layer in layers]


def td_lambda_targets(vals: np.ndarray, vnext: np.ndarray,
                      rewards: np.ndarray, is_end: np.ndarray,
                      gamma: float, lam: float) -> np.ndarray:
    """JAX's reverse scan of ``train_on_batch`` on the host, in f32:
    ret_i = v_i at an end record, else r_i + γ·((1−λ)·vnext_i + λ·ret_{i+1}),
    and 0 past the last record.  Records at the same distance from the
    next end record are independent: the scan runs over the distances
    (at most the longest path), each step over all records at that
    distance, with the scan's f32 arithmetic per record."""
    n = vals.shape[0]
    f32 = np.float32
    ends = np.append(np.flatnonzero(is_end), n)  # a zero record past the last
    rows = np.arange(n)
    dist = ends[np.searchsorted(ends, rows)] - rows
    ret = np.zeros(n + 1, f32)
    ret[:n] = np.where(is_end, vals, f32(0))
    g, a, b = f32(gamma), f32(1 - lam), f32(lam)
    order = np.argsort(dist, kind="stable")
    bounds = np.cumsum(np.bincount(dist, minlength=1))
    for k in range(1, bounds.shape[0]):
        i = order[bounds[k - 1]:bounds[k]]
        ret[i] = rewards[i] + g * (a * vnext[i] + b * ret[i + 1])
    return ret[:n]


class PPOAgent:
    # flag bit marking exploring actions: only these train the actor
    EXP_ACTION_FLAG = 1

    def __init__(self, state_size: int, action_size: int,
                 spec: Optional[dict] = None,
                 action_bounds: Optional[tuple] = None,
                 reward_bounds: tuple = (0.0, 1.0),
                 state_norm_groups: Optional[np.ndarray] = None,
                 state_offset: Optional[np.ndarray] = None,
                 state_scale: Optional[np.ndarray] = None, group=None):
        self.spec = {**DEFAULT_SPEC, **(spec or {})}
        self.group = group
        s = self.spec
        self.state_size = state_size
        self.action_size = action_size
        self.discount = float(s["Discount"])
        self.td_lambda = float(s["TDLambda"])
        self.ratio_clip = float(s["RatioClip"])
        self.norm_adv_clip = float(s["NormAdvClip"])
        self.mini_batch_size = int(s["MiniBatchSize"])
        self.batch_size = int(s["BatchSize"])
        self.epochs = int(s["Epochs"])
        self.actor_wd = float(s["ActorWeightDecay"])
        self.critic_wd = float(s["CriticWeightDecay"])
        self.tar_clip_frac = float(s["TarClipFrac"])
        self.stepsize_decay = float(s["ActorStepsizeDecay"])
        self.exp_beg = ExpParams.from_json(s["ExpParamsBeg"])
        self.exp_end = ExpParams.from_json(s["ExpParamsEnd"])
        self.exp_anneal_samples = float(s["ExpAnnealSamples"])

        # value bounds from the reward bounds
        r_min, r_max = reward_bounds
        self.val_min = r_min / (1.0 - self.discount)
        self.val_max = r_max / (1.0 - self.discount)

        if action_bounds is None:
            action_bounds = (-0.5 * np.ones(action_size),
                             0.5 * np.ones(action_size))
        self.a_bound_min = torch.as_tensor(
            np.asarray(action_bounds[0], np.float32))
        self.a_bound_max = torch.as_tensor(
            np.asarray(action_bounds[1], np.float32))
        self._bounds_on: dict = {}

        # the state normalizer starts from the env's builders: mean
        # −offset, std 1/scale, the env's norm groups
        self.s_norm = normalizer.make(state_size, groups_ids=state_norm_groups)
        self._s_init_mean = (None if state_offset is None
                             else -np.asarray(state_offset, np.float32))
        self._s_init_std = (None if state_scale is None
                            else 1.0 / np.asarray(state_scale, np.float32))
        self.a_norm = normalizer.make(action_size)
        self.val_norm = normalizer.make(1)

    @classmethod
    def for_env(cls, env, spec: Optional[dict] = None, **kwargs) -> "PPOAgent":
        """An agent bootstrapped from the env's DeepMimic-API builders."""
        bounds = None
        if hasattr(env, "build_action_bound_min"):
            bounds = (np.asarray(env.build_action_bound_min()),
                      np.asarray(env.build_action_bound_max()))
        return cls(
            state_size=env.observation_size, action_size=env.action_size,
            spec=spec, action_bounds=bounds,
            state_norm_groups=(np.asarray(env.build_state_norm_groups(),
                                          np.int32)
                               if hasattr(env, "build_state_norm_groups")
                               else None),
            state_offset=(env.build_state_offset()
                          if hasattr(env, "build_state_offset") else None),
            state_scale=(env.build_state_scale()
                         if hasattr(env, "build_state_scale") else None),
            **kwargs)

    def _bounds(self, device: torch.device):
        if device not in self._bounds_on:
            self._bounds_on[device] = (self.a_bound_min.to(device),
                                       self.a_bound_max.to(device))
        return self._bounds_on[device]

    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator,
             device: torch.device | str = "cpu") -> dict:
        """Random nets from ``generator`` (on ``device``); the actor's
        output layer scaled by ActorInitOutputScale; a_norm's mean the
        midpoint of the action bounds and its std their half-span."""
        actor = build_net(self.spec["ActorNet"], generator, self.state_size,
                          self.action_size, device)
        critic = build_net(self.spec["CriticNet"], generator, self.state_size,
                           1, device)
        actor[-1]["w"] = normc_init(
            generator, tuple(actor[-1]["w"].shape),
            scale=float(self.spec["ActorInitOutputScale"]), device=device)
        bmin, bmax = self._bounds(torch.device(device))
        return {
            "actor": actor,
            "critic": critic,
            "s_norm": normalizer.init(self.state_size, self._s_init_mean,
                                      self._s_init_std, device),
            "a_norm": normalizer.init(self.action_size, 0.5 * (bmin + bmax),
                                      0.5 * (bmax - bmin), device),
            "val_norm": normalizer.init(1, device=device),
            "actor_opt": MomentumState([{k: torch.zeros_like(v)
                                         for k, v in layer.items()}
                                        for layer in actor]),
            "critic_opt": MomentumState([{k: torch.zeros_like(v)
                                          for k, v in layer.items()}
                                         for layer in critic]),
            "actor_stepsize": torch.tensor(
                float(self.spec["ActorStepsize"]), device=device),
            "sample_count": torch.zeros((), device=device),
        }

    # ------------------------------------------------------------------
    def exp_params_at(self, sample_count: torch.Tensor):
        """(rate, noise) annealed by the sample count, in f32."""
        t = torch.clamp(sample_count / self.exp_anneal_samples, 0.0, 1.0)
        rate = (1 - t) * self.exp_beg.rate + t * self.exp_end.rate
        noise = (1 - t) * self.exp_beg.noise + t * self.exp_end.noise
        return rate, noise

    def actor_mean(self, params: dict, s: torch.Tensor) -> torch.Tensor:
        s_n = self.s_norm.normalize(params["s_norm"], s)
        return apply_relu_mlp(params["actor"], s_n)

    def eval_critic(self, params: dict, s: torch.Tensor) -> torch.Tensor:
        s_n = self.s_norm.normalize(params["s_norm"], s)
        v_n = apply_relu_mlp(params["critic"], s_n)
        return self.val_norm.unnormalize(params["val_norm"], v_n)[..., 0]

    def decide_action(self, params: dict, s: torch.Tensor,
                      exploring: torch.Tensor, noise: torch.Tensor):
        """(action, logp) of (B, state) states: mean + noise·a_norm.std on
        the exploring rows, with the logp of the normalized noise (also on
        the others).  ``noise`` is N(0, 1) of the mean's shape."""
        _, noise_std = self.exp_params_at(params["sample_count"])
        mean = self.actor_mean(params, s)
        norm_noise = noise_std * noise * exploring.to(mean.dtype)[..., None]
        a = mean + norm_noise * params["a_norm"].std
        logp = (-0.5 * torch.sum(torch.square(norm_noise / noise_std), -1)
                - 0.5 * self.action_size * _LOG2PI
                - self.action_size * torch.log(noise_std))
        return a, logp

    def get_action(self, params: dict, s) -> torch.Tensor:
        """Deterministic action for inference."""
        return self.actor_mean(params, torch.as_tensor(s, dtype=torch.float32))

    # ------------------------------------------------------------------
    def compute_new_vals(self, rewards: torch.Tensor, vals: torch.Tensor,
                         path_end: torch.Tensor) -> torch.Tensor:
        """TD(λ) targets per path of ``update``: a backward scan that
        resets at path ends; ``vals`` has one bootstrap entry more."""
        lam, gamma = self.td_lambda, self.discount
        nonterm = 1.0 - path_end.to(rewards.dtype)
        out, carry = [], torch.zeros_like(rewards[0])
        for t in range(rewards.shape[0] - 1, -1, -1):
            carry = (rewards[t] + gamma * ((1 - lam) * vals[t + 1]
                                           + lam * carry) * nonterm[t]
                     + gamma * vals[t + 1] * (1.0 - nonterm[t]) * 0.0)
            out.append(carry)
        return torch.stack(out[::-1])

    def _critic_loss(self, params, s, tar_vals):
        s_n = self.s_norm.normalize(params["s_norm"], s)
        v_n = apply_relu_mlp(params["critic"], s_n)[..., 0]
        tar_n = self.val_norm.normalize(params["val_norm"],
                                        tar_vals[..., None])[..., 0]
        loss = 0.5 * torch.mean(torch.square(tar_n - v_n))
        if self.critic_wd:
            loss = loss + self.critic_wd * 0.5 * sum(
                torch.sum(torch.square(layer["w"]))
                for layer in params["critic"])
        return loss

    def _bound_loss(self, params, norm_mean):
        """Bound loss on the normalized mean."""
        lo, hi = self._bounds(norm_mean.device)
        bmin = self.a_norm.normalize(params["a_norm"], lo)
        bmax = self.a_norm.normalize(params["a_norm"], hi)
        v_min = torch.clamp(norm_mean - bmin, max=0.0)
        v_max = torch.clamp(norm_mean - bmax, min=0.0)
        return 0.5 * torch.mean(torch.sum(torch.square(v_min), -1)
                                + torch.sum(torch.square(v_max), -1))

    def _actor_loss(self, params, s, a, old_logp, adv):
        """Clipped-surrogate actor loss plus the bound loss and weight
        decay; returns (loss, clip_frac)."""
        _, noise_std = self.exp_params_at(params["sample_count"])
        mean = self.actor_mean(params, s)
        norm_mean = self.a_norm.normalize(params["a_norm"], mean)
        norm_a = self.a_norm.normalize(params["a_norm"], a)
        logp = (-0.5 * torch.sum(torch.square((norm_a - norm_mean)
                                              / noise_std), -1)
                - 0.5 * self.action_size * _LOG2PI
                - self.action_size * torch.log(noise_std))
        ratio = torch.exp(logp - old_logp)
        surr0 = adv * ratio
        surr1 = adv * torch.clamp(ratio, 1.0 - self.ratio_clip,
                                  1.0 + self.ratio_clip)
        loss = -torch.mean(torch.minimum(surr0, surr1))
        loss = loss + self._bound_loss(params, norm_mean)
        if self.actor_wd:
            loss = loss + self.actor_wd * 0.5 * sum(
                torch.sum(torch.square(layer["w"]))
                for layer in params["actor"])
        clip_frac = torch.mean(
            (torch.abs(ratio - 1.0) > self.ratio_clip).to(torch.float32))
        return loss, clip_frac

    def losses(self, params, s, a, old_logp, adv, tar_vals):
        """(critic loss, actor loss, clip fraction)."""
        critic_loss = self._critic_loss(params, s, tar_vals)
        actor_loss, clip_frac = self._actor_loss(params, s, a, old_logp, adv)
        return critic_loss, actor_loss, clip_frac

    # ------------------------------------------------------------------
    def _minibatch_step(self, params: dict, c_rows: tuple, a_rows: tuple):
        """One critic momentum step on ``c_rows`` and one actor step on
        ``a_rows`` ((s, a, logp, adv, target) each), both from the same
        params; returns (params, critic loss, actor loss, clip frac)."""
        critic = _with_grad(params["critic"])
        s, _, _, _, tv = c_rows
        cl = self._critic_loss({**params, "critic": critic}, s, tv)
        critic, copt = momentum_update(
            params["critic_opt"], _grads(cl, critic, self.group),
            [{k: v.detach() for k, v in layer.items()} for layer in critic],
            float(self.spec["CriticStepsize"]),
            float(self.spec["CriticMomentum"]))
        actor = _with_grad(params["actor"])
        s, a, lp, ad, _ = a_rows
        al, cf = self._actor_loss({**params, "actor": actor}, s, a, lp, ad)
        actor, aopt = momentum_update(
            params["actor_opt"], _grads(al, actor, self.group),
            [{k: v.detach() for k, v in layer.items()} for layer in actor],
            params["actor_stepsize"], float(self.spec["ActorMomentum"]))
        params = {**params, "critic": critic, "critic_opt": copt,
                  "actor": actor, "actor_opt": aopt}
        return params, cl.detach(), al.detach(), cf

    def _adapt_stepsize(self, stepsize: torch.Tensor,
                        cfrac: torch.Tensor) -> torch.Tensor:
        """The actor stepsize rule on the clip fraction."""
        if self.tar_clip_frac < 0:
            return stepsize
        over = cfrac > self.tar_clip_frac * 1.5
        under = cfrac < self.tar_clip_frac / 1.5
        stepsize = torch.where(over, stepsize * self.stepsize_decay, stepsize)
        stepsize = torch.where(under, stepsize / self.stepsize_decay, stepsize)
        return torch.clamp(stepsize, 1e-8, 1e-2)

    def update(self, params: dict, draws: Draws, states, actions, logps,
               rewards, path_end):
        """One training update from a batch of path-structured transitions
        (``states`` has one bootstrap row more): TD(λ) targets, epochs of
        shuffled minibatches.  Returns (params, metrics)."""
        with torch.no_grad():
            vals = self.eval_critic(params, states)
            new_vals = self.compute_new_vals(rewards, vals, path_end)
            adv = new_vals - vals[:-1]
            new_vals = torch.clamp(new_vals, self.val_min, self.val_max)
            # jnp.std: the population std
            adv = (adv - torch.mean(adv)) / (torch.std(adv, correction=0)
                                             + 1e-5)
            adv = torch.clamp(adv, -self.norm_adv_clip, self.norm_adv_clip)
        n = rewards.shape[0]
        nmb = max(1, n // self.mini_batch_size)
        perms = draws.epoch_permutations(n, self.epochs, rewards.device)
        cols = (states[:-1], actions, logps, adv, new_vals)
        closs = aloss = cfrac = torch.zeros((), device=rewards.device)
        for perm in perms:
            for idx in perm[:nmb * self.mini_batch_size].reshape(nmb, -1):
                rows = tuple(c[idx] for c in cols)
                params, cl, al, cf = self._minibatch_step(params, rows, rows)
                closs, aloss, cfrac = closs + cl, aloss + al.abs(), cfrac + cf
        total = self.epochs * nmb
        closs, aloss, cfrac = maybe_pmean(
            [closs / total, aloss / total, cfrac / total], self.group)
        stepsize = self._adapt_stepsize(params["actor_stepsize"], cfrac)
        with torch.no_grad():
            params = {**params, "actor_stepsize": stepsize,
                      "s_norm": self.s_norm.update(params["s_norm"], states,
                                                   group=self.group),
                      "val_norm": self.val_norm.update(params["val_norm"],
                                                       new_vals[..., None],
                                                       group=self.group),
                      "sample_count": params["sample_count"] + n}
        return params, {"critic_loss": closs, "actor_loss": aloss,
                        "clip_frac": cfrac, "actor_stepsize": stepsize}

    def train_on_batch(self, params: dict, draws: Draws, states, actions,
                       logps, rewards, is_end, is_fail, is_succ, is_exp,
                       n_mb: int, valid=None):
        """One train step over a whole replay-buffer batch in record layout
        (each path is n + 1 consecutive records, the last its terminal or
        bootstrap state, ``is_end``):

        * critic values at FAIL ends are ``val_min``, at SUCC ends
          ``val_max``;
        * TD(λ) targets per path by a reverse scan (on the host, f32);
        * advantages over the exploring, non-end, valid records,
          standardized and clipped to ±NormAdvClip;
        * per epoch ``n_mb`` minibatches: critic rows drawn with
          replacement from the non-end records, actor rows from the
          exploring ones; the critic's step, then the actor's;
        * the clip-fraction stepsize rule, the normalizer updates (s_norm
          over every valid row, val_norm over the valid non-end rows) and
          the sample count plus the valid non-end rows, in f32.

        ``valid`` masks live records of a padded batch (padding must be
        ``is_end``).  Returns (params, metrics), the metrics in sorted key
        order as JAX's jitted dict returns them."""
        f32 = torch.float32
        dev = rewards.device
        if valid is None:
            valid = torch.ones(rewards.shape[0], dtype=torch.bool, device=dev)
        is_end = is_end | ~valid
        with torch.no_grad():
            vals = self.eval_critic(params, states)
            vals = torch.where(is_fail, self.val_min, vals)
            vals = torch.where(is_succ, self.val_max, vals)
            v = vals.cpu().numpy()
            new_vals = torch.as_tensor(td_lambda_targets(
                v, np.append(v[1:], v[-1:]), rewards.cpu().numpy(),
                is_end.cpu().numpy(), self.discount, self.td_lambda)).to(dev)

            exp_w = (is_exp & ~is_end & valid).to(f32)
            n_exp = torch.clamp(torch.sum(exp_w), min=1.0)
            adv = new_vals - vals
            adv_mean = torch.sum(adv * exp_w) / n_exp
            adv_std = torch.sqrt(
                torch.sum(exp_w * torch.square(adv - adv_mean)) / n_exp)
            adv = torch.clamp((adv - adv_mean) / (adv_std + 1e-5),
                              -self.norm_adv_clip, self.norm_adv_clip)
            new_vals = torch.clamp(new_vals, self.val_min, self.val_max)

            valid_w = (~is_end & valid).to(f32)
            p_critic = valid_w / torch.clamp(torch.sum(valid_w), min=1.0)
            p_actor = exp_w / n_exp
        total = self.epochs * n_mb
        c_idx, a_idx = draws.minibatch_indices(p_critic, p_actor, self.epochs,
                                               n_mb, self.mini_batch_size)
        cols = (states, actions, logps, adv, new_vals)
        closs = aloss = cfrac = torch.zeros((), device=dev)
        for k in range(total):
            params, cl, al, cf = self._minibatch_step(
                params, tuple(c[c_idx[k]] for c in cols),
                tuple(c[a_idx[k]] for c in cols))
            closs, aloss, cfrac = closs + cl, aloss + al.abs(), cfrac + cf
        closs, aloss, cfrac = maybe_pmean(
            [closs / total, aloss / total, cfrac / total], self.group)
        stepsize = self._adapt_stepsize(params["actor_stepsize"], cfrac)
        with torch.no_grad():
            params = {
                **params, "actor_stepsize": stepsize,
                "s_norm": self.s_norm.update(params["s_norm"], states,
                                             weights=valid.to(f32),
                                             group=self.group),
                "val_norm": self.val_norm.update(params["val_norm"],
                                                 new_vals[..., None],
                                                 weights=valid_w,
                                                 group=self.group),
                "sample_count": params["sample_count"] + torch.sum(valid_w)}
        return params, {"actor_loss": aloss, "actor_stepsize": stepsize,
                        "adv_mean": adv_mean, "adv_std": adv_std,
                        "clip_frac": cfrac, "critic_loss": closs}

    # ------------------------------------------------------------------
    @staticmethod
    def load_spec(path: str) -> dict:
        with open(path) as f:
            return json.load(f)
