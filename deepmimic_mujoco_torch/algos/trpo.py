"""TRPO (port of ``deepmimic_mujoco_tpu/algos/trpo.py``), batch-first and
eager.

One :meth:`TRPO.iteration` = for each of ``g_step`` segments: a rollout of
``horizon`` steps of every env (no autograd graph: the physics and its APGD
kernels run under ``torch.no_grad``) → GAE(λ) → obs-RMS update → policy
gradient → CG on the KL Fisher-vector product (double backward) → KL line
search (≤ ``line_search_steps`` halvings) → ``vf_iters`` epochs of
minibatch Adam on the value function.  Gradients flow only through the
policy and value MLPs, on the stored observations.

The JAX version's quirks are kept (its module docstring, SURVEY.md §7):
segments cross episode boundaries; post-done resets use
:func:`pick_reset_fn` while ``init`` resets with ``env.reset`` (RSI);
advantages are standardized with no ε and the population std; the FVP uses
every 5th row; obs-RMS is updated on the whole segment and again on every vf
minibatch; vf minibatches hold ``vf_batch_size`` rows and the partial batch
is dropped.  Rows are flattened time-major, as ``reshape(-1, ·)`` of the
(T, B, ·) segment does in JAX, and the flat parameter vectors follow JAX's
``ravel_pytree`` order, so row picks and Adam's moments line up with JAX's.

Every random draw goes through one :class:`Draws` object in the state: the
action noise, the fresh reset states and the vf permutations (and, for the
learners built on this rollout, PPO's epoch permutations and GAIL's d-step
draws, ``algos/ppo.py`` and ``algos/gail.py``).  By default
it draws from a ``torch.Generator``; the parity tests hand it JAX's own
draws instead.  Where JAX's line search and CG loops test a condition on
the device, the port reads it on the host (one sync per CG iteration and
per line-search step).

Across ranks (``group``, a ``torch.distributed`` process group, in place of
JAX's ``axis_name``) each rank rolls out its own envs and the update
averages over the group at each of JAX's ``pmean`` points: the obs-RMS
sums, the loss before the step and the policy gradient, every
Fisher-vector product of CG, each line-search step's losses, the mean
losses after it, and each vf minibatch's obs-RMS sums and gradient.  CG's
stopping test and the line search's decision read only averaged values,
so every rank takes the same step.  The advantages are standardized and
the explained variance computed over the rank's own rows, as in JAX.  The
update's draws (the vf permutations, and PPO's and GAIL's) come from the
``Draws``' ``shared`` generator, seeded alike on every rank; the action
noise and the resets from its per-rank ``generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from deepmimic_mujoco_torch.algos import adam
from deepmimic_mujoco_torch.algos.cg import cg
from deepmimic_mujoco_torch.algos.gae import add_vtarg_and_adv
from deepmimic_mujoco_torch.envs.types import EnvState
from deepmimic_mujoco_torch.parallel.collectives import maybe_pmean
from deepmimic_mujoco_torch.utils import running_stats
from deepmimic_mujoco_torch.utils.math import explained_variance


class TRPOConfig(NamedTuple):
    """The JAX package's defaults (the reference's train() hyperparams)."""

    horizon: int = 256            # timesteps_per_batch per env
    num_envs: int = 8
    g_step: int = 3
    gamma: float = 0.995
    lam: float = 0.97
    max_kl: float = 0.01
    cg_iters: int = 10
    cg_damping: float = 0.1
    vf_iters: int = 3
    vf_stepsize: float = 1e-3
    vf_batch_size: int = 128
    entcoeff: float = 0.0
    line_search_steps: int = 10
    # post-done reset: "noise", "rsi", or "rsi_pinned" (RSI that keeps
    # each env's clip: multi-clip envs, the lanes of per-skill learners)
    reset_mode: str = "noise"


class Draws:
    """Every random draw of TRPO, PPO and GAIL, on the env's device: the
    rollout's from ``generator``, the update's from ``shared`` (the same
    generator unless one is given; across ranks, one seeded alike on every
    rank, so that the replicated update draws alike)."""

    def __init__(self, generator: torch.Generator,
                 shared: torch.Generator | None = None):
        self.generator = generator
        self.shared = generator if shared is None else shared

    def action_noise(self, mean: torch.Tensor) -> torch.Tensor:
        """N(0, 1) of ``mean``'s shape: one rollout step's action noise."""
        return torch.randn(mean.shape, generator=self.generator,
                           device=mean.device, dtype=mean.dtype)

    def fresh_states(self, reset_fn, done: torch.Tensor,
                     state: EnvState | None = None) -> EnvState:
        """Fresh episode starts for all B envs (the rollout keeps those of
        the envs that are ``done``): the draw order does not depend on the
        data, and nothing is read back to the host.  ``reset_fn(generator,
        B)``, or ``reset_fn(generator, state)`` when the reset reads the
        state (``rsi_pinned`` keeps each env's clip)."""
        if state is None:
            return reset_fn(self.generator, done.shape[0])
        return reset_fn(self.generator, state)

    def vf_permutations(self, n: int, epochs: int,
                        device: torch.device) -> torch.Tensor:
        """(epochs, n): one permutation of the segment's rows per epoch."""
        return torch.stack([torch.randperm(n, generator=self.shared,
                                           device=device)
                            for _ in range(epochs)])

    def epoch_permutations(self, n: int, epochs: int,
                           device: torch.device) -> torch.Tensor:
        """(epochs, n): PPO's minibatch order, one permutation of the
        rows per epoch (the draw of :meth:`vf_permutations`)."""
        return self.vf_permutations(n, epochs, device)

    def d_permutation(self, n: int, device: torch.device) -> torch.Tensor:
        """(n,): the order in which GAIL's exact d-step sweeps the last
        segment's rows."""
        return torch.randperm(n, generator=self.shared, device=device)

    def d_subsamples(self, n: int, n_exp: int, n_mb: int, mb: int,
                     device: torch.device):
        """GAIL's legacy d-step: (n_mb, mb) generator rows, each
        minibatch drawn without replacement from ``n``, and (n_mb, mb)
        expert rows drawn with replacement from ``n_exp``."""
        g_idx = torch.argsort(torch.rand((n_mb, n), generator=self.shared,
                                         device=device), dim=1)[:, :mb]
        e_idx = torch.randint(0, n_exp, (n_mb, mb), generator=self.shared,
                              device=device)
        return g_idx, e_idx


@dataclasses.dataclass(frozen=True)
class TRPOState:
    params: dict                # pol / vf / logstd / ob_rms
    vf_adam: adam.AdamState
    env_state: EnvState         # batched
    new: torch.Tensor           # (B,) bool episode-start flags of the next obs
    draws: Draws                # in place of the JAX state's PRNG key
    cur_ep_ret: torch.Tensor    # (B,) float32 running episode return
    cur_ep_len: torch.Tensor    # (B,) int32 running episode length


class IterStats(NamedTuple):
    """The JAX ``IterStats``, as device tensors."""

    optimgain: Any
    meankl: Any
    entloss: Any
    surrgain: Any
    entropy: Any
    ev_tdlam_before: Any
    ep_ret_sum: Any             # returns / lengths / count of the episodes
    ep_len_sum: Any             # that ended during the iteration
    ep_count: Any
    timesteps: Any
    ep_len_sum_last: Any        # the reference's step counter (last segment)
    ep_rets: Any = None         # (g_step, T, B): nonzero where an episode
    ep_lens: Any = None         # ended at that step


class SearchInfo(NamedTuple):
    """What one policy update decided: the policy gradient ``g``, the CG
    step direction, the accepted step size (1 halved per rejected try) and
    whether a step was taken."""

    g: torch.Tensor
    stepdir: torch.Tensor
    stepsize: float
    accepted: bool


def pick_reset_fn(env, reset_mode: str):
    """Episode-start reset: "rsi" = random mocap frame, "noise" = the v3
    noise reset (the env's ``reset`` where it has no ``reset_init``, as
    ``DPEnvV3Multi``), both ``(generator, n) → EnvState``; "rsi_pinned" =
    ``env.reset_keep_clip``, ``(generator, state) → EnvState``, a random
    frame of each env's current clip.  Unlike the JAX version, which falls
    back to noise resets for any other string, an unknown mode raises."""
    if reset_mode == "rsi":
        return env.reset
    if reset_mode == "noise":
        return getattr(env, "reset_init", env.reset)
    if reset_mode == "rsi_pinned":
        return env.reset_keep_clip
    raise ValueError(f"unknown reset_mode {reset_mode!r}; expected 'rsi', "
                     "'noise' or 'rsi_pinned'")


# ---------------------------------------------------------------------------
# flat parameter vectors in JAX's ravel_pytree order


def policy_leaves(params: dict) -> list[torch.Tensor]:
    """``{"logstd", "pol"}`` flattened as JAX does (dict keys sorted):
    logstd, then pol[k].b, pol[k].w for each layer."""
    return [params["logstd"]] + [layer[k] for layer in params["pol"]
                                 for k in ("b", "w")]


def vf_leaves(params: dict) -> list[torch.Tensor]:
    """``vf`` flattened as JAX does: vf[k].b, vf[k].w for each layer."""
    return [layer[k] for layer in params["vf"] for k in ("b", "w")]


def flatten(leaves: list[torch.Tensor]) -> torch.Tensor:
    return torch.cat([x.reshape(-1) for x in leaves])


def _unflatten(theta: torch.Tensor, like: list[torch.Tensor]
               ) -> list[torch.Tensor]:
    out, off = [], 0
    for x in like:
        out.append(theta[off:off + x.numel()].view(x.shape))
        off += x.numel()
    return out


def _layers(leaves: list[torch.Tensor]) -> list[dict]:
    return [{"b": leaves[2 * k], "w": leaves[2 * k + 1]}
            for k in range(len(leaves) // 2)]


class TRPO:
    """Couples a batched env (``DPEnvV3`` or ``DPEnvV3Multi``), an
    ``MlpPolicy`` and the TRPO update.  The env's device is the
    learner's.  ``group``: the ranks to average the update over (None: this
    process alone)."""

    def __init__(self, env, policy, config: TRPOConfig = TRPOConfig(),
                 group=None):
        self.env = env
        self.policy = policy
        self.cfg = config
        self.group = group
        self.device = env.device
        self._reset_fn = pick_reset_fn(env, config.reset_mode)

    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator) -> TRPOState:
        """Random policy parameters and RSI starts (``env.reset``, whatever
        ``reset_mode`` says, as in JAX), all from ``generator``."""
        B = self.cfg.num_envs
        params = self.policy.init(generator, self.device)
        n_vf = sum(x.numel() for x in vf_leaves(params))
        return TRPOState(
            params=params, vf_adam=adam.init(n_vf, self.device),
            env_state=self.env.reset(generator, B),
            new=torch.ones(B, dtype=torch.bool, device=self.device),
            draws=Draws(generator),
            cur_ep_ret=torch.zeros(B, device=self.device),
            cur_ep_len=torch.zeros(B, dtype=torch.int32, device=self.device))

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _rollout(self, params: dict, env_state: EnvState, new: torch.Tensor,
                 draws: Draws, ep_ret: torch.Tensor, ep_len: torch.Tensor,
                 reward_fn=None):
        """Fixed-horizon segment across episode boundaries; the segment's
        tensors are (T, B, ...).  ``reward_fn(ob, ac)``, where given (GAIL),
        replaces the env's reward as the stored reward and in the episode
        returns; the env's own returns are then kept in ``ep_true``,
        summed from zero at the segment's start, as JAX's GAIL rollout
        does."""
        keys = ("ob", "ac", "vpred", "rew", "new", "ep_rets", "ep_lens")
        traj = {k: [] for k in keys + ("ep_true",)}
        true_ret = torch.zeros_like(ep_ret)
        for _ in range(self.cfg.horizon):
            ob = env_state.obs
            mean, logstd = self.policy.mean_logstd(params, ob)
            ac = mean + torch.exp(logstd) * draws.action_noise(mean)
            vpred = self.policy.value(params, ob)
            nxt = self.env.step(env_state, ac)
            done = nxt.done
            rew = nxt.reward
            if reward_fn is not None:
                rew = reward_fn(ob, ac)
                true_ret = true_ret + nxt.reward
                traj["ep_true"].append(torch.where(done, true_ret, 0.0))
                true_ret = torch.where(done, 0.0, true_ret)
            ep_ret = ep_ret + rew
            ep_len = ep_len + 1
            traj["ep_rets"].append(torch.where(done, ep_ret, 0.0))
            traj["ep_lens"].append(torch.where(done, ep_len, 0))
            ep_ret = torch.where(done, 0.0, ep_ret)
            ep_len = torch.where(done, 0, ep_len)
            if self.cfg.reset_mode == "rsi_pinned":
                fresh = draws.fresh_states(self._reset_fn, done, nxt)
            else:
                fresh = draws.fresh_states(self._reset_fn, done)
            env_state = fresh.where(done, nxt)
            for k, x in zip(keys[:5], (ob, ac, vpred, rew, new)):
                traj[k].append(x)
            new = done
        seg = {k: torch.stack(v) for k, v in traj.items() if v}
        seg["new"] = seg["new"].float()
        seg["nextvpred"] = self.policy.value(params, env_state.obs) * (
            1.0 - new.float())
        seg["ep_ret_sum"] = seg["ep_rets"].sum()
        seg["ep_len_sum"] = seg["ep_lens"].sum()
        seg["ep_count"] = (seg["ep_lens"] > 0).sum()
        return seg, env_state, new, ep_ret, ep_len

    # ------------------------------------------------------------------
    def _losses(self, params: dict, params_old: dict, ob: torch.Tensor,
                ac: torch.Tensor, atarg: torch.Tensor) -> torch.Tensor:
        """[optimgain, meankl, entbonus, surrgain, meanent]."""
        meankl = torch.mean(self.policy.kl(params_old, params, ob))
        meanent = torch.mean(self.policy.entropy(params, ob))
        entbonus = self.cfg.entcoeff * meanent
        logp_new = -self.policy.neglogp(params, ob, ac)
        logp_old = -self.policy.neglogp(params_old, ob, ac)
        surrgain = torch.mean(torch.exp(logp_new - logp_old) * atarg)
        return torch.stack([surrgain + entbonus, meankl, entbonus, surrgain,
                            meanent])

    def _policy_update(self, params: dict, ob: torch.Tensor,
                       ac: torch.Tensor, atarg: torch.Tensor):
        """Gradient, CG step direction and KL line search from ``params``
        (obs-RMS already updated): returns (params with the new pol and
        logstd, meanlosses at them, SearchInfo)."""
        cfg = self.cfg
        params_old = params
        like = policy_leaves(params)
        th_before = flatten(like).detach()

        def with_pol(theta):
            leaves = _unflatten(theta, like)
            return {**params, "logstd": leaves[0], "pol": _layers(leaves[1:])}

        def losses_at(theta, o=ob):
            return self._losses(with_pol(theta), params_old, o, ac, atarg)

        theta = th_before.clone().requires_grad_(True)
        lossbefore = losses_at(theta)
        g = torch.autograd.grad(lossbefore[0], theta)[0]
        lossbefore, g = maybe_pmean([lossbefore.detach(), g], self.group)
        mask = None
        if self.policy.fixed_logstd is not None:
            # fixed exploration noise: logstd's coordinates (first in the
            # flat vector) stay out of the natural-gradient step
            mask = torch.ones_like(g)
            mask[:like[0].numel()] = 0.0
            g = g * mask

        # Fisher-vector product: the Hessian of the mean KL on every 5th row
        # times p (double backward), plus damping
        theta = th_before.clone().requires_grad_(True)
        meankl = torch.mean(self.policy.kl(params_old, with_pol(theta),
                                           ob[::5]))
        grad_kl = torch.autograd.grad(meankl, theta, create_graph=True)[0]

        def fisher_vector_product(p):
            hvp = torch.autograd.grad(grad_kl, theta, grad_outputs=p,
                                      retain_graph=True)[0]
            return maybe_pmean(hvp, self.group) + cfg.cg_damping * p

        stepdir = cg(fisher_vector_product, g, cg_iters=cfg.cg_iters)
        if mask is not None:
            stepdir = stepdir * mask
        shs = 0.5 * torch.dot(stepdir, fisher_vector_product(stepdir))
        lm = torch.sqrt(shs / cfg.max_kl)
        fullstep = (stepdir / torch.clamp(lm, min=1e-8)).detach()
        stepdir = stepdir.detach()
        del grad_kl, theta

        with torch.no_grad():
            surrbefore = lossbefore[0]
            zero_grad = torch.allclose(g, torch.zeros_like(g))
            stepsize, accepted = 1.0, False
            for _ in range(cfg.line_search_steps):
                ml = maybe_pmean(losses_at(th_before + fullstep * stepsize),
                                 self.group)
                ok = (torch.isfinite(ml).all() & (ml[1] <= cfg.max_kl * 1.5)
                      & (ml[0] - surrbefore > 0))
                if bool(ok):
                    accepted = True
                    break
                stepsize *= 0.5
            th_new = (th_before + fullstep * stepsize
                      if accepted and not zero_grad else th_before)
            new_params = with_pol(th_new)
            meanlosses = maybe_pmean(losses_at(th_new), self.group)
        return new_params, meanlosses, SearchInfo(g, stepdir, stepsize,
                                                  accepted)

    def _vf_update(self, params: dict, vf_adam: adam.AdamState,
                   ob: torch.Tensor, tdlamret: torch.Tensor, draws: Draws):
        """``vf_iters`` epochs of minibatch Adam on the value function;
        obs-RMS is updated on every minibatch before its loss.  Returns
        (params with the new vf and ob_rms, vf_adam)."""
        cfg = self.cfg
        n, bs = ob.shape[0], cfg.vf_batch_size
        nmb = n // bs
        like = vf_leaves(params)
        vf_theta = flatten(like).detach()
        ob_rms = params["ob_rms"]
        perms = draws.vf_permutations(n, cfg.vf_iters, ob.device)
        for perm in perms:
            idx = perm[:nmb * bs].reshape(nmb, bs)
            mbobs, mbrets = ob[idx], tdlamret[idx]
            for k in range(nmb):
                ob_rms = running_stats.update(ob_rms, mbobs[k], self.group)
                theta = vf_theta.requires_grad_(True)
                p = {**params, "vf": _layers(_unflatten(theta, like)),
                     "ob_rms": ob_rms}
                vpred = self.policy.value(p, mbobs[k])
                loss = torch.mean(torch.square(vpred - mbrets[k]))
                gvf = maybe_pmean(torch.autograd.grad(loss, theta)[0],
                                  self.group)
                with torch.no_grad():
                    vf_theta, vf_adam = adam.update(vf_adam, gvf,
                                                    vf_theta.detach(),
                                                    cfg.vf_stepsize)
        vf = _layers(_unflatten(vf_theta.detach(), like))
        return {**params, "vf": vf, "ob_rms": ob_rms}, vf_adam

    def _segment_update(self, params: dict, vf_adam: adam.AdamState,
                        seg: dict, draws: Draws):
        """One TRPO policy + vf update from one segment: returns (params,
        vf_adam, meanlosses, ev, SearchInfo)."""
        cfg = self.cfg
        ob = seg["ob"].reshape(-1, seg["ob"].shape[-1])
        ac = seg["ac"].reshape(-1, seg["ac"].shape[-1])
        adv, tdlamret = add_vtarg_and_adv(seg["rew"], seg["vpred"],
                                          seg["new"], seg["nextvpred"],
                                          cfg.gamma, cfg.lam)
        adv = adv.reshape(-1)
        tdlamret = tdlamret.reshape(-1)
        atarg = (adv - adv.mean()) / adv.std(correction=0)  # no ε
        params = self.policy.update_ob_rms(params, ob, self.group)
        params, meanlosses, info = self._policy_update(params, ob, ac, atarg)
        params, vf_adam = self._vf_update(params, vf_adam, ob, tdlamret,
                                          draws)
        ev = explained_variance(seg["vpred"].reshape(-1), tdlamret)
        return params, vf_adam, meanlosses, ev, info

    # ------------------------------------------------------------------
    def iteration(self, state: TRPOState) -> tuple[TRPOState, IterStats]:
        """One logged iteration: ``g_step`` segments, each followed by a
        full TRPO update."""
        cfg = self.cfg
        params, vf_adam = state.params, state.vf_adam
        env_state, new, draws = state.env_state, state.new, state.draws
        ep_ret, ep_len = state.cur_ep_ret, state.cur_ep_len
        zero = torch.zeros((), device=self.device)
        ep_ret_sum, ep_len_sum, ep_count = zero, zero, zero
        meanlosses, ev = torch.zeros(5, device=self.device), zero
        ep_len_sum_last = zero
        ep_rets_all, ep_lens_all = [], []
        for _ in range(cfg.g_step):
            seg, env_state, new, ep_ret, ep_len = self._rollout(
                params, env_state, new, draws, ep_ret, ep_len)
            params, vf_adam, meanlosses, ev, _ = self._segment_update(
                params, vf_adam, seg, draws)
            ep_ret_sum = ep_ret_sum + seg["ep_ret_sum"]
            ep_len_sum = ep_len_sum + seg["ep_len_sum"]
            ep_count = ep_count + seg["ep_count"].float()
            ep_len_sum_last = seg["ep_len_sum"].float()
            ep_rets_all.append(seg["ep_rets"])
            ep_lens_all.append(seg["ep_lens"])
        stats = IterStats(
            optimgain=meanlosses[0], meankl=meanlosses[1],
            entloss=meanlosses[2], surrgain=meanlosses[3],
            entropy=meanlosses[4], ev_tdlam_before=ev,
            ep_ret_sum=ep_ret_sum, ep_len_sum=ep_len_sum, ep_count=ep_count,
            timesteps=torch.tensor(float(cfg.g_step * cfg.horizon
                                         * cfg.num_envs), device=self.device),
            ep_len_sum_last=ep_len_sum_last,
            ep_rets=torch.stack(ep_rets_all), ep_lens=torch.stack(ep_lens_all))
        return TRPOState(params=params, vf_adam=vf_adam, env_state=env_state,
                         new=new, draws=draws, cur_ep_ret=ep_ret,
                         cur_ep_len=ep_len), stats
