"""Independent TRPO learners as lanes of one batch (the port's counterpart
of ``jax.jit(jax.vmap(learner.iteration))`` in ``tools/
imitation15_vmapped.py``).

``L`` learners have their parameters, Adam state, obs-RMS and env batch
stacked on a leading lane axis, and share one env of ``L·E`` envs,
lane-major: env ``l·E + e`` is env ``e`` of lane ``l``.  One ``env.step``
steps every lane, so the physics (and its APGD kernel) sees one batch of
``L·E`` envs.  Everything else is per lane, as JAX's vmap makes it:

* the MLPs run as batched matmuls over lanes (``(L, N, d) @ (L, d, o)``);
  biases, ``logstd`` and the obs-RMS are stored as ``(L, 1, ·)`` so that
  ``MlpPolicy``'s own methods broadcast over lanes;
* GAE, the standardised advantages (population std, no ε), the obs-RMS
  updates, the losses and ``IterStats`` are per lane (``(L,)`` tensors);
* the policy gradient and the Fisher-vector product come from one backward
  of the sum of the lanes' losses with respect to the lane-stacked flat θ
  ``(L, n)``: the lanes share no operation, so each lane gets its own
  gradient and the HVP is block-diagonal;
* CG and the KL line search follow a vmapped ``while_loop``: a lane whose
  condition is false keeps its carry (``torch.where``); CG stops once no
  lane has ``rdotr > 1e-10`` or at ``cg_iters``, the line search after
  ``line_search_steps`` evaluations or once every lane accepted;
* the vf update makes one lane-batched Adam step per minibatch, each lane
  over its own permutation of its own rows;
* every lane draws from its own ``Draws`` (its own ``torch.Generator``), so
  a lane's run does not depend on the lanes beside it, and a NaN in one
  lane stays in that lane (:func:`nonfinite_lanes` names such lanes).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import torch

from deepmimic_mujoco_torch.algos import adam
from deepmimic_mujoco_torch.algos.gae import add_vtarg_and_adv
from deepmimic_mujoco_torch.algos.trpo import (
    Draws,
    IterStats,
    SearchInfo,
    TRPOConfig,
    _layers,
    pick_reset_fn,
    policy_leaves,
    vf_leaves,
)
from deepmimic_mujoco_torch.envs import rewards
from deepmimic_mujoco_torch.envs.types import EnvState
from deepmimic_mujoco_torch.utils import running_stats
from deepmimic_mujoco_torch.utils.math import explained_variance
from deepmimic_mujoco_torch.utils.running_stats import RunningMeanStd


@dataclasses.dataclass(frozen=True)
class LaneState:
    params: dict                # lane-stacked (see stack_params)
    vf_adam: adam.AdamState     # m, v (L, n_vf); t (L,)
    env_state: EnvState         # (L·E, ...), lane-major
    new: torch.Tensor           # (L, E) bool episode-start flags
    draws: list                 # one Draws per lane
    cur_ep_ret: torch.Tensor    # (L, E) float32
    cur_ep_len: torch.Tensor    # (L, E) int32


# ---------------------------------------------------------------------------
# lane-stacked parameters


def stack_params(params: Sequence[dict]) -> dict:
    """Single-learner params (the ``MlpPolicy`` layout) → one lane-stacked
    dict: weights (L, in, out), biases (L, 1, out), logstd (L, 1, ac),
    ob_rms mean/var (L, 1, d) and count (L, 1, 1)."""
    def layers(head):
        return [{"w": torch.stack([p[head][k]["w"] for p in params]),
                 "b": torch.stack([p[head][k]["b"] for p in params])[:, None]}
                for k in range(len(params[0][head]))]

    rms = [p["ob_rms"] for p in params]
    return {
        "pol": layers("pol"), "vf": layers("vf"),
        "logstd": torch.stack([p["logstd"] for p in params])[:, None],
        "ob_rms": RunningMeanStd(
            torch.stack([r.mean for r in rms])[:, None],
            torch.stack([r.var for r in rms])[:, None],
            torch.stack([r.count for r in rms]).reshape(-1, 1, 1)),
    }


def lane_params(params: dict, lane: int) -> dict:
    """Lane ``lane`` of lane-stacked params, in the single-learner
    layout."""
    def layers(head):
        return [{"w": layer["w"][lane], "b": layer["b"][lane, 0]}
                for layer in params[head]]

    rms = params["ob_rms"]
    return {"pol": layers("pol"), "vf": layers("vf"),
            "logstd": params["logstd"][lane, 0],
            "ob_rms": RunningMeanStd(rms.mean[lane, 0], rms.var[lane, 0],
                                     rms.count[lane, 0, 0])}


def flatten(leaves: list[torch.Tensor]) -> torch.Tensor:
    """(L, n): each lane's leaves flattened in JAX's ravel_pytree order."""
    return torch.cat([x.reshape(x.shape[0], -1) for x in leaves], dim=1)


def _unflatten(theta: torch.Tensor, like: list[torch.Tensor]
               ) -> list[torch.Tensor]:
    out, off = [], 0
    for x in like:
        n = x[0].numel()
        out.append(theta[:, off:off + n].reshape(x.shape))
        off += n
    return out


def cg(f_Ax, b: torch.Tensor, cg_iters: int = 10,
       residual_tol: float = 1e-10) -> torch.Tensor:
    """``algos/cg.py`` on every lane of b (L, n) at once, as a vmapped
    ``while_loop`` runs it: a lane whose ``rdotr`` is at or below the
    tolerance keeps its carry; the loop ends when no lane continues."""
    x = torch.zeros_like(b)
    r, p = b.clone(), b.clone()
    rdotr = torch.sum(r * r, dim=1)
    for _ in range(cg_iters):
        go = rdotr > residual_tol
        if not bool(go.any()):
            break
        z = f_Ax(p)
        v = rdotr / torch.sum(p * z, dim=1)
        x_n = x + v[:, None] * p
        r_n = r - v[:, None] * z
        newrdotr = torch.sum(r_n * r_n, dim=1)
        p_n = r_n + (newrdotr / rdotr)[:, None] * p
        g = go[:, None]
        x, r, p = (torch.where(g, x_n, x), torch.where(g, r_n, r),
                   torch.where(g, p_n, p))
        rdotr = torch.where(go, newrdotr, rdotr)
    return x


def nonfinite_lanes(stats: IterStats) -> list[int]:
    """The lanes whose ``meankl`` is not finite (the tool's NaN report)."""
    return [int(i) for i in torch.nonzero(
        ~torch.isfinite(stats.meankl)).reshape(-1).cpu()]


def lane_rows(x: torch.Tensor, L: int) -> torch.Tensor:
    """(T, L·E, ...) segment rows → (L, T·E, ...), each lane's rows
    time-major, as ``reshape(-1, ·)`` of its (T, E, ·) segment in JAX."""
    T = x.shape[0]
    x = x.reshape((T, L, -1) + tuple(x.shape[2:])).transpose(0, 1)
    return x.reshape((L, -1) + tuple(x.shape[3:]))


# ---------------------------------------------------------------------------


class LaneTRPO:
    """``lanes`` independent TRPO learners (``config.num_envs`` envs each)
    over one shared batched env."""

    def __init__(self, env, policy, config: TRPOConfig = TRPOConfig(),
                 lanes: int = 1):
        self.env = env
        self.policy = policy
        self.cfg = config
        self.lanes = lanes
        self.device = env.device
        self._reset_fn = pick_reset_fn(env, config.reset_mode)

    # ------------------------------------------------------------------
    def init(self, generators: Sequence[torch.Generator],
             lane_clip_ids: Optional[Sequence[int]] = None) -> LaneState:
        """Lane l: random policy parameters from ``generators[l]``, then
        its E env starts: RSI frames of clip ``lane_clip_ids[l]`` (the
        lane tool's pinned lanes), or ``env.reset``."""
        L, E = self.lanes, self.cfg.num_envs
        if len(generators) != L:
            raise ValueError(f"{len(generators)} generators for {L} lanes")
        params, states = [], []
        for k, g in enumerate(generators):
            params.append(self.policy.init(g, self.device))
            if lane_clip_ids is None:
                states.append(self.env.reset(g, E))
            else:
                cid = torch.full((E,), int(lane_clip_ids[k]),
                                 dtype=torch.int64, device=self.device)
                states.append(self.env.reset_at(cid, self.env.rsi_frames(g, cid)))
        n_vf = sum(x.numel() for x in vf_leaves(params[0]))
        z = torch.zeros((L, n_vf), device=self.device)
        return LaneState(
            params=stack_params(params),
            vf_adam=adam.AdamState(z, z.clone(),
                                   torch.zeros(L, device=self.device)),
            env_state=EnvState.cat(states),
            new=torch.ones((L, E), dtype=torch.bool, device=self.device),
            draws=[Draws(g) for g in generators],
            cur_ep_ret=torch.zeros((L, E), device=self.device),
            cur_ep_len=torch.zeros((L, E), dtype=torch.int32,
                                   device=self.device))

    # ------------------------------------------------------------------
    def _fresh(self, draws: list, done: torch.Tensor, nxt: EnvState
               ) -> EnvState:
        """Each lane's fresh episode starts from its own draws."""
        E = self.cfg.num_envs
        out = []
        for k, d in enumerate(draws):
            sl = slice(k * E, (k + 1) * E)
            if self.cfg.reset_mode == "rsi_pinned":
                out.append(d.fresh_states(self._reset_fn, done[sl],
                                          nxt.map(lambda x: x[sl])))
            else:
                out.append(d.fresh_states(self._reset_fn, done[sl]))
        return EnvState.cat(out)

    @torch.no_grad()
    def _rollout(self, params: dict, env_state: EnvState, new: torch.Tensor,
                 draws: list, ep_ret: torch.Tensor, ep_len: torch.Tensor):
        """One fixed-horizon segment of every lane; one ``env.step`` call
        per control step.  The segment's tensors are (T, L·E, ...)."""
        L, E = self.lanes, self.cfg.num_envs
        keys = ("ob", "ac", "vpred", "rew", "new", "ep_rets", "ep_lens")
        traj = {k: [] for k in keys}
        new, ep_ret, ep_len = (x.reshape(L * E) for x in (new, ep_ret,
                                                         ep_len))
        for _ in range(self.cfg.horizon):
            ob = env_state.obs
            obl = ob.reshape(L, E, -1)
            mean, logstd = self.policy.mean_logstd(params, obl)
            noise = torch.stack([d.action_noise(mean[k])
                                 for k, d in enumerate(draws)])
            ac = (mean + torch.exp(logstd) * noise).reshape(L * E, -1)
            vpred = self.policy.value(params, obl).reshape(L * E)
            nxt = self.env.step(env_state, ac)
            done = nxt.done
            ep_ret = ep_ret + nxt.reward
            ep_len = ep_len + 1
            traj["ep_rets"].append(torch.where(done, ep_ret, 0.0))
            traj["ep_lens"].append(torch.where(done, ep_len, 0))
            ep_ret = torch.where(done, 0.0, ep_ret)
            ep_len = torch.where(done, 0, ep_len)
            env_state = self._fresh(draws, done, nxt).where(done, nxt)
            for k, x in zip(keys[:5], (ob, ac, vpred, nxt.reward, new)):
                traj[k].append(x)
            new = done
        seg = {k: torch.stack(v) for k, v in traj.items()}
        seg["new"] = seg["new"].float()
        seg["nextvpred"] = self.policy.value(
            params, env_state.obs.reshape(L, E, -1)).reshape(L * E) * (
                1.0 - new.float())
        T = self.cfg.horizon
        lens = seg["ep_lens"].reshape(T, L, E)
        seg["ep_ret_sum"] = seg["ep_rets"].reshape(T, L, E).sum((0, 2))
        seg["ep_len_sum"] = lens.sum((0, 2))
        seg["ep_count"] = (lens > 0).sum((0, 2))
        return (seg, env_state, new.reshape(L, E), ep_ret.reshape(L, E),
                ep_len.reshape(L, E))

    # ------------------------------------------------------------------
    def _losses(self, params: dict, params_old: dict, ob: torch.Tensor,
                ac: torch.Tensor, atarg: torch.Tensor) -> torch.Tensor:
        """(L, 5): [optimgain, meankl, entbonus, surrgain, meanent]."""
        meankl = torch.mean(self.policy.kl(params_old, params, ob), dim=1)
        meanent = torch.mean(self.policy.entropy(params, ob), dim=1)
        entbonus = self.cfg.entcoeff * meanent
        logp_new = -self.policy.neglogp(params, ob, ac)
        logp_old = -self.policy.neglogp(params_old, ob, ac)
        surrgain = torch.mean(torch.exp(logp_new - logp_old) * atarg, dim=1)
        return torch.stack([surrgain + entbonus, meankl, entbonus, surrgain,
                            meanent], dim=1)

    def _policy_update(self, params: dict, ob: torch.Tensor,
                       ac: torch.Tensor, atarg: torch.Tensor):
        """Every lane's gradient, CG step direction and KL line search
        (obs-RMS already updated): returns (params with the new pol and
        logstd, meanlosses (L, 5), SearchInfo with (L,) step sizes and
        acceptance flags)."""
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
        g = torch.autograd.grad(lossbefore[:, 0].sum(), theta)[0]
        lossbefore = lossbefore.detach()
        mask = None
        if self.policy.fixed_logstd is not None:
            # fixed exploration noise: logstd's coordinates (first in each
            # lane's flat vector) stay out of the natural-gradient step
            mask = torch.ones_like(g)
            mask[:, :like[0][0].numel()] = 0.0
            g = g * mask

        # Fisher-vector product of each lane: the Hessian of its mean KL on
        # every 5th row times p, plus damping (one double backward)
        theta = th_before.clone().requires_grad_(True)
        meankl = torch.mean(self.policy.kl(params_old, with_pol(theta),
                                           ob[:, ::5]), dim=1)
        grad_kl = torch.autograd.grad(meankl.sum(), theta,
                                      create_graph=True)[0]

        def fisher_vector_product(p):
            hvp = torch.autograd.grad(grad_kl, theta, grad_outputs=p,
                                      retain_graph=True)[0]
            return hvp + cfg.cg_damping * p

        stepdir = cg(fisher_vector_product, g, cg_iters=cfg.cg_iters)
        if mask is not None:
            stepdir = stepdir * mask
        shs = 0.5 * torch.sum(stepdir * fisher_vector_product(stepdir), dim=1)
        lm = torch.sqrt(shs / cfg.max_kl)
        fullstep = (stepdir / torch.clamp(lm, min=1e-8)[:, None]).detach()
        stepdir = stepdir.detach()
        del grad_kl, theta

        with torch.no_grad():
            surrbefore = lossbefore[:, 0]
            zero_grad = torch.all(torch.abs(g) <= 1e-8, dim=1)  # allclose(g, 0)
            L = th_before.shape[0]
            stepsize = torch.ones(L, device=g.device)
            accepted = torch.zeros(L, dtype=torch.bool, device=g.device)
            for _ in range(cfg.line_search_steps):
                go = ~accepted
                if not bool(go.any()):
                    break
                ml = losses_at(th_before + fullstep * stepsize[:, None])
                ok = (torch.isfinite(ml).all(dim=1)
                      & (ml[:, 1] <= cfg.max_kl * 1.5)
                      & (ml[:, 0] - surrbefore > 0))
                stepsize = torch.where(go & ~ok, stepsize * 0.5, stepsize)
                accepted = torch.where(go, ok, accepted)
            take = (accepted & ~zero_grad)[:, None]
            th_new = torch.where(take, th_before + fullstep * stepsize[:, None],
                                 th_before)
            new_params = with_pol(th_new)
            meanlosses = losses_at(th_new)
        return new_params, meanlosses, SearchInfo(g, stepdir, stepsize,
                                                  accepted)

    def _vf_update(self, params: dict, vf_adam: adam.AdamState,
                   ob: torch.Tensor, tdlamret: torch.Tensor, draws: list):
        """``vf_iters`` epochs of minibatch Adam on every lane's value
        function, one lane-batched Adam step per minibatch; each lane's
        obs-RMS is updated on its minibatch before its loss."""
        cfg = self.cfg
        L, n = ob.shape[:2]
        bs = cfg.vf_batch_size
        nmb = n // bs
        like = vf_leaves(params)
        vf_theta = flatten(like).detach()
        ob_rms = params["ob_rms"]
        perms = torch.stack([d.vf_permutations(n, cfg.vf_iters, ob.device)
                             for d in draws])  # (L, epochs, n)
        lane = torch.arange(L, device=ob.device)[:, None]
        for e in range(cfg.vf_iters):
            idx = perms[:, e, :nmb * bs]
            mbobs = ob[lane, idx].reshape(L, nmb, bs, ob.shape[-1])
            mbrets = tdlamret[lane, idx].reshape(L, nmb, bs)
            for k in range(nmb):
                ob_rms = running_stats.update(ob_rms, mbobs[:, k])
                theta = vf_theta.requires_grad_(True)
                p = {**params, "vf": _layers(_unflatten(theta, like)),
                     "ob_rms": ob_rms}
                vpred = self.policy.value(p, mbobs[:, k])
                loss = torch.mean(torch.square(vpred - mbrets[:, k]), dim=1)
                gvf = torch.autograd.grad(loss.sum(), theta)[0]
                with torch.no_grad():
                    vf_theta, vf_adam = adam.update(vf_adam, gvf,
                                                    vf_theta.detach(),
                                                    cfg.vf_stepsize)
        vf = _layers(_unflatten(vf_theta.detach(), like))
        return {**params, "vf": vf, "ob_rms": ob_rms}, vf_adam

    def _segment_update(self, params: dict, vf_adam: adam.AdamState,
                        seg: dict, draws: list):
        """One TRPO policy + vf update of every lane from one segment:
        returns (params, vf_adam, meanlosses (L, 5), ev (L,), SearchInfo)."""
        cfg, L = self.cfg, self.lanes
        ob = lane_rows(seg["ob"], L)
        ac = lane_rows(seg["ac"], L)
        adv, tdlamret = add_vtarg_and_adv(seg["rew"], seg["vpred"],
                                          seg["new"], seg["nextvpred"],
                                          cfg.gamma, cfg.lam)
        adv, tdlamret = lane_rows(adv, L), lane_rows(tdlamret, L)
        atarg = ((adv - adv.mean(dim=1, keepdim=True))
                 / adv.std(dim=1, correction=0, keepdim=True))  # no ε
        params = self.policy.update_ob_rms(params, ob)
        params, meanlosses, info = self._policy_update(params, ob, ac, atarg)
        params, vf_adam = self._vf_update(params, vf_adam, ob, tdlamret,
                                          draws)
        ev = explained_variance(lane_rows(seg["vpred"], L), tdlamret, dim=1)
        return params, vf_adam, meanlosses, ev, info

    # ------------------------------------------------------------------
    def iteration(self, state: LaneState) -> tuple[LaneState, IterStats]:
        """One logged iteration of every lane: ``g_step`` segments, each
        followed by a full TRPO update.  Every stat is an (L,) tensor;
        ``ep_rets``/``ep_lens`` are (L, g_step, T, E)."""
        cfg, L, E = self.cfg, self.lanes, self.cfg.num_envs
        params, vf_adam = state.params, state.vf_adam
        env_state, new, draws = state.env_state, state.new, state.draws
        ep_ret, ep_len = state.cur_ep_ret, state.cur_ep_len
        zero = torch.zeros(L, device=self.device)
        ep_ret_sum, ep_len_sum, ep_count = zero, zero, zero
        meanlosses, ev = torch.zeros((L, 5), device=self.device), zero
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
            T = seg["ep_rets"].shape[0]
            ep_rets_all.append(seg["ep_rets"].reshape(T, L, E))
            ep_lens_all.append(seg["ep_lens"].reshape(T, L, E))
        stats = IterStats(
            optimgain=meanlosses[:, 0], meankl=meanlosses[:, 1],
            entloss=meanlosses[:, 2], surrgain=meanlosses[:, 3],
            entropy=meanlosses[:, 4], ev_tdlam_before=ev,
            ep_ret_sum=ep_ret_sum, ep_len_sum=ep_len_sum, ep_count=ep_count,
            timesteps=torch.full((L,), float(cfg.g_step * cfg.horizon * E),
                                 device=self.device),
            ep_len_sum_last=ep_len_sum_last,
            ep_rets=torch.stack(ep_rets_all).permute(2, 0, 1, 3),
            ep_lens=torch.stack(ep_lens_all).permute(2, 0, 1, 3))
        return LaneState(params=params, vf_adam=vf_adam, env_state=env_state,
                         new=new, draws=draws, cur_ep_ret=ep_ret,
                         cur_ep_len=ep_len), stats


# ---------------------------------------------------------------------------


class LaneEval(NamedTuple):
    ep_len: torch.Tensor      # (L, B) steps until each episode's first done
    rew_sum: torch.Tensor     # (L, B) return until then
    pose_err: torch.Tensor    # (L,) weighted pose error over the alive steps
    state: EnvState           # final (L·B) state, finished envs frozen
    traj: Optional[tuple]     # (obs, rewards), each (H, L·B, ·), when recorded


@torch.no_grad()
def evaluate(env, policy, params: dict, clip_ids: torch.Tensor,
             frames: torch.Tensor, horizon: int, record: bool = False
             ) -> LaneEval:
    """Deterministic episodes of every lane (the lane tool's ``eval_lane``,
    all lanes in one batch): lane l's B episodes start at frames
    ``frames[l]`` (L, B) of clip ``clip_ids[l]`` and run its policy mean
    for ``horizon`` steps.  After an episode's first done its state is
    frozen and it adds nothing to its length, return or pose error; the
    pose error holds the post-step pose against the post-step clip
    frame."""
    L, B = frames.shape
    dev = env.device
    cid = torch.as_tensor(clip_ids, device=dev).reshape(L, 1).expand(L, B)
    s = env.reset_at(cid.reshape(-1), torch.as_tensor(frames, device=dev)
                     .reshape(-1))
    alive = torch.ones(L * B, dtype=torch.bool, device=dev)
    ep_len = torch.zeros(L * B, dtype=torch.int64, device=dev)
    rew_sum = torch.zeros(L * B, device=dev)
    err_sum = torch.zeros(L, device=dev)
    err_n = torch.zeros(L, device=dev)
    obs, rews = [], []
    for _ in range(horizon):
        mean, _ = policy.mean_logstd(params, s.obs.reshape(L, B, -1))
        nxt = env.step(s, mean.reshape(L * B, -1))
        idx, _ = env._clip_index(nxt.clip_id, nxt.mocap_idx, nxt.init_idx)
        ref = env.clip_qpos[nxt.clip_id, idx]
        perr = rewards.weighted_pose_error(nxt.qpos[:, 7:], ref[:, 7:])
        a = alive.float()
        err_sum = err_sum + (perr * a).reshape(L, B).sum(1)
        err_n = err_n + a.reshape(L, B).sum(1)
        ep_len = ep_len + alive.long()
        rew_sum = rew_sum + torch.where(alive, nxt.reward, 0.0)
        if record:
            obs.append(s.obs)
            rews.append(nxt.reward)
        s2 = nxt.where(alive, s)
        alive = alive & ~nxt.done
        s = s2
    traj = (torch.stack(obs), torch.stack(rews)) if record else None
    return LaneEval(ep_len.reshape(L, B), rew_sum.reshape(L, B),
                    err_sum / torch.clamp(err_n, min=1.0), s, traj)
