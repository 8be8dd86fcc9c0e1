"""Divergence checks between two devices (the card and the CPU), for the
question whether their episodes part by chaos of the contact-rich physics
or by a bias of one device.

- :func:`one_step_check`: one env step from the same states and actions on
  two devices, with the contact and limit sets that the solver's
  selection keeps in every substep and the stored dual matrices
  (:func:`step_recorded`); :func:`localize`: which module parts them.
- :func:`ulp_starts`, :func:`qpos_trace`, :func:`curves`,
  :func:`episode_spread` and :func:`verdict`: episodes from start states
  that differ by one f32 ulp in every qpos entry, the growth of their
  distance, and the rule that tells chaos from a bias."""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable

import torch

from deepmimic_mujoco_torch.envs.types import EnvState
from deepmimic_mujoco_torch.ops import apgd as ops
from deepmimic_mujoco_torch.parallel.mesh import tree_map
from deepmimic_mujoco_torch.physics import (
    collision,
    dynamics,
    engine,
    kinematics,
    solver,
)
from deepmimic_mujoco_torch.physics.model import PhysicsModel

STEP_TOL = 1e-4      # one step, of max(1, |x|): room for a bf16 flip of A
TIE = 1e-6           # k-th and (k+1)-th depths this close: a near-tie
CURVE_STEPS = (1, 2, 5, 10, 20, 50, 100, 200, 300)
SPLIT = 1e-2         # a pair has split once ‖Δqpos‖∞ exceeds this
CURVE_RATIO = 10.0   # chaos: card vs CPU within this factor of 1 ulp's growth


# the physics of an env step by module, in pipeline order: (module,
# function, label); the engine and the env call each through its module
MODULES = ((kinematics, "fk", "FK"),
           (dynamics, "mass_matrix", "M"),
           (engine, "mass_inverse", "M^-1 (Newton-Schulz)"),
           (collision, "floor_contacts", "contacts"),
           (collision, "joint_limits", "limits"),
           (solver, "select_deepest", "selection"),
           (solver, "assemble_system", "A"),
           (solver, "solve_system", "solve"),
           (engine, "integrate_pos", "integration"))


@contextlib.contextmanager
def recorded_modules():
    """Every call of a function of :data:`MODULES` made inside, as
    ``(label, function, args, kwargs, result)`` in call order."""
    rec: list = []
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in MODULES]

    def spy(label, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            rec.append((label, fn, args, kw, out))
            return out
        return call
    for (mod, name, fn), (_, _, label) in zip(saved, MODULES):
        setattr(mod, name, spy(label, fn))
    try:
        yield rec
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def step_recorded(env, state: EnvState, action: torch.Tensor):
    """(next state, calls) of one ``env.step``, the calls of
    :func:`recorded_modules`."""
    with torch.no_grad(), recorded_modules() as rec:
        nxt = env.step(state, action)
    return nxt, rec


def selections(calls: list) -> list:
    """``(pos, idx)`` of every selection among recorded calls, on the host:
    contacts, then limits, once per assembled system."""
    return [(args[0].cpu(), out.cpu()) for label, _, args, _, out in calls
            if label == "selection"]


def a_flips(calls_a: list, calls_b: list) -> torch.Tensor:
    """(B,) count per env of the stored entries of the dual matrix A
    (``ConstraintSystem.a_solve``, bf16 by default) that differ between two
    devices' recorded steps."""
    a_a, a_b = ([out.a_solve.cpu() for label, _, _, _, out in calls
                 if label == "A"] for calls in (calls_a, calls_b))
    return sum((x != y).reshape(x.shape[0], -1).sum(dim=1)
               for x, y in zip(a_a, a_b))


def _cut_gap(pos: torch.Tensor, k: int) -> torch.Tensor:
    """(B,) distance between the k-th and (k+1)-th depth; inf with no
    cut."""
    if k >= pos.shape[1]:
        return torch.full((pos.shape[0],), math.inf, dtype=torch.float64)
    srt = pos.double().sort(dim=1).values
    return srt[:, k] - srt[:, k - 1]


def selection_diff(sel_a: list, sel_b: list, tie: float = TIE) -> dict:
    """Compare two devices' selections of the same step, call by call and
    env by env.  A set may differ only at a near-tie: the k-th and
    (k+1)-th depths within ``tie`` on either device, and the depth rows
    not bitwise equal (equal rows must keep equal sets).  ``bad`` counts
    the other differences."""
    if len(sel_a) != len(sel_b):
        raise ValueError(f"{len(sel_a)} selections against {len(sel_b)}")
    n = exact = near = differ = bad = 0
    for (pa, ia), (pb, ib) in zip(sel_a, sel_b):
        k = ia.shape[1]
        n += ia.shape[0]
        ga, gb = _cut_gap(pa, k), _cut_gap(pb, k)
        same_row = (pa == pb).all(dim=1)
        close = torch.minimum(ga, gb) <= tie
        exact += int(((ga == 0) & (gb == 0)).sum())
        near += int((close & ~((ga == 0) & (gb == 0))).sum())
        d = (ia.sort(dim=1).values != ib.sort(dim=1).values).any(dim=1)
        differ += int(d.sum())
        bad += int((d & (same_row | ~close)).sum())
    return {"selections": n, "exact_ties": exact, "near_ties": near,
            "sets_differ": differ, "bad": bad}


def one_step_check(env_a, env_b, state: EnvState, action: torch.Tensor,
                   tol: float = STEP_TOL, tie: float = TIE) -> dict:
    """One env step from ``state`` and ``action`` on ``env_a``'s device and
    on ``env_b``'s (the same env built on each): qpos, qvel, obs and
    reward within ``tol`` of max(1, |x|), equal done flags, and equal
    selected contact and limit sets in every substep outside near-ties
    (:func:`selection_diff`).  Returns the figures and ``ok``, with per
    env (B,) the largest difference (``per_env``) and the count of stored
    entries of A that differ (``a_flips``)."""
    dev_b = env_b.model.qpos0.device
    nxt_a, calls_a = step_recorded(env_a, state, action)
    nxt_b, calls_b = step_recorded(
        env_b, state.map(lambda t: t.to(dev_b)), action.to(dev_b))
    rec = {k: float(per_env(getattr(nxt_a, k), getattr(nxt_b, k)).max())
           for k in ("qpos", "qvel", "obs", "reward")}
    rec["per_env"] = step_diffs(nxt_a, nxt_b)
    rec["a_flips"] = a_flips(calls_a, calls_b)
    rec["done_equal"] = bool(torch.equal(nxt_a.done.cpu(), nxt_b.done.cpu()))
    rec.update(selection_diff(selections(calls_a), selections(calls_b), tie))
    rec["envs"] = int(state.qpos.shape[0])
    rec["ok"] = (all(rec[k] <= tol for k in ("qpos", "qvel", "obs", "reward"))
                 and rec["done_equal"] and rec["bad"] == 0)
    return rec


def per_env(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """(B,) max over each env's entries of |x − ref| / max(1, |ref|)."""
    x, ref = x.cpu().double(), ref.cpu().double()
    d = (x - ref).abs() / ref.abs().clamp(min=1.0)
    return d.reshape(d.shape[0], -1).amax(dim=1)


def step_diffs(nxt_a: EnvState, nxt_b: EnvState) -> torch.Tensor:
    """(B,) the largest of qpos, qvel, obs and reward's :func:`per_env`."""
    return torch.stack([per_env(getattr(nxt_a, k), getattr(nxt_b, k))
                        for k in ("qpos", "qvel", "obs", "reward")]).amax(0)


def _leaves(tree) -> list:
    out = []
    tree_map(lambda t: out.append(t), tree)
    return out


def _plain_apgd(a, b, mu, f0, *, iterations, nc, nl, layout="blocks"):
    return ops._apgd_scan(a, b, mu, f0, iterations=iterations, nc=nc, nl=nl)


def localize(env_a, env_b, state: EnvState, action: torch.Tensor) -> dict:
    """Which module of the step parts the devices, given the same inputs:
    one ``env_b.step`` with every call of :data:`MODULES` recorded, each
    call then made again on ``env_a``'s device from ``env_b``'s inputs (its
    model for theirs; M⁻¹x from the recorded M⁻¹), and its result held
    against ``env_b``'s.  Per module, in pipeline order, per env (B,): the
    largest difference of max(1, |x|) over its calls (1 where indices or
    flags differ); per env the count of stored (bf16) entries of A that
    differ.  The solve is made again also with the plain version on
    ``env_a``'s device ("solve, plain"); and the env's reward, done and obs
    from ``env_b``'s physics ("reward, done")."""
    dev_a = env_a.model.qpos0.device
    dev_b = env_b.model.qpos0.device
    B = state.qpos.shape[0]
    st_b, ac_b = state.map(lambda t: t.to(dev_b)), action.to(dev_b)
    with torch.no_grad(), recorded_modules() as rec:
        nxt_b = env_b.step(st_b, ac_b)
    labels = [label for _, _, label in MODULES]
    diff = {k: torch.zeros(B, dtype=torch.float64)
            for k in labels + ["solve, plain", "reward, done"]}
    flips = torch.zeros(B, dtype=torch.int64)
    minv = None

    def to_a(x):
        if isinstance(x, PhysicsModel):
            return env_a.model
        if callable(x):       # assemble_system's x ↦ M⁻¹x
            m = minv.to(dev_a)
            return lambda v: torch.bmm(m, v)
        return tree_map(lambda t: t.to(dev_a), x)

    def compare(got, want) -> torch.Tensor:
        worst = torch.zeros(B, dtype=torch.float64)
        for g, w in zip(_leaves(got), _leaves(want)):
            g, w = g.cpu(), w.cpu()
            if g.dtype in (torch.bool, torch.int64, torch.int32):
                d = (g != w).reshape(g.shape[0], -1).any(dim=1).double()
            else:
                d = per_env(g.float(), w.float())
            # a leaf without the env axis (a model constant) counts for all
            worst = torch.maximum(worst, d if g.shape[0] == B else d.max())
        return worst

    with torch.no_grad():
        for label, fn, args, kw, out in rec:
            if label == "M^-1 (Newton-Schulz)":
                minv = out
            a_args = [to_a(x) for x in args]
            a_kw = {k: to_a(v) for k, v in kw.items()}
            got = fn(*a_args, **a_kw)
            diff[label] = torch.maximum(diff[label], compare(got, out))
            if label == "A":
                flips += (got.a_solve.cpu() != out.a_solve.cpu()).reshape(
                    B, -1).sum(dim=1)
            if label == "solve":
                kept = solver.apgd
                solver.apgd = _plain_apgd
                try:
                    plain = fn(*a_args, **a_kw)
                finally:
                    solver.apgd = kept
                diff["solve, plain"] = torch.maximum(diff["solve, plain"],
                                                     compare(plain, out))
        dyn = env_a._dynamics
        env_a._dynamics = lambda qp, qv, target: (nxt_b.qpos.to(dev_a),
                                                  nxt_b.qvel.to(dev_a))
        try:
            nxt_a = env_a.step(state.map(lambda t: t.to(dev_a)),
                               action.to(dev_a))
        finally:
            env_a._dynamics = dyn
    done = (nxt_a.done.cpu() != nxt_b.done.cpu()).double()
    diff["reward, done"] = torch.maximum(step_diffs(nxt_a, nxt_b), done)
    return {"modules": diff, "a_bf16_flips": flips, "calls": len(rec)}


def ulp_sensitivity(env, state: EnvState, action: torch.Tensor,
                    seed: int) -> torch.Tensor:
    """(B,) :func:`step_diffs` of one step on ``env``'s device from
    ``state`` and from ``state`` with every qpos and qvel entry one f32 ulp
    away (directions from ``seed``): how far rounding at the inputs alone
    moves that step on one device."""
    dev = env.model.qpos0.device
    st = state.map(lambda t: t.to(dev))

    def moved(x, j):
        up = ulp_directions(x.shape, 1, seed + j)[0].to(dev)
        inf = torch.full_like(x, math.inf)
        return torch.nextafter(x, torch.where(up, inf, -inf))
    q, v = moved(st.qpos, 0), moved(st.qvel, 1)
    near = dataclasses.replace(st, qpos=q, qvel=v, obs=env._obs(
        q, v, st.mocap_idx, st.init_idx))
    with torch.no_grad():
        return step_diffs(env.step(near, action.to(dev)),
                          env.step(st, action.to(dev)))


def keep_every(every: int, states: list, actions: list) -> Callable:
    """A ``runner.rollout(keep=...)`` callback that keeps the state and the
    action of every ``every``-th step."""
    def keep(t, state, action):
        if t % every == 0:
            states.append(state)
            actions.append(action)
    return keep


# ---------------------------------------------------------------------------
# episodes from starts one ulp apart


def ulp_directions(shape, k: int, seed: int) -> torch.Tensor:
    """(k, *shape) bool on the host, True where copy j + 1 moves up: the same
    draws on every device."""
    gen = torch.Generator().manual_seed(seed)
    return torch.rand((k,) + tuple(shape), generator=gen) < 0.5


def ulp_starts(env, frames, k: int, seed: int) -> EnvState:
    """``k`` copies of ``env.reset_at(frames)``, copy-major: copy 0 exact,
    copy j > 0 with every qpos entry moved one f32 ulp up or down
    (``torch.nextafter``) in directions of :func:`ulp_directions`, its obs
    recomputed."""
    base = env.reset_at(frames)
    up = ulp_directions(base.qpos.shape, k - 1, seed).to(base.qpos.device)
    inf = torch.full_like(base.qpos, math.inf)
    qpos = [base.qpos] + [torch.nextafter(base.qpos, torch.where(u, inf, -inf))
                          for u in up]
    rep = base.map(lambda t: t.repeat((k,) + (1,) * (t.dim() - 1)))
    return env._state(torch.cat(qpos), rep.qvel, rep.mocap_idx, rep.init_idx)


def qpos_trace(trace: list) -> Callable:
    """A ``runner.rollout(keep=...)`` callback that keeps every step's qpos
    (the state before the step) in ``trace``, on its device."""
    def keep(t, state, action):
        trace.append(state.qpos)
    return keep


def distances(trace_a: torch.Tensor, trace_b: torch.Tensor) -> torch.Tensor:
    """(T, B) ‖Δqpos‖∞ per step and env of two (T, B, nq) traces."""
    return (trace_a.double() - trace_b.double()).abs().amax(dim=2)


def curves(dist: torch.Tensor, steps=CURVE_STEPS,
           split: float = SPLIT) -> dict:
    """The median and the maximum over envs of ``dist`` (T, B) at
    ``steps`` (a step s is the state after s steps: row s), and the first
    step at which at least half the envs exceed ``split`` (None: never)."""
    med = {s: float(dist[s].quantile(0.5)) for s in steps
           if s < dist.shape[0]}
    mx = {s: float(dist[s].max()) for s in steps if s < dist.shape[0]}
    half = (dist > split).double().mean(dim=1) >= 0.5
    first = int(half.nonzero()[0, 0]) if bool(half.any()) else None
    return {"median": med, "max": mx, "split_step": first}


def episode_spread(ep_len: torch.Tensor, ep_ret: torch.Tensor,
                   k: int) -> dict:
    """Per copy (copy-major, ``k`` copies) the mean episode length and the
    reward per step (mean return over mean length), with the sample
    spread ``s`` of those ``k`` means and the means over every copy."""
    lens = ep_len.double().reshape(k, -1).mean(dim=1)
    rets = ep_ret.double().reshape(k, -1).mean(dim=1)
    rps = rets / lens.clamp(min=1.0)
    return {"k": k, "ep_len": lens.tolist(), "reward_per_step": rps.tolist(),
            "ep_len_mean": float(lens.mean()),
            "reward_per_step_mean": float(rps.mean()),
            "ep_len_s": float(lens.std()) if k > 1 else 0.0,
            "reward_per_step_s": float(rps.std()) if k > 1 else 0.0}


def verdict(one_step_ok: bool, pairs: dict, spread: dict,
            ratio: float = CURVE_RATIO) -> dict:
    """Chaos, not a bias of one device, if (1) the one-step check passed,
    (2) at every step of the curves the median of the card-CPU pair
    ``pairs["card_cpu"]`` is at most ``ratio`` times the larger of the
    one-ulp pairs ``pairs["card_ulp"]`` and ``pairs["cpu_ulp"]``, and (3)
    the two devices' mean EpLen and reward per step differ by at most
    3·sqrt(s_card²/K_card + s_cpu²/K_cpu) (``spread["card"]``,
    ``spread["cpu"]`` from :func:`episode_spread`)."""
    cc, ca, cu = (pairs[k]["median"] for k in ("card_cpu", "card_ulp",
                                                "cpu_ulp"))
    curve_ok = {s: cc[s] <= ratio * max(ca[s], cu[s]) for s in cc}
    sc, su = spread["card"], spread["cpu"]
    means = {}
    for key in ("ep_len", "reward_per_step"):
        gap = abs(sc[f"{key}_mean"] - su[f"{key}_mean"])
        bound = 3.0 * math.sqrt(sc[f"{key}_s"] ** 2 / sc["k"]
                                + su[f"{key}_s"] ** 2 / su["k"])
        means[key] = {"gap": gap, "bound": bound, "ok": gap <= bound}
    chaos = (one_step_ok and all(curve_ok.values())
             and all(m["ok"] for m in means.values()))
    return {"one_step_ok": one_step_ok, "curves_ok": curve_ok,
            "means": means, "verdict": "chaos" if chaos else "bias"}
