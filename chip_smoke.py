#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``deepmimic_mujoco_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing its lines before the last:

1. device — the card's name and power limit, as ``nvidia-smi`` prints them;
2. build  — compiles ``ops/csrc/apgd.cu`` and ``ops/csrc/apgd_wide.cu``
   with nvcc, one process per source started together; prints the seconds
   and each instantiation's registers, spills and static shared memory
   (``-Xptxas -v``);
3. kernel — both APGD entry points (``apgd_solve``: (B, ne, ne);
   ``apgd_solve_lanes``: (ne, ne, B)) against the plain PyTorch version on
   the same inputs, at the main path's B = 4096, ne = 32, with f32 and bf16
   A at 15, 8 and 60 iterations, in the grouped and the interleaved row
   order; the solver's dispatch ``apgd()`` in both layouts, on random
   systems and on the dual systems captured from 3 walk steps of the main
   path at 4096 envs (there also against the plain version run on the CPU,
   whose distance from the card's plain version is the f32 rounding spread
   of the reference itself); then the timing of each entry point at the
   main path's shape (bf16 A, 15 iterations) and of one env step's four
   solves (15 + 8 + 8 + 8 iterations) through ``apgd()`` in each layout:
   ``ms`` is CUDA events around 200 launches made from Python (what a
   caller sees), and ``device_ms`` the same launches replayed from a CUDA
   graph (the device time alone, also at 0 and 60 iterations); then the
   wide kernel (``apgd_solve_wide``, ne > 32) against the plain version at
   B = 4096, ne = 64 (16/16 caps) and 139 (uncapped), f32 and bf16 A, and
   its ``ms``, ``device_ms`` and bound; then [caps]: 16 envs × 20 steps of
   the humanoid with 16/16 caps and uncapped on the card, every solve
   through the wide kernel (counted; ``_apgd_scan`` not called), held
   against the same rollouts on the CPU;
4. main path — ``cli.train_trpo --task evaluate`` of the bundled walk
   checkpoint at 4096 and 768 envs × 200 steps, once per kernel layout,
   with the launch counts set to 0 just before each run and read just after,
   before any profiler session; then [train], also before any profiler
   session: ``TRPO.iteration`` at 768 and 4096 envs × 64 steps, g_step 1
   (bench.py's configuration; one warm-up and 2 timed iterations each,
   the counts set to 0 just before the timed ones): env-steps/s, the time
   of the rollout, the policy update and the vf epochs, APGD launches per
   env step (4), meankl ≤ 1.5·max_kl and finite stats; one
   ``_segment_update`` on the card against the CPU from the same segment;
   and ``python -m deepmimic_mujoco_torch.cli.train_trpo --task train
   --num-iters 2`` at 768 envs, whose checkpoint must read back; then
   [imitation], the README's imitation recipe (``imitation_dm`` reward,
   ``pd_residual`` control, 2 substeps, 300-step episodes, fall-contact
   termination, the 68-D obs) with the bundled ``walk_r2`` policy (relu
   1024-512), also before any profiler session: ``--task evaluate`` over
   4096 RSI episodes x 300 steps (mean and median episode length ≥ 95% of
   the cap, reward per step within 0.03 of the port's CPU figure, 8
   ``apgd_solve`` launches per control step, no wide launch, no call of
   the plain ``_apgd_scan``), ``TRPO.iteration`` with the recipe's flags
   at 4096 envs x 32 steps (one warm-up, one timed) and the training CLI
   at 64 envs for one iteration, whose checkpoint must read back; then
   profiler windows of one env step's
   four solves through ``apgd()`` (blocks: four kernels and nothing else),
   and ``torch.profiler`` windows of 5 env steps at 4096 envs and of 3
   recipe steps at 4096 envs (step time, device busy share, kernel
   launches per step, the solve's device time and launches per step, top
   kernels); the 4096-env blocks evaluation again, after those profiler
   sessions; then 16-env, 20-step rollouts on the card, of the walk
   evaluation and of the recipe, held against the same rollouts on the CPU
   (plain versions: qpos and rewards within 1e-3, equal done flags);
5. one JSON line with every kernel's numbers (with the registers, spills
   and shared memory of the instantiation the main path runs, and ptxas's
   figures for every instantiation), then the result line.

Nothing is caught: a phase that fails ends the run with a non-zero code.
Without CUDA the run stops before any phase.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

CKPT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "train_ckpt",
                    "DPEnvV3", "trpo-walk-0", "trpo_state.npz")
SEED = 0
NC, NL = 8, 8
NE = 3 * NC + NL
B_MAIN = 4096
HORIZON = 200
ATOL = 1e-4          # TestAPGD's tolerance: the sums run in another order
ROLLOUT_ATOL = 1e-3  # 20 physics steps, card (kernel) vs CPU (plain)
HBM_BYTES_PER_S = 3.35e12    # H100 SXM
F32_FLOPS_PER_S = 67e12      # H100 SXM, f32 without tensor cores


WIDE = ((16, 16), (37, 28))  # (nc, nl): 16/16 caps (ne 64), uncapped (139)
TRAIN_HORIZON = 64           # bench.py's TRPO configuration: g_step 1
MAX_KL = 0.01                # TRPOConfig's default

# the imitation recipe (README "Quick start") and its bundled policy
CKPT_R2 = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "train_ckpt_walk_r2", "DPEnvV3", "trpo-walk-0",
                       "trpo_state.npz")
RECIPE_ENV = dict(clip="walk", reward_mode="imitation_dm",
                  control_mode="pd_residual", n_substeps=2,
                  max_episode_steps=300)
RECIPE_POLICY = dict(ob_dim=68, ac_dim=28, hidden_sizes=(1024, 512),
                     activation="relu", fixed_logstd=-3.0)
RECIPE_FLAGS = ["--reward-mode", "imitation_dm", "--control-mode",
                "pd_residual", "--n-substeps", "2", "--max-episode-steps",
                "300", "--hidden-sizes", "1024,512", "--activation", "relu",
                "--fixed-logstd", "-3.0"]
RECIPE_TRAIN_FLAGS = ["--reset-mode", "rsi", "--gamma", "0.95", "--lam",
                      "0.95"]
IMIT_HORIZON = 300           # the recipe's episode cap
IMIT_TRAIN_HORIZON = 32
# reward per step of walk_r2 on the CPU: the port's cli.eval_imitation,
# 32 deterministic episodes x 300 steps from the frames that JAX's
# tools/eval_imitation.py draws (JAX: 0.771 on the same frames)
CPU_REWARD_PER_STEP = 0.7718


def _problem(torch, B: int, a_dtype, gen, nc: int = NC, nl: int = NL):
    """Well-conditioned dual systems, batch-major (any row order)."""
    dev = "cuda"
    ne = 3 * nc + nl
    m = torch.randn((B, ne, ne), generator=gen, device=dev)
    a = (m @ m.transpose(1, 2)) / ne + 0.5 * torch.eye(ne, device=dev)
    b = torch.randn((B, ne), generator=gen, device=dev)
    mu = 0.5 + torch.rand((B, nc), generator=gen, device=dev)
    f0 = 0.1 * torch.randn((B, ne), generator=gen, device=dev)
    return a.to(a_dtype).contiguous(), b, mu, f0


def _ptxas(log: str) -> dict:
    """Registers, spill bytes and static shared memory of each kernel
    instantiation in nvcc's ``-Xptxas -v`` output, keyed "bf16/slots8" etc."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            dtype = "bf16" if "13__nv_bfloat16" in m.group(1) else "f32"
            if "apgd_wide_kernel" in m.group(1):
                name = "wide/" + dtype
            else:
                name = dtype + ("/slots8" if "Lb1E" in m.group(1)
                                else "/general")
            out[name] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name:
            out[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", ln)
            out[name]["static_smem"] = int(m.group(1)) if m else 0
    return out


def _bound(B: int, iters: int, nc: int = NC, nl: int = NL, es: int = 2):
    """Least time of one solve on an H100 SXM, A of ``es`` bytes an
    element: its bytes (A, b, mu, f0, f each once) over HBM rate against
    its matvec flops over the f32 rate."""
    ne = 3 * nc + nl
    nbytes = B * ne * ne * es + 4 * B * (3 * ne + nc)
    flops = 2 * B * ne * ne * iters
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def _capture(solver, runner, env, policy, params, state, steps):
    """The dual systems (a, b, mu, f0, iterations) that ``steps`` walk steps
    of the main path hand to the solve dispatch."""
    seen = []
    dispatch = solver.apgd

    def spy(a, b, mu, f0, **kw):
        seen.append((a.clone(), b.clone(), mu.clone(), f0.clone(),
                     kw["iterations"]))
        return dispatch(a, b, mu, f0, **kw)

    solver.apgd = spy
    try:
        runner.rollout(env, policy, params, state, steps)
    finally:
        solver.apgd = dispatch
    return seen


def _wide_kernel(torch, ops, timing) -> dict:
    """[kernel] the wide kernel (ne > 32) against the plain version at
    B = 4096 for each shape of ``WIDE``, f32 and bf16 A, 15/8/60
    iterations; then its time at 15 iterations: ``ms`` from Python (CUDA
    events around 50 launches), ``device_ms`` from a CUDA graph."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    out = {}
    for nc, nl in WIDE:
        ne = 3 * nc + nl
        rec = {"max_abs_err": 0.0}
        for a_dtype in (torch.float32, torch.bfloat16):
            a, b, mu, f0 = _problem(torch, B_MAIN, a_dtype, gen, nc, nl)
            for iters in (15, 8, 60):
                kw = dict(iterations=iters, nc=nc, nl=nl)
                ref = ops._apgd_scan(a, b, mu, f0, **kw)
                got = ops.apgd_solve_wide(a, b, mu, f0, **kw)
                torch.cuda.synchronize()
                e = float((got - ref).abs().max())
                rec["max_abs_err"] = max(rec["max_abs_err"], e)
                print(f"[kernel] apgd_solve_wide ne={ne} (nc {nc}, nl {nl}) "
                      f"A={str(a_dtype)[6:]} iters={iters}: max_abs_err "
                      f"{e:.3e} (|ref| max {float(ref.abs().max()):.3f}, "
                      f"atol {ATOL})")
                if not e <= ATOL:
                    raise AssertionError(f"apgd_solve_wide ne={ne} disagrees "
                                         f"with the plain version: {e}")
            kw = dict(iterations=15, nc=nc, nl=nl)
            es = 2 if a_dtype is torch.bfloat16 else 4
            ms = timing.eager_ms(
                lambda: ops.apgd_solve_wide(a, b, mu, f0, **kw), 50)
            dev = timing.graph_ms(
                lambda: ops.apgd_solve_wide(a, b, mu, f0, **kw), calls=20,
                replays=2)
            plain_ms = timing.eager_ms(
                lambda: ops._apgd_scan(a, b, mu, f0, **kw), 5)
            bound_s, bound_by = _bound(B_MAIN, 15, nc, nl, es)
            smem = ops.wide_smem_bytes(ne, es == 2)
            rec[str(a_dtype)[6:]] = {
                "ms": ms, "device_ms": dev, "plain_ms": plain_ms,
                "bound_ms": bound_s * 1e3, "bound_by": bound_by,
                "smem_bytes": smem}
            print(f"[kernel] apgd_solve_wide B={B_MAIN} ne={ne} "
                  f"{str(a_dtype)[6:]} iters=15: {ms:.4f} ms (CUDA events "
                  f"over 50 launches from Python), device {dev:.4f} ms (CUDA "
                  f"graph), plain {plain_ms:.4f} ms, bound "
                  f"{bound_s * 1e3:.4f} ms ({bound_by}), {smem} B shared "
                  "memory per block, library call: none")
        out[ne] = rec
    return out


def _zero_counts(ops) -> None:
    for fn in (ops.apgd_solve, ops.apgd_solve_lanes, ops.apgd_solve_wide):
        fn.launches = 0


def _counts(ops) -> dict:
    return {fn.__name__: fn.launches for fn in (
        ops.apgd_solve, ops.apgd_solve_lanes, ops.apgd_solve_wide)}


def _larger_caps(torch, ops, steps: int = 20) -> int:
    """[caps] 16 envs x ``steps`` steps of the humanoid with 16/16 caps
    (ne = 64) and uncapped (ne = 139), bundled checkpoint: on the card every
    solve goes to the wide kernel (4 per step; ``_apgd_scan`` is not
    called), held against the same rollout on the CPU (plain versions).
    Returns the wide kernel's launches."""
    from deepmimic_mujoco_torch.algos import runner
    from deepmimic_mujoco_torch.envs.dp_env_v3 import DPEnvV3
    from deepmimic_mujoco_torch.io_utils import checkpoint
    from deepmimic_mujoco_torch.models.policy import MlpPolicy
    from deepmimic_mujoco_torch.physics.humanoid import build_humanoid

    idx = torch.arange(16) * 2 % 39
    launches = 0
    for caps, label in ((16, "caps 16/16, ne 64"),
                        (1 << 30, "uncapped, ne 139")):
        out = {}
        for dev in ("cuda", "cpu"):
            env = DPEnvV3(model=build_humanoid(contact_cap=caps,
                                               limit_cap=caps, device=dev))
            policy = MlpPolicy(ob_dim=56, ac_dim=28)
            params = checkpoint.load_trpo_params(CKPT, policy, dev)
            state = env.reset_at(idx)
            if dev == "cpu":
                out[dev] = runner.rollout(env, policy, params, state, steps)
                continue
            plain, scans = ops._apgd_scan, []

            def spy(*args, **kw):
                scans.append(1)
                return plain(*args, **kw)

            ops._apgd_scan = spy
            _zero_counts(ops)
            try:
                out[dev] = runner.rollout(env, policy, params, state, steps)
                torch.cuda.synchronize()
            finally:
                ops._apgd_scan = plain
            n = _counts(ops)
            want = {"apgd_solve": 0, "apgd_solve_lanes": 0,
                    "apgd_solve_wide": 4 * steps}
            if n != want or scans:
                raise AssertionError(f"{label}: launches {n}, expected "
                                     f"{want}; _apgd_scan called "
                                     f"{len(scans)} times")
            launches += n["apgd_solve_wide"]
        d_q = float((out["cuda"].state.qpos.cpu()
                     - out["cpu"].state.qpos).abs().max())
        same_len = bool((out["cuda"].ep_len.cpu() == out["cpu"].ep_len).all())
        print(f"[caps] {label}: 16 envs x {steps} steps, card vs CPU: qpos "
              f"max_abs_diff {d_q:.3e} (atol {ROLLOUT_ATOL}), ep_len equal "
              f"{same_len}; on the card {4 * steps} apgd_solve_wide launches, "
              "no other APGD launch, _apgd_scan not called")
        if not (d_q <= ROLLOUT_ATOL and same_len):
            raise AssertionError(f"{label}: the card's rollout disagrees "
                                 "with the CPU's")
    return launches


def _timed(fn, acc: dict, key: str):
    """``fn`` with its wall time (between two synchronizations) added to
    ``acc[key]``."""
    import torch

    def run(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        acc[key] += time.perf_counter() - t0
        return out
    return run


def _train(torch, ops, n_envs: int, timed_iters: int = 2,
           recipe: bool = False) -> dict:
    """[train] ``TRPO.iteration`` at ``n_envs`` envs x 64 steps, g_step 1
    (bench.py's configuration), from random params: one warm-up iteration,
    then ``timed_iters`` timed ones, with the launch counts set to 0 just
    before them and read just after.  Phase times are wall time between
    synchronizations around the rollout, the policy update (gradient, CG,
    line search) and the vf epochs.  ``recipe``: [imitation], the same on
    the imitation recipe's env, policy and flags at 32 steps (8 APGD
    launches per control step: 2 substeps of 4 stage solves)."""
    from collections import deque

    from deepmimic_mujoco_torch.algos.trpo import TRPO, TRPOConfig
    from deepmimic_mujoco_torch.envs.dp_env_v3 import DPEnvV3
    from deepmimic_mujoco_torch.models.policy import MlpPolicy
    from deepmimic_mujoco_torch.physics.humanoid import build_humanoid

    model = build_humanoid(device="cuda")
    if recipe:
        tag, horizon, per_step = "[imitation]", IMIT_TRAIN_HORIZON, 8
        learner = TRPO(DPEnvV3(model=model, **RECIPE_ENV),
                       MlpPolicy(**RECIPE_POLICY),
                       TRPOConfig(horizon=horizon, num_envs=n_envs, g_step=1,
                                  gamma=0.95, lam=0.95, reset_mode="rsi"))
    else:
        tag, horizon, per_step = "[train]", TRAIN_HORIZON, 4
        learner = TRPO(DPEnvV3(model=model), MlpPolicy(ob_dim=56, ac_dim=28),
                       TRPOConfig(horizon=horizon, num_envs=n_envs,
                                  g_step=1))
    phase = {"rollout": 0.0, "policy update": 0.0, "vf epochs": 0.0}
    learner._rollout = _timed(learner._rollout, phase, "rollout")
    learner._policy_update = _timed(learner._policy_update, phase,
                                    "policy update")
    learner._vf_update = _timed(learner._vf_update, phase, "vf epochs")
    state = learner.init(torch.Generator(device="cuda").manual_seed(SEED))
    lens: deque = deque(maxlen=40)

    def iterate(state):
        state, stats = learner.iteration(state)
        ended = stats.ep_lens.reshape(-1)
        lens.extend(int(x) for x in ended[ended > 0].cpu())
        return state, stats

    state, _ = iterate(state)  # warm-up
    for k in phase:
        phase[k] = 0.0
    _zero_counts(ops)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed_iters):
        state, stats = iterate(state)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = _counts(ops)
    steps = timed_iters * horizon
    rec = {k: float(getattr(stats, k)) for k in (
        "meankl", "surrgain", "ev_tdlam_before", "optimgain", "entropy")}
    rec["EpLenMean"] = sum(lens) / len(lens) if lens else float("nan")
    rec.update(env_steps_per_s=n_envs * steps / dt,
               iteration_s=dt / timed_iters,
               phase_s={k: v / timed_iters for k, v in phase.items()},
               apgd_launches_per_env_step=n["apgd_solve"] / steps,
               launches=n)
    env = learner.env
    rec["env"] = {k: getattr(env, k) for k in (
        "reward_mode", "control_mode", "n_substeps", "pd_target_interp",
        "obs_mode", "include_phase", "termination", "max_episode_steps",
        "observation_size")}
    print(f"{tag} TRPO.iteration {n_envs} envs x {horizon} steps, "
          f"g_step 1, {timed_iters} timed after 1 warm-up: "
          f"{rec['env_steps_per_s']:.1f} env-steps/s, "
          f"{rec['iteration_s']:.3f} s per iteration ("
          + ", ".join(f"{k} {v:.3f} s" for k, v in rec["phase_s"].items())
          + f"); APGD launches per env step "
          f"{rec['apgd_launches_per_env_step']:.2f} ({n}); meankl "
          f"{rec['meankl']:.5f}, surrgain {rec['surrgain']:.5f}, "
          f"ev_tdlam_before {rec['ev_tdlam_before']:.4f}, EpLenMean "
          f"{rec['EpLenMean']:.2f}")
    # EpLenMean is NaN only when no episode ended in the iterations run
    finite = all(v == v and abs(v) != float("inf") for k, v in rec.items()
                 if k in ("meankl", "surrgain", "ev_tdlam_before",
                          "optimgain", "entropy")
                 or (k == "EpLenMean" and lens))
    if not (finite and rec["meankl"] <= 1.5 * MAX_KL):
        raise AssertionError(f"{tag} {n_envs} envs: stats {rec}")
    if n != {"apgd_solve": per_step * steps, "apgd_solve_lanes": 0,
             "apgd_solve_wide": 0}:
        raise AssertionError(f"{tag} {n_envs} envs: APGD launches {n}, "
                             f"expected {per_step} per env step "
                             f"({per_step * steps})")
    return rec


def _segment_card_vs_cpu(torch) -> dict:
    """[train] one ``_segment_update`` on the card against the CPU, from the
    same 16-env x 32-step segment (a rollout on the card), permutations and
    params; TF32 is off (PyTorch's default for matmul)."""
    from deepmimic_mujoco_torch.algos import adam
    from deepmimic_mujoco_torch.algos.trpo import (TRPO, Draws, TRPOConfig,
                                                   flatten, policy_leaves,
                                                   vf_leaves)
    from deepmimic_mujoco_torch.envs.dp_env_v3 import DPEnvV3
    from deepmimic_mujoco_torch.models.policy import MlpPolicy
    from deepmimic_mujoco_torch.physics.humanoid import build_humanoid

    B, T = 16, 32
    gen = torch.Generator().manual_seed(SEED)
    policy = MlpPolicy(ob_dim=56, ac_dim=28)
    params_cpu = policy.init(gen, "cpu")
    perms = torch.stack([torch.randperm(B * T, generator=gen)
                         for _ in range(3)])

    class FixedPerms(Draws):
        def vf_permutations(self, n, epochs, device):
            return perms.to(device)

    res = {}
    for dev in ("cuda", "cpu"):
        learner = TRPO(DPEnvV3(model=build_humanoid(device=dev)), policy,
                       TRPOConfig(horizon=T, num_envs=B))
        params = {
            "pol": [{k: x.to(dev) for k, x in layer.items()}
                    for layer in params_cpu["pol"]],
            "vf": [{k: x.to(dev) for k, x in layer.items()}
                   for layer in params_cpu["vf"]],
            "logstd": params_cpu["logstd"].to(dev),
            "ob_rms": type(params_cpu["ob_rms"])(
                *(x.to(dev) for x in params_cpu["ob_rms"]))}
        if dev == "cuda":
            g = torch.Generator(device="cuda").manual_seed(SEED)
            seg = learner._rollout(
                params, learner.env.reset(g, B),
                torch.ones(B, dtype=torch.bool, device="cuda"), Draws(g),
                torch.zeros(B, device="cuda"),
                torch.zeros(B, dtype=torch.int32, device="cuda"))[0]
        n_vf = sum(x.numel() for x in vf_leaves(params))
        out = learner._segment_update(
            params, adam.init(n_vf, dev),
            {k: v.to(dev) for k, v in seg.items()}, FixedPerms(None))
        res[dev] = tuple(x.cpu() if isinstance(x, torch.Tensor) else x
                         for x in out[:4]) + (out[4],)

    def rel(a, b):
        return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))

    (pc, ac, lc, ec, ic), (pp, ap, lp, ep, ip) = res["cuda"], res["cpu"]
    d = {"pol": rel(flatten(policy_leaves(pc)).cpu(),
                    flatten(policy_leaves(pp))),
         "vf": rel(flatten(vf_leaves(pc)).cpu(), flatten(vf_leaves(pp))),
         "ob_rms": max(rel(x.cpu(), y) for x, y in zip(pc["ob_rms"],
                                                       pp["ob_rms"])),
         "adam_m": rel(ac.m.cpu(), ap.m), "losses": rel(lc, lp),
         "ev": rel(ec, ep)}
    bounds = {"pol": 1e-4, "vf": 1e-3, "ob_rms": 1e-5, "adam_m": 1e-3,
              "losses": 1e-4, "ev": 1e-4}
    print(f"[train] one _segment_update from a {B}-env x {T}-step segment, "
          f"card vs CPU: max diff / max(1, max|x|): " + ", ".join(
              f"{k} {v:.3e} (bound {bounds[k]:.0e})" for k, v in d.items())
          + f"; step size {ic.stepsize} / {ip.stepsize}, accepted "
          f"{ic.accepted} / {ip.accepted}")
    if not (all(d[k] <= bounds[k] for k in d)
            and (ic.stepsize, ic.accepted) == (ip.stepsize, ip.accepted)):
        raise AssertionError("[train] the card's segment update disagrees "
                             "with the CPU's")
    return d


def _train_cli(n_envs: int = 768, recipe: bool = False) -> None:
    """[train] ``python -m deepmimic_mujoco_torch.cli.train_trpo --task train
    --num-iters 2`` at ``n_envs`` envs (64 steps, g_step 1) into a temporary
    directory; the checkpoint it writes reads back through
    ``load_trpo_params``.  ``recipe``: [imitation], one iteration of the
    imitation recipe's flags at 32 steps."""
    import tempfile

    import torch

    from deepmimic_mujoco_torch.io_utils import checkpoint
    from deepmimic_mujoco_torch.models.policy import MlpPolicy

    if recipe:
        tag, iters, horizon = "[imitation]", 1, IMIT_TRAIN_HORIZON
        flags, policy = RECIPE_FLAGS + RECIPE_TRAIN_FLAGS, MlpPolicy(
            **RECIPE_POLICY)
    else:
        tag, iters, horizon = "[train]", 2, TRAIN_HORIZON
        flags, policy = [], MlpPolicy(56, 28)
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m", "deepmimic_mujoco_torch.cli.train_trpo",
               "--task", "train", "--num-iters", str(iters), "--num-envs",
               str(n_envs), "--timesteps-per-batch", str(horizon),
               "--g-step", "1", "--seed", str(SEED), *flags,
               "--log-dir", os.path.join(tmp, "logs"),
               "--checkpoint-dir", os.path.join(tmp, "ckpt")]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                              timeout=400, check=False)
        dt = time.perf_counter() - t0
        if proc.returncode != 0:
            print(proc.stdout[-3000:], proc.stderr[-3000:], file=sys.stderr)
            raise AssertionError(f"the training CLI exited {proc.returncode}")
        run = os.path.join("DPEnvV3", "trpo-walk-0")
        with open(os.path.join(tmp, "logs", run, "progress.csv")) as fh:
            rows = fh.read().strip().splitlines()
        path = os.path.join(tmp, "ckpt", run, "trpo_state.npz")
        params = checkpoint.load_trpo_params(path, policy, "cuda")
        finite = all(bool(torch.isfinite(x).all()) for x in
                     [params["logstd"]] + [layer["w"] for layer in
                                           params["pol"] + params["vf"]])
        last = dict(zip(rows[0].split(","), rows[-1].split(",")))
        print(f"{tag} CLI --task train --num-iters {iters} at {n_envs} envs "
              f"x {horizon} steps: exit 0 in {dt:.1f} s (process start and "
              f"imports included), {len(rows) - 1} progress rows, last "
              f"meankl {last['meankl']} EpLenMean {last['EpLenMean']}; its "
              f"checkpoint reads back through load_trpo_params, finite "
              f"{finite}")
        if len(rows) != iters + 1 or not finite:
            raise AssertionError(f"{tag} the CLI's log or checkpoint is off")


def _imitation_eval(torch, ops, train_trpo) -> dict:
    """[imitation] ``cli.train_trpo --task evaluate`` of walk_r2 with the
    recipe's flags: 4096 RSI episodes x 300 steps, deterministic, the
    launch counts set to 0 just before and read just after; the plain
    ``_apgd_scan`` must not be called on the card."""
    plain, scans = ops._apgd_scan, []

    def spy(*args, **kw):
        scans.append(1)
        return plain(*args, **kw)

    ops._apgd_scan = spy
    _zero_counts(ops)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        res = train_trpo.main([
            "--task", "evaluate", "--load-model-path", CKPT_R2,
            "--eval-episodes", str(B_MAIN), "--eval-horizon",
            str(IMIT_HORIZON), *RECIPE_FLAGS, "--device", "cuda",
            "--seed", str(SEED)])
        torch.cuda.synchronize()
    finally:
        ops._apgd_scan = plain
    dt = time.perf_counter() - t0
    n = _counts(ops)
    lens = res.rollout.ep_len.double()
    rec = {"ep_len_mean": float(lens.mean()),
           "ep_len_median": float(lens.quantile(0.5)),
           "reward_per_step": res.avg_ret / res.avg_len,
           "env_steps_per_s": B_MAIN * IMIT_HORIZON / dt, "seconds": dt,
           "apgd_launches_per_control_step": {
               "blocks": n["apgd_solve"] / IMIT_HORIZON,
               "wide": n["apgd_solve_wide"] / IMIT_HORIZON},
           "apgd_scan_calls": len(scans), "launches": n}
    st = res.rollout.state
    finite = all(bool(torch.isfinite(x).all())
                 for x in (st.qpos, st.qvel, st.obs))
    print(f"[imitation] evaluate walk_r2, {B_MAIN} RSI episodes x "
          f"{IMIT_HORIZON} steps, deterministic: EpLen mean "
          f"{rec['ep_len_mean']:.2f} median {rec['ep_len_median']:.0f}, "
          f"reward per step {rec['reward_per_step']:.4f} (the port on the "
          f"CPU: {CPU_REWARD_PER_STEP}), {dt:.2f} s, "
          f"{rec['env_steps_per_s']:.1f} env-steps/s; APGD launches per "
          f"control step: blocks "
          f"{rec['apgd_launches_per_control_step']['blocks']:.2f}, wide "
          f"{rec['apgd_launches_per_control_step']['wide']:.2f}; "
          f"_apgd_scan called {len(scans)} times; finite {finite}")
    if not (finite and rec["ep_len_mean"] >= 0.95 * IMIT_HORIZON
            and abs(rec["reward_per_step"] - CPU_REWARD_PER_STEP) <= 0.03):
        raise AssertionError(f"[imitation] evaluation off: {rec}")
    if n != {"apgd_solve": 8 * IMIT_HORIZON, "apgd_solve_lanes": 0,
             "apgd_solve_wide": 0} or scans:
        raise AssertionError(f"[imitation] APGD launches {n}, expected 8 "
                             f"per control step; _apgd_scan {len(scans)}")
    return rec


def _imitation_card_vs_cpu(torch) -> dict:
    """[imitation] 16 envs x 20 steps of the recipe env from fixed mocap
    frames through walk_r2, on the card (kernel) and on the CPU (plain)."""
    from deepmimic_mujoco_torch.algos import runner
    from deepmimic_mujoco_torch.envs.dp_env_v3 import DPEnvV3
    from deepmimic_mujoco_torch.io_utils import checkpoint
    from deepmimic_mujoco_torch.models.policy import MlpPolicy
    from deepmimic_mujoco_torch.physics.humanoid import build_humanoid

    idx = torch.arange(16) * 5 % 39
    out = {}
    for dev in ("cuda", "cpu"):
        env = DPEnvV3(model=build_humanoid(device=dev), **RECIPE_ENV)
        policy = MlpPolicy(**RECIPE_POLICY)
        params = checkpoint.load_trpo_params(CKPT_R2, policy, dev)
        out[dev] = runner.rollout(env, policy, params, env.reset_at(idx), 20,
                                  record=True)
    c, p = out["cuda"], out["cpu"]
    d = {"qpos": float((c.state.qpos.cpu() - p.state.qpos).abs().max()),
         "obs": float((c.traj[0].cpu() - p.traj[0]).abs().max()),
         "reward": float((c.traj[2].cpu() - p.traj[2]).abs().max())}
    same_done = bool((c.ep_len.cpu() == p.ep_len).all()
                     and (c.state.done.cpu() == p.state.done).all())
    print(f"[imitation] 16 envs x 20 steps of the recipe, card vs CPU: qpos "
          f"max_abs_diff {d['qpos']:.3e} (atol {ROLLOUT_ATOL}), obs "
          f"{d['obs']:.3e}, reward {d['reward']:.3e} (atol {ROLLOUT_ATOL}); "
          f"done flags and episode lengths equal {same_done}")
    if not (d["qpos"] <= ROLLOUT_ATOL and d["reward"] <= ROLLOUT_ATOL
            and same_done):
        raise AssertionError("[imitation] the card's recipe rollout "
                             "disagrees with the CPU's")
    d["done_equal"] = same_done
    return d


def _profile(torch, runner, env, policy, params, state, steps: int,
             tag: str) -> dict:
    """A ``torch.profiler`` window of ``steps`` env steps (after 2 warm-up
    steps): step time, device busy share, kernel launches per step, the
    APGD kernel's share, top device kernels."""
    runner.rollout(env, policy, params, state, 2)  # warm-up
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        runner.rollout(env, policy, params, state, steps)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    rows = [(getattr(e, "self_device_time_total", 0.0), e.count, e.key)
            for e in prof.key_averages()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    busy_us = sum(r[0] for r in rows)
    apgd_us = sum(r[0] for r in rows if "apgd_kernel" in r[2])
    apgd_n = sum(r[1] for r in rows if "apgd_kernel" in r[2]) / steps
    launches_per_step = sum(r[1] for r in rows) / steps
    top = sorted(rows, reverse=True)[:5]
    ms = 1e3 * steps
    if busy_us > 0:
        busy = (f"device busy {busy_us / ms:.2f} ms per step "
                f"({100 * busy_us / window_us:.1f}%), {launches_per_step:.0f} "
                f"kernel launches per step, the solve dispatch (APGD kernel) "
                f"{apgd_us / ms:.4f} ms per step over {apgd_n:.0f} launches "
                f"({100 * apgd_us / busy_us:.2f}% of the device time); top: "
                + "; ".join(f"{k[:48]} {t / ms:.3f} ms x{c // steps}"
                            for t, c, k in top))
    else:
        busy = "device time not measured (the profiler showed no kernels)"
    print(f"{tag} {steps} env steps at {state.qpos.shape[0]} envs: "
          f"{window_us / ms:.2f} ms per step, {busy}")
    return {"step_ms": window_us / ms, "busy_ms": busy_us / ms,
            "busy_share": busy_us / window_us,
            "launches_per_step": launches_per_step,
            "apgd_ms": apgd_us / ms, "apgd_launches_per_step": apgd_n}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from deepmimic_mujoco_torch.algos import runner
    from deepmimic_mujoco_torch.cli import train_trpo
    from deepmimic_mujoco_torch.envs.dp_env_v3 import DPEnvV3
    from deepmimic_mujoco_torch.io_utils import checkpoint
    from deepmimic_mujoco_torch.models.policy import MlpPolicy
    from deepmimic_mujoco_torch.ops import apgd as ops
    from deepmimic_mujoco_torch.ops import timing
    from deepmimic_mujoco_torch.physics import solver
    from deepmimic_mujoco_torch.physics.humanoid import build_humanoid

    t_start = time.perf_counter()
    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])  # name, power limit

    # 2. build: one nvcc per source, started together
    t0 = time.perf_counter()
    builds = ops.load_kernels(("apgd", "apgd_wide"))
    print(f"[build] both sources in {time.perf_counter() - t0:.1f} s of wall "
          "time")
    ptxas = {}
    for built in builds.values():
        found = _ptxas(built.log)
        ptxas.update(found)
        how = f"{built.seconds:.1f} s" if built.seconds else "reused"
        print(f"[build] {os.path.basename(built.path)}: nvcc {how}; "
              + "; ".join(
                  f"{k}: {v.get('registers')} registers, "
                  f"{v.get('spill_bytes')} spill bytes, "
                  f"{v.get('static_smem')} B static smem"
                  for k, v in sorted(found.items())))
    if sorted(ptxas) != ["bf16/general", "bf16/slots8", "f32/general",
                         "f32/slots8", "wide/bf16", "wide/f32"]:
        raise AssertionError(f"ptxas reported {sorted(ptxas)}")

    # 3. kernel against plain, then timing at the main path's shape
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    entry = {
        "apgd_solve": (ops.apgd_solve, lambda x: x, lambda x: x),
        "apgd_solve_lanes": (
            ops.apgd_solve_lanes,
            lambda x: x.permute(*range(1, x.dim()), 0).contiguous(),
            lambda x: x.T),
    }
    err = {name: 0.0 for name in entry}
    plain = {"grouped": ops._apgd_grouped, "interleaved": ops._apgd_scan}
    for a_dtype in (torch.float32, torch.bfloat16):
        a, b, mu, f0 = _problem(torch, B_MAIN, a_dtype, gen)
        for rows, iters in ((r, i) for r in plain for i in (15, 8, 60)):
            ref = plain[rows](a, b, mu, f0, iterations=iters, nc=NC, nl=NL)
            for name, (fn, to_layout, back) in entry.items():
                out = back(fn(to_layout(a), to_layout(b), to_layout(mu),
                              to_layout(f0), iterations=iters, nc=NC, nl=NL,
                              rows=rows))
                torch.cuda.synchronize()
                e = float((out - ref).abs().max())
                err[name] = max(err[name], e)
                print(f"[kernel] {name} A={str(a_dtype)[6:]} rows={rows} "
                      f"iters={iters}: max_abs_err {e:.3e} (|ref| max "
                      f"{float(ref.abs().max()):.3f}, atol {ATOL})")
                if not e <= ATOL:
                    raise AssertionError(f"{name} disagrees with the plain "
                                         f"version: {e} > {ATOL}")
    # the solver's dispatch (interleaved layout) against the plain oracle
    dispatch_of = {"blocks": "apgd_solve", "lanes": "apgd_solve_lanes"}
    layout_of = {v: k for k, v in dispatch_of.items()}
    a, b, mu, f0 = _problem(torch, B_MAIN, torch.bfloat16, gen)
    ref = ops._apgd_scan(a, b, mu, f0, iterations=15, nc=NC, nl=NL)
    for layout in ("blocks", "lanes"):
        out = ops.apgd(a, b, mu, f0, iterations=15, nc=NC, nl=NL,
                       layout=layout)
        e = float((out - ref).abs().max())
        err[dispatch_of[layout]] = max(err[dispatch_of[layout]], e)
        print(f"[kernel] dispatch layout={layout}: max_abs_err {e:.3e}")
        if not e <= ATOL:
            raise AssertionError(f"dispatch {layout}: {e} > {ATOL}")
    # ... and on the dual systems of the main path: bf16, many inactive rows
    # (a zero row with 1 on the diagonal)
    env = DPEnvV3(model=build_humanoid(device="cuda"))
    policy = MlpPolicy(ob_dim=56, ac_dim=28)
    params = checkpoint.load_trpo_params(CKPT, policy, "cuda")
    state = env.reset_at(torch.arange(B_MAIN) % env.clip_len)
    systems = _capture(solver, runner, env, policy, params, state, 3)
    a_sys = torch.stack([s_[0].float() for s_ in systems])
    diag = torch.diagonal(a_sys, dim1=-2, dim2=-1)
    inactive = float(((a_sys.abs().sum(-1) == 1) & (diag == 1)).float().mean())
    # Their forces reach ~10^3, where one f32 ulp (2.4e-4 at 2,048) exceeds
    # 1e-4: the bound there is ATOL in units of the system's largest force
    # (max(1, max|f|)), which is ATOL itself on the O(1) random systems.  The
    # inactive rows are held to ATOL absolute.  A second witness: the plain
    # version on the CPU, whose distance from the card's plain version is
    # the reference's own f32 rounding spread on these systems.
    refs = []
    for a_c, b_c, mu_c, f0_c, n_it in systems:
        a_row = a_c.float()
        dead = ((a_row.abs().sum(-1) == 1)
                & (torch.diagonal(a_row, dim1=-2, dim2=-1) == 1))
        for iters in (n_it, 60):
            kw = dict(iterations=iters, nc=NC, nl=NL)
            ref = ops._apgd_scan(a_c, b_c, mu_c, f0_c, **kw)
            ref_cpu = ops._apgd_scan(a_c.cpu(), b_c.cpu(), mu_c.cpu(),
                                     f0_c.cpu(), **kw).to("cuda")
            refs.append((a_c, b_c, mu_c, f0_c, kw, dead, ref, ref_cpu))
    spread = max(float((r[7] - r[6]).abs().max()) for r in refs)
    spread_rel = max(float((r[7] - r[6]).abs().max())
                     / max(1.0, float(r[6].abs().max())) for r in refs)
    main_err = {}
    for layout in ("blocks", "lanes"):
        e_max, e_cpu, e_dead, ref_max, worst = 0.0, 0.0, 0.0, 0.0, 0.0
        for a_c, b_c, mu_c, f0_c, kw, dead, ref, ref_cpu in refs:
            out = ops.apgd(a_c, b_c, mu_c, f0_c, layout=layout, **kw)
            d, d_cpu = (out - ref).abs(), (out - ref_cpu).abs()
            scale = max(1.0, float(ref.abs().max()))
            e_max, ref_max = max(e_max, float(d.max())), max(ref_max, scale)
            e_cpu = max(e_cpu, float(d_cpu.max()))
            e_dead = max(e_dead, float(torch.where(dead, d, 0.0).max()))
            worst = max(worst, float(d.max()) / scale,
                        float(d_cpu.max()) / scale)
        main_err[dispatch_of[layout]] = (e_max, ref_max)
        print(f"[kernel] dispatch layout={layout} on {len(systems)} dual "
              f"systems of 3 main-path steps ({systems[0][0].dtype}, "
              f"{100 * inactive:.1f}% inactive rows), at their own "
              f"iterations and at 60: max_abs_err {e_max:.3e} against the "
              f"plain version on the card, {e_cpu:.3e} against it on the "
              f"CPU (|ref| max {ref_max:.3f}); the two plain versions differ "
              f"by {spread:.3e} ({spread_rel:.3e} of max(1, max|f|)); "
              f"inactive rows {e_dead:.3e} (atol {ATOL}); max error / "
              f"max(1, max|f|) {worst:.3e} (bound {ATOL})")
        if not (worst <= ATOL and e_dead <= ATOL):
            raise AssertionError(f"dispatch {layout} on the main path's "
                                 f"systems: {worst}, inactive rows {e_dead}")
    iters = 15  # stage 1 of the main path; stages 2-4 run 8
    step_iters = (15, 8, 8, 8)
    bound_s, bound_by = _bound(B_MAIN, iters)
    times = {}
    for name, (fn, to_layout, _) in entry.items():
        args = [to_layout(x) for x in (a, b, mu, f0)]
        kw = dict(nc=NC, nl=NL)
        # ms: CUDA events around 200 launches made from Python (the
        # wrapper's host time when that is the longer);
        # device ms: the same launches replayed from a CUDA graph, also at
        # 0 and 60 iterations (the fixed cost and the cost per iteration)
        ms = timing.eager_ms(lambda: fn(*args, iterations=iters, **kw), 200)
        dev = {it: timing.graph_ms(lambda: fn(*args, iterations=it, **kw),
                                   calls=50, replays=4)
               for it in (0, iters, 60)}
        plain_ms = timing.eager_ms(
            lambda: ops._apgd_grouped(a, b, mu, f0, iterations=iters, **kw),
            20)
        times[name] = (ms, dev, plain_ms)
        print(f"[kernel] {name} B={B_MAIN} ne={NE} bf16 iters={iters}: "
              f"{ms:.4f} ms (CUDA events over 200 launches from Python), "
              f"device {dev[iters]:.4f} ms (the same from a CUDA graph; "
              f"{dev[0]:.4f} ms at 0 iterations, {dev[60]:.4f} at 60: "
              f"{1e3 * (dev[60] - dev[0]) / 60:.3f} us per iteration), plain "
              f"{plain_ms:.4f} ms, bound {bound_s * 1e3:.4f} ms "
              f"({bound_by}), library call: none")
    step_bound = sum(_bound(B_MAIN, it)[0] for it in step_iters)
    step_ms = {}
    for layout in ("blocks", "lanes"):
        kw = dict(nc=NC, nl=NL)
        def step(layout=layout):
            return [ops.apgd(a, b, mu, f0, iterations=it, layout=layout, **kw)
                    for it in step_iters]
        step_ms[layout] = (timing.eager_ms(step, 100),
                           timing.graph_ms(step, calls=10))
        plain_ms = timing.eager_ms(lambda: [
            ops._apgd_scan(a, b, mu, f0, iterations=it, **kw)
            for it in step_iters], 5)
        print(f"[kernel] one env step's 4 solves (15+8+8+8 iterations) "
              f"through apgd(layout={layout}), B={B_MAIN} bf16: "
              f"{step_ms[layout][0]:.4f} ms from Python, device "
              f"{step_ms[layout][1]:.4f} ms (CUDA graph), plain "
              f"{plain_ms:.4f} ms, bound {step_bound * 1e3:.4f} ms (bytes, "
              f"4 solves)")

    # the wide kernel (ne > 32) against the plain version, its time, and
    # the larger-caps paths that run it (counts set to 0 before each)
    wide = _wide_kernel(torch, ops, timing)
    wide_launches = _larger_caps(torch, ops)

    # 4. main path, before any profiler session: after the profiler has
    # traced the card, later kernel launches of the process can cost more
    # host time (the rerun after the [profile] phase shows whether they do)
    def evaluate(n_envs, layout, label=""):
        ops.apgd_solve.launches = 0
        ops.apgd_solve_lanes.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = train_trpo.main([
            "--task", "evaluate", "--load-model-path", CKPT,
            "--eval-episodes", str(n_envs), "--eval-horizon", str(HORIZON),
            "--motion", "walk", "--apgd-layout", layout,
            "--device", "cuda", "--seed", str(SEED)])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = {k: fn.launches for k, fn in (("blocks", ops.apgd_solve),
                                          ("lanes", ops.apgd_solve_lanes))}
        want = {k: (4 * HORIZON if k == layout else 0) for k in n}
        if n != want:
            raise AssertionError(f"APGD launches {n}, expected {want}")
        st = res.rollout.state
        finite = all(bool(torch.isfinite(x).all())
                     for x in (st.qpos, st.qvel, st.obs))
        if not (finite and res.avg_len > 0):
            raise AssertionError(f"main path: finite={finite} "
                                 f"avg_len={res.avg_len}")
        print(f"[main] evaluate {n_envs} envs x {HORIZON} steps, "
              f"layout={layout}{label}: avg_len {res.avg_len:.2f} avg_ret "
              f"{res.avg_ret:.2f}, {dt:.2f} s, "
              f"{n_envs * HORIZON / dt:.1f} env-steps/s, launches {n}")
        return n[layout]

    launches = {"apgd_solve": 0, "apgd_solve_lanes": 0}
    for n_envs in (B_MAIN, 768):
        for layout in ("blocks", "lanes"):
            launches[dispatch_of[layout]] += evaluate(n_envs, layout)

    # training: TRPO.iteration at 768 and 4096 envs, one segment update on
    # the card against the CPU, and the training CLI; still before any
    # profiler session
    train = {n: _train(torch, ops, n) for n in (768, B_MAIN)}
    launches["apgd_solve"] += sum(r["launches"]["apgd_solve"]
                                  for r in train.values())
    seg_diff = _segment_card_vs_cpu(torch)
    _train_cli()

    # the imitation recipe: evaluation of walk_r2, then training; still
    # before any profiler session
    imit = {"evaluate": _imitation_eval(torch, ops, train_trpo)}
    imit["train"] = _train(torch, ops, B_MAIN, timed_iters=1, recipe=True)
    launches["apgd_solve"] += (imit["evaluate"]["launches"]["apgd_solve"]
                               + imit["train"]["launches"]["apgd_solve"])
    _train_cli(64, recipe=True)

    # one env step's four solves through the dispatch: the wrappers' counts
    # give the launches; profiler windows show what ran on the device (a
    # window may miss a kernel's record, so the most any window saw is read)
    for layout in ("blocks", "lanes"):
        counts, n_host = [], []
        for _ in range(3):
            n0 = ops.apgd_solve.launches + ops.apgd_solve_lanes.launches
            names = timing.device_kernels(lambda: [
                ops.apgd(a, b, mu, f0, iterations=it, nc=NC, nl=NL,
                         layout=layout) for it in step_iters])
            n_host.append(ops.apgd_solve.launches
                          + ops.apgd_solve_lanes.launches - n0)
            counts.append((len(names),
                           sum("apgd_kernel" in n for n in names)))
        print(f"[kernel] one env step's 4 solves through apgd(layout="
              f"{layout}): {n_host[0]} APGD launches counted by the "
              f"wrappers; device launches (all, APGD) in 3 profiler "
              f"windows: {counts}")
        if n_host != [4, 4, 4]:
            raise AssertionError(f"apgd(layout={layout!r}) counted {n_host}")
        if layout == "blocks" and not (
                all(n == k for n, k in counts) and max(counts)[0] == 4):
            raise AssertionError(f"apgd(layout='blocks') ran {counts}")

    # where an env step's time goes: a profiled window of 5 steps at 4096
    # (blocks layout, whose solve dispatch launches the APGD kernel alone),
    # then 3 steps of the imitation recipe at 4096
    _profile(torch, runner, env, policy, params, state, 5, "[profile]")
    imit_env = DPEnvV3(model=build_humanoid(device="cuda"), **RECIPE_ENV)
    imit_policy = MlpPolicy(**RECIPE_POLICY)
    imit["profile"] = _profile(
        torch, runner, imit_env, imit_policy,
        checkpoint.load_trpo_params(CKPT_R2, imit_policy, "cuda"),
        imit_env.reset_at(torch.arange(B_MAIN) % imit_env.clip_len), 3,
        "[imitation] [profile]")
    evaluate(B_MAIN, "blocks", label=", again after the profiler sessions")

    # the card's rollout against the CPU's (plain versions), small input
    idx = torch.arange(16) * 2 % 39
    out = {}
    for dev in ("cuda", "cpu"):
        env = DPEnvV3(model=build_humanoid(device=dev))
        policy = MlpPolicy(ob_dim=56, ac_dim=28)
        params = checkpoint.load_trpo_params(CKPT, policy, dev)
        out[dev] = runner.rollout(env, policy, params, env.reset_at(idx), 20)
    d_q = float((out["cuda"].state.qpos.cpu() - out["cpu"].state.qpos).abs().max())
    same_len = bool((out["cuda"].ep_len.cpu() == out["cpu"].ep_len).all())
    print(f"[main] 16 envs x 20 steps, card vs CPU: qpos max_abs_diff "
          f"{d_q:.3e} (atol {ROLLOUT_ATOL}), ep_len equal {same_len}")
    if not (d_q <= ROLLOUT_ATOL and same_len):
        raise AssertionError("the card's rollout disagrees with the CPU's")
    imit["card_vs_cpu"] = _imitation_card_vs_cpu(torch)

    # 5. report
    kernels = []
    for name, line in (("apgd_solve", 283), ("apgd_solve_lanes", 149)):
        ms, dev, plain_ms = times[name]
        a_main = a if name == "apgd_solve" else entry[name][1](a)
        plan = ops.launch_plan(a_main, NC, lanes=name != "apgd_solve")
        inst = ptxas["bf16/slots8"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "deepmimic_mujoco_torch/ops/csrc/apgd.cu",
            "replaces": f"deepmimic_mujoco_tpu/ops/apgd.py:{line}",
            "launches": launches[name], "max_abs_err": err[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_s * 1e3,
            "bound_by": bound_by, "library_ms": None,
            "registers": inst.get("registers"),
            "spill_bytes": inst.get("spill_bytes"),
            "smem_bytes": plan["smem"] + inst.get("static_smem", 0),
            "device_ms": dev[iters], "device_ms_0_iterations": dev[0],
            "device_ms_60_iterations": dev[60],
            "main_path_max_abs_err": main_err[name][0],
            "main_path_max_abs_f": main_err[name][1],
            "step_ms": step_ms[layout_of[name]][0],
            "step_device_ms": step_ms[layout_of[name]][1],
            "step_bound_ms": step_bound * 1e3,
            "ptxas": ptxas})
    w64, w139 = wide[3 * WIDE[0][0] + WIDE[0][1]], wide[3 * WIDE[1][0]
                                                        + WIDE[1][1]]
    kernels.append({
        "name": "apgd_solve_wide", "route": "cuda",
        "source": "deepmimic_mujoco_torch/ops/csrc/apgd_wide.cu",
        # no Pallas kernel computes ne > 32: it replaces make_apgd's XLA
        # route, _apgd_scan
        "replaces": "deepmimic_mujoco_tpu/ops/apgd.py:181",
        "launches": wide_launches,
        "max_abs_err": max(w64["max_abs_err"], w139["max_abs_err"]),
        **{k: w64["bfloat16"][k] for k in ("ms", "plain_ms", "bound_ms",
                                           "bound_by")},
        "library_ms": None, "shape": "B 4096, ne 64 (16/16 caps), bf16 A, "
                                     "15 iterations",
        "device_ms": w64["bfloat16"]["device_ms"],
        "registers": ptxas["wide/bf16"].get("registers"),
        "spill_bytes": ptxas["wide/bf16"].get("spill_bytes"),
        "smem_bytes": w64["bfloat16"]["smem_bytes"],
        "ne64": w64, "ne139": w139})
    kernels[0]["train"] = {str(n): r for n, r in train.items()}
    kernels[0]["train_segment_card_vs_cpu"] = seg_diff
    kernels[0]["imitation"] = imit
    print(f"[done] {time.perf_counter() - t_start:.1f} s after the imports")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
