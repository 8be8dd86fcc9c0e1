#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``deepmimic_mujoco_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing its lines before the last:

1. device — the card's name and power limit, as ``nvidia-smi`` prints them;
2. build  — compiles ``ops/csrc/apgd.cu`` with nvcc; prints the seconds and
   the kernel's registers and spills (``-Xptxas -v``);
3. kernel — both APGD entry points (``apgd_solve``: (B, ne, ne);
   ``apgd_solve_lanes``: (ne, ne, B)) against the plain PyTorch version on
   the same inputs, at the main path's B = 4096, ne = 32, with f32 and bf16
   A at 15, 8 and 60 iterations; then the timing of each at the main path's
   shape (bf16 A, 15 iterations) with CUDA events;
4. main path — ``cli.train_trpo --task evaluate`` of the bundled walk
   checkpoint at 4096 and 768 envs × 200 steps, once per kernel layout,
   with the launch counts set to 0 just before each run and read just after;
   then a ``torch.profiler`` window of 5 env steps at 4096 envs (step time,
   device busy share, kernel launches per step, top kernels); then a
   16-env, 20-step rollout on the card held against the same rollout on the
   CPU (plain versions);
5. one JSON line with every kernel's numbers, then the result line.

Nothing is caught: a phase that fails ends the run with a non-zero code.
Without CUDA the run stops before any phase.
"""

from __future__ import annotations

import json
import os
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


def _problem(torch, B: int, a_dtype, gen):
    """Well-conditioned dual systems in the grouped layout, batch-major."""
    dev = "cuda"
    m = torch.randn((B, NE, NE), generator=gen, device=dev)
    a = (m @ m.transpose(1, 2)) / NE + 0.5 * torch.eye(NE, device=dev)
    b = torch.randn((B, NE), generator=gen, device=dev)
    mu = 0.5 + torch.rand((B, NC), generator=gen, device=dev)
    f0 = 0.1 * torch.randn((B, NE), generator=gen, device=dev)
    return a.to(a_dtype).contiguous(), b, mu, f0


def _time_ms(torch, fn, reps: int) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


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
    from deepmimic_mujoco_torch.physics.humanoid import build_humanoid

    t_start = time.perf_counter()
    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])  # name, power limit

    # 2. build
    built = ops.load_kernel()
    ptxas = [ln.strip() for ln in built.log.splitlines()
             if "registers" in ln or "spill" in ln]
    how = f"{built.seconds:.1f} s" if built.seconds else "reused"
    print(f"[build] {os.path.basename(built.path)}: nvcc {how}; "
          + " | ".join(ptxas))

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
    for a_dtype in (torch.float32, torch.bfloat16):
        a, b, mu, f0 = _problem(torch, B_MAIN, a_dtype, gen)
        for iters in (15, 8, 60):
            ref = ops._apgd_grouped(a, b, mu, f0, iterations=iters, nc=NC,
                                    nl=NL)
            for name, (fn, to_layout, back) in entry.items():
                out = back(fn(to_layout(a), to_layout(b), to_layout(mu),
                              to_layout(f0), iterations=iters, nc=NC, nl=NL))
                torch.cuda.synchronize()
                e = float((out - ref).abs().max())
                err[name] = max(err[name], e)
                print(f"[kernel] {name} A={str(a_dtype)[6:]} iters={iters}: "
                      f"max_abs_err {e:.3e} (|ref| max "
                      f"{float(ref.abs().max()):.3f}, atol {ATOL})")
                if not e <= ATOL:
                    raise AssertionError(f"{name} disagrees with the plain "
                                         f"version: {e} > {ATOL}")
    # the solver's dispatch (interleaved layout) against the plain oracle
    a, b, mu, f0 = _problem(torch, B_MAIN, torch.bfloat16, gen)
    ref = ops._apgd_scan(a, b, mu, f0, iterations=15, nc=NC, nl=NL)
    for layout in ("blocks", "lanes"):
        out = ops.apgd(a, b, mu, f0, iterations=15, nc=NC, nl=NL,
                       layout=layout)
        e = float((out - ref).abs().max())
        print(f"[kernel] dispatch layout={layout}: max_abs_err {e:.3e}")
        if not e <= ATOL:
            raise AssertionError(f"dispatch {layout}: {e} > {ATOL}")

    iters = 15  # stage 1 of the main path; stages 2-4 run 8
    nbytes = B_MAIN * NE * NE * 2 + 4 * B_MAIN * (3 * NE + NC)
    flops = 2 * B_MAIN * NE * NE * iters
    bound_s = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)
    bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOPS_PER_S
                else "operations")
    timing = {}
    for name, (fn, to_layout, _) in entry.items():
        args = [to_layout(x) for x in (a, b, mu, f0)]
        kw = dict(iterations=iters, nc=NC, nl=NL)
        ms = _time_ms(torch, lambda: fn(*args, **kw), 200)
        plain_ms = _time_ms(torch, lambda: ops._apgd_grouped(a, b, mu, f0, **kw),
                            20)
        timing[name] = (ms, plain_ms)
        print(f"[kernel] {name} B={B_MAIN} ne={NE} bf16 iters={iters}: "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound_s * 1e3:.4f} ms ({bound_by}), library call: none")

    # 4. main path
    launches = {"apgd_solve": 0, "apgd_solve_lanes": 0}
    counter = {"blocks": ops.apgd_solve, "lanes": ops.apgd_solve_lanes}
    for n_envs in (B_MAIN, 768):
        for layout in ("blocks", "lanes"):
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
            launches[counter[layout].__name__] += n[layout]
            st = res.rollout.state
            finite = all(bool(torch.isfinite(x).all())
                         for x in (st.qpos, st.qvel, st.obs))
            if not (finite and res.avg_len > 0):
                raise AssertionError(f"main path: finite={finite} "
                                     f"avg_len={res.avg_len}")
            print(f"[main] evaluate {n_envs} envs x {HORIZON} steps, "
                  f"layout={layout}: avg_len {res.avg_len:.2f} avg_ret "
                  f"{res.avg_ret:.2f}, {dt:.2f} s, "
                  f"{n_envs * HORIZON / dt:.1f} env-steps/s, launches {n}")

    # where an env step's time goes: a profiled window of 5 steps at 4096
    env = DPEnvV3(model=build_humanoid(device="cuda"))
    policy = MlpPolicy(ob_dim=56, ac_dim=28)
    params = checkpoint.load_trpo_params(CKPT, policy, "cuda")
    state = env.reset_at(torch.arange(B_MAIN) % env.clip_len)
    runner.rollout(env, policy, params, state, 2)  # warm-up
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        runner.rollout(env, policy, params, state, 5)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    rows = [(getattr(e, "self_device_time_total", 0.0), e.count, e.key)
            for e in prof.key_averages()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    busy_us = sum(r[0] for r in rows)
    apgd_us = sum(r[0] for r in rows if "apgd_kernel" in r[2])
    launches_per_step = sum(r[1] for r in rows) / 5
    top = sorted(rows, reverse=True)[:5]
    if busy_us > 0:
        busy = (f"device busy {busy_us / 5e3:.2f} ms per step "
                f"({100 * busy_us / window_us:.1f}%), {launches_per_step:.0f} "
                f"kernel launches per step, APGD kernel {apgd_us / 5e3:.3f} ms "
                f"per step ({100 * apgd_us / busy_us:.2f}% of the device "
                "time); top: " + "; ".join(
                    f"{k[:48]} {t / 5e3:.3f} ms x{c // 5}" for t, c, k in top))
    else:
        busy = "device time not measured (the profiler showed no kernels)"
    print(f"[profile] 5 env steps at {B_MAIN} envs: {window_us / 5e3:.2f} ms "
          f"per step, {busy}")

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

    # 5. report
    kernels = []
    for name, line in (("apgd_solve", 283), ("apgd_solve_lanes", 149)):
        ms, plain_ms = timing[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "deepmimic_mujoco_torch/ops/csrc/apgd.cu",
            "replaces": f"deepmimic_mujoco_tpu/ops/apgd.py:{line}",
            "launches": launches[name], "max_abs_err": err[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_s * 1e3,
            "bound_by": bound_by, "library_ms": None})
    print(f"[done] {time.perf_counter() - t_start:.1f} s after the imports")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
