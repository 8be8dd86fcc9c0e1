#!/usr/bin/env python3
"""Capture a ``torch.profiler`` trace of the TRPO training iteration (port
of the JAX package's ``tools/profile_trace.py``): walk, the default
policy, ``--num-envs`` × ``--horizon``, g_step 1.

    python -m deepmimic_mujoco_torch.cli.profile_trace --num-envs 768 \\
        --out /tmp/dmtpu_trace
    python -m deepmimic_mujoco_torch.cli.trace_summary /tmp/dmtpu_trace

One untraced iteration runs first: it builds the kernels and warms the
process up, where the JAX tool compiles.  Then ``--iters`` iterations run
inside ``utils/profiling.device_trace``, which writes the chrome trace
under ``--out``; the tool prints env-steps/s over the traced window (the
profiler's own cost included) and the APGD launches the kernels' wrappers
counted in it, and returns them with the window's profile (whose
``key_averages()`` a caller may read: parsing a whole iteration's events
takes tens of seconds, so the tool itself does not).  Runs on the CUDA card unless ``--device cpu`` (or
``--platform cpu``) asks for the CPU."""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from deepmimic_mujoco_torch.algos.trpo import TRPO, TRPOConfig
from deepmimic_mujoco_torch.envs.dp_env_v3 import DPEnvV3
from deepmimic_mujoco_torch.models.policy import MlpPolicy
from deepmimic_mujoco_torch.ops import apgd as ops
from deepmimic_mujoco_torch.utils.device import PLATFORMS, resolve_device
from deepmimic_mujoco_torch.utils.profiling import device_trace

_SOLVES = (ops.apgd_solve, ops.apgd_solve_lanes, ops.apgd_solve_wide)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--num-envs", type=int, default=768)
    p.add_argument("--horizon", type=int, default=64)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--out",
                   default=os.path.join(tempfile.gettempdir(), "dmtpu_trace"))
    p.add_argument("--platform", default=None, choices=sorted(PLATFORMS),
                   help="the JAX tool's flag: cpu, or gpu/cuda for the card")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; pass cpu for the CPU); "
                        "takes precedence over --platform")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    device = resolve_device(args.device or PLATFORMS.get(args.platform))

    env = DPEnvV3(clip="walk", device=device)
    policy = MlpPolicy(ob_dim=env.observation_size, ac_dim=env.action_size)
    cfg = TRPOConfig(horizon=args.horizon, num_envs=args.num_envs, g_step=1)
    learner = TRPO(env, policy, cfg)
    state = learner.init(
        torch.Generator(device=device).manual_seed(args.seed))

    # build and warm up outside the trace
    state, _ = learner.iteration(state)
    if device.type == "cuda":
        torch.cuda.synchronize()

    n0 = sum(fn.launches for fn in _SOLVES)
    with device_trace(args.out) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            state, _ = learner.iteration(state)
        if device.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = sum(fn.launches for fn in _SOLVES) - n0
    steps = args.iters * cfg.horizon * cfg.num_envs
    print(f"traced {args.iters} iterations: {steps / dt:.0f} env-steps/s "
          f"({launches} APGD kernel launches) → {args.out}")
    return {"env_steps_per_s": steps / dt, "seconds": dt,
            "apgd_launches": launches, "profile": prof, "out": args.out}


if __name__ == "__main__":
    main()
