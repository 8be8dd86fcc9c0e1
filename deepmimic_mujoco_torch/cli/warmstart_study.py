#!/usr/bin/env python3
"""Accuracy study of warm-started constraint solves (port of
``tools/warmstart_study.py``): the P-controller mocap-tracking scenario
(:func:`rollout`, the contact-rich analogue of the reference's
``env_torque_test.py``) under the solver configurations of
:func:`configs`, each held against the near-converged ``cold300`` by the
RMS of qpos over the first 20 and over all control steps.  Those figures
set ``build_humanoid()``'s defaults (warm-started stage 1, bf16 A,
stage-frozen kinematics).  Without ``--device cpu`` it runs on the CUDA
card, where ``cold300`` puts f32 A at 300 iterations through the kernel.

    python -m deepmimic_mujoco_torch.cli.warmstart_study [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from deepmimic_mujoco_torch.envs.dp_env_v3 import DPEnvV3
from deepmimic_mujoco_torch.physics.humanoid import build_humanoid

TRUTH = "cold300"


def rollout(env: DPEnvV3, n_steps: int = 40, gain: float = 0.8) -> np.ndarray:
    """P-controller tracking in torque mode from clip frame 0, a batch of
    one env: ``ac = gain·(clip_qpos[(t+1) % T][7:] − qpos[7:])``.  Returns
    the (n_steps, nq) qpos track after each step."""
    s = env.reset_at([0])
    qs = []
    for t in range(n_steps):
        ref = env.clip_qpos[(t + 1) % env.clip_len, 7:]
        s = env.step(s, gain * (ref - s.qpos[:, 7:]))
        qs.append(s.qpos[0])
    return torch.stack(qs).cpu().numpy()


def rms(q: np.ndarray, truth: np.ndarray, n: int | None = None) -> float:
    """qpos RMS divergence over the first ``n`` steps (all by default)."""
    return float(np.sqrt(np.mean((q[:n] - truth[:n]) ** 2)))


def rms_table(trajs: dict, truth: str, short: int = 20) -> dict:
    """{name: (RMS over the first ``short`` steps, over all)} of every
    track but ``truth``'s, against it."""
    ref = trajs[truth]
    return {name: (rms(q, ref, short), rms(q, ref))
            for name, q in trajs.items() if name != truth}


def configs(device=None) -> dict:
    """The study's models, swept from the exact-cold configuration
    (``build_humanoid(warm_iterations=0, solver_dtype="f32")``), which
    keeps ``build_humanoid``'s stage-frozen kinematics with 8 stage
    iterations: so ``stage_kin`` is ``warm25+bf16`` again, as in JAX."""
    base = build_humanoid(warm_iterations=0, solver_dtype="f32",
                          device=device)
    rep = dataclasses.replace
    kin = dict(warm_iterations=25, solver_dtype="bf16", stage_reuse="kin")
    return {
        "cold300": rep(base, iterations=300),
        "cold50": base,
        "warm25": rep(base, warm_iterations=25),
        "warm15": rep(base, warm_iterations=15),
        "warm10": rep(base, warm_iterations=10),
        "bf16": rep(base, solver_dtype="bf16"),
        "warm25+bf16": rep(base, warm_iterations=25, solver_dtype="bf16"),
        # stage-frozen kinematics: FK, M⁻¹, contacts and A once per substep,
        # stages 2-4 warm-solve the same dual at stage_iterations
        "stage_kin": rep(base, **kin),
        "stage_kin8": rep(base, **kin, stage_iterations=8),
        "stage_kin12": rep(base, **kin, stage_iterations=12),
        # frozen stages with a shorter stage-1 budget
        "stage_kin12w15": rep(base, **dict(kin, warm_iterations=15),
                              stage_iterations=12),
    }


def print_table(table: dict, truth: str, short: int, n: int,
                prefix: str = "") -> None:
    print(f"\n{prefix}{'config':>10}  "
          f"{f'qpos RMS vs {truth} ({short} steps)':>32}  "
          f"{f'({n} steps)':>12}")
    for name, (d_short, d_all) in table.items():
        print(f"{prefix}{name:>10}  {d_short:>32.6f}  {d_all:>12.6f}")


def main(argv=None) -> dict:
    """Returns {"rms": {config: (RMS over 20 steps, over all)} against
    cold300 (when it ran), "qpos": {config: (steps, nq) track}}."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--configs", default="",
                   help="comma-separated subset of the configs (default all)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; pass cpu for the CPU)")
    args = p.parse_args(argv)

    models = configs(args.device)
    names = args.configs.split(",") if args.configs else list(models)
    unknown = sorted(set(names) - set(models))
    if unknown:
        raise ValueError(f"unknown configs {unknown}; known: {list(models)}")
    trajs = {}
    for name in names:
        env = DPEnvV3(clip="walk", model=models[name], n_substeps=1)
        trajs[name] = rollout(env, args.steps)
        print(f"{name}: done", flush=True)
    table = {}
    if TRUTH in trajs:
        short = min(20, args.steps)
        table = rms_table(trajs, TRUTH, short)
        print_table(table, TRUTH, short, args.steps)
    return {"rms": table, "qpos": trajs}


if __name__ == "__main__":
    main()
