#!/usr/bin/env python3
"""Accuracy study of the constraint top-k caps (port of
``tools/contactcap_study.py``): ``build_humanoid(contact_cap=,
limit_cap=)`` bounds the dual at ne = 3·contact_cap + limit_cap rows, and A
shrinks with its square.  The P-controller tracking scenario of
``cli/warmstart_study.py:rollout`` runs under each cap of :data:`CAPS` on
a normal gait (walk) and on harder landings (spinkick), held against the
uncapped solve (``full``, ne 139) by the qpos RMS over the first 20 and
over all steps.  Without ``--device cpu`` it runs on the CUDA card: ne 139,
64, 48 and 40 go through the wide kernel, ``cap8`` (ne 32, the default)
through ``apgd.cu``.

    python -m deepmimic_mujoco_torch.cli.contactcap_study [--device cpu]
"""

from __future__ import annotations

import argparse

from deepmimic_mujoco_torch.cli.warmstart_study import (
    print_table,
    rms_table,
    rollout,
)
from deepmimic_mujoco_torch.envs.dp_env_v3 import DPEnvV3
from deepmimic_mujoco_torch.physics.humanoid import build_humanoid

# (contact_cap, limit_cap); the production solver configuration otherwise
CAPS = {
    "full": (1 << 30, 1 << 30),   # uncapped: ne = 3·37 + 28 = 139
    "cap16": (16, 16),            # ne = 64
    "cap12": (12, 12),            # ne = 48
    "cap10": (10, 10),            # ne = 40
    "cap8": (8, 8),               # ne = 32, build_humanoid()'s default
}
TRUTH = "full"
CLIPS = ("walk", "spinkick")


def main(argv=None) -> dict:
    """Returns {"rms": {(clip, cap): (RMS over 20 steps, over all)} against
    ``full`` (when it ran), "qpos": {(clip, cap): (steps, nq) track}}."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--caps", default=",".join(CAPS),
                   help="comma-separated subset of " + ",".join(CAPS))
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; pass cpu for the CPU)")
    args = p.parse_args(argv)

    caps = args.caps.split(",")
    unknown = sorted(set(caps) - set(CAPS))
    if unknown:
        raise ValueError(f"unknown caps {unknown}; known: {list(CAPS)}")
    short = min(20, args.steps)
    out = {"rms": {}, "qpos": {}}
    for clip in CLIPS:
        trajs = {}
        for name in caps:
            cc, lc = CAPS[name]
            model = build_humanoid(contact_cap=cc, limit_cap=lc,
                                   device=args.device)
            env = DPEnvV3(clip=clip, model=model, n_substeps=1)
            trajs[name] = rollout(env, args.steps)
            out["qpos"][clip, name] = trajs[name]
            print(f"{clip}/{name}: done", flush=True)
        if TRUTH in trajs:
            table = rms_table(trajs, TRUTH, short)
            print_table(table, TRUTH, short, args.steps, prefix=f"[{clip}] ")
            out["rms"].update({(clip, k): v for k, v in table.items()})
    return out


if __name__ == "__main__":
    main()
