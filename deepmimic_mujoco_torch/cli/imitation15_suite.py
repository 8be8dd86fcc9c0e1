#!/usr/bin/env python3
"""The ``DeepMimicImitation15`` suite at a short per-clip budget (port of
``tools/imitation15_suite.py``): train one imitation policy per bundled
skill, each in a subprocess of ``cli.train_trpo``, then evaluate it
deterministically with ``cli.eval_imitation`` and write a 15-row coverage
table: reward per step, EpLen and pose error per clip, into ``--out`` (+ a
markdown table on stdout).

    python -m deepmimic_mujoco_torch.cli.imitation15_suite --iters 150 \\
        --episodes 16 --out benchdata/imitation15_r4.json

The subprocesses run on the CUDA card unless ``--device cpu`` asks for the
CPU.  ``--out``, ``--log-root`` and ``--ckpt-root`` default to the JAX
tool's paths in the repository: pass others to keep its records.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

CLIPS = [
    "backflip", "cartwheel", "crawl", "dance_a", "dance_b",
    "getup_facedown", "getup_faceup", "jump", "kick", "punch",
    "roll", "run", "spin", "spinkick", "walk",
]

TRAIN_ARGS = [
    "--reward-mode", "imitation_dm", "--control-mode", "pd_residual",
    "--reset-mode", "rsi", "--n-substeps", "2", "--max-episode-steps", "300",
    "--gamma", "0.95", "--lam", "0.95", "--fixed-logstd", "-3.0",
    "--hidden-sizes", "1024,512", "--activation", "relu",
    "--num-envs", "64", "--joint-limits", "mocap",
]


def parse_eval(out: str) -> dict:
    """The figures of ``cli.eval_imitation``'s printout, under the JAX
    tool's row keys."""
    row = {}
    m = re.search(r"EpLen\s+mean/median:\s*([\d.]+)\s*/\s*([\d.]+)"
                  r"\s*\(cap\s*(\d+)\)", out)
    if m:
        row["eplen_mean"] = float(m.group(1))
        row["eplen_median"] = float(m.group(2))
        row["horizon_cap"] = int(m.group(3))
    m = re.search(r"EpRew\s+mean\s*:\s*([\d.]+)\s*\(([\d.]+)/step\)", out)
    if m:
        row["eprew_mean"] = float(m.group(1))
        row["rew_per_step"] = float(m.group(2))
    m = re.search(r"pose err \(weighted\): ([\d.]+) rad", out)
    if m:
        row["pose_err_rad"] = float(m.group(1))
    return row


def run_clip(motion: str, iters: int, episodes: int, train_cap: int,
             eval_cap: int, log_root: str, ckpt_root: str,
             device: str | None = None) -> dict:
    """Train ``motion`` for ``iters`` iterations and evaluate its
    checkpoint over ``episodes`` episodes; the row, with ``error`` when a
    subprocess failed."""
    on = ["--device", device] if device else []
    row = {"motion": motion, "iters": iters}
    t0 = time.time()
    cmd = [sys.executable, "-u", "-m",
           "deepmimic_mujoco_torch.cli.train_trpo", "--motion", motion,
           *TRAIN_ARGS, "--num-iters", str(iters),
           "--save-per-iter", str(iters),
           "--log-dir", log_root, "--checkpoint-dir", ckpt_root, *on]
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                       timeout=train_cap)
    row["train_s"] = round(time.time() - t0, 1)
    if r.returncode != 0:
        row["error"] = f"train rc={r.returncode}: {r.stderr[-400:]}"
        return row

    ckpt = os.path.join(ckpt_root, "DPEnvV3", f"trpo-{motion}-0",
                        "trpo_state.npz")
    if not os.path.exists(ckpt):
        row["error"] = f"no checkpoint at {ckpt}"
        return row
    cmd = [sys.executable, "-u", "-m",
           "deepmimic_mujoco_torch.cli.eval_imitation",
           "--ckpt", ckpt, "--motion", motion,
           "--episodes", str(episodes), "--joint-limits", "mocap",
           "--hidden-sizes", "1024,512", "--activation", "relu", *on]
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                       timeout=eval_cap)
    if r.returncode != 0:
        row["error"] = f"eval rc={r.returncode}: {r.stderr[-400:]}"
        return row
    row.update(parse_eval(r.stdout))
    return row


def table(rows: list) -> str:
    """The JAX tool's markdown table of the rows."""
    lines = ["| motion | rew/step | EpLen mean | pose err (rad) | note |",
             "|---|---|---|---|---|"]
    for r in rows:
        if "error" in r:
            lines.append(f"| {r['motion']} | — | — | — | {r['error'][:40]} |")
        else:
            lines.append(f"| {r['motion']} | {r.get('rew_per_step', 0):.3f} "
                         f"| {r.get('eplen_mean', 0):.0f} "
                         f"| {r.get('pose_err_rad', 0):.3f} | |")
    return "\n".join(lines)


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--iters", type=int, default=150)
    p.add_argument("--episodes", type=int, default=16)
    p.add_argument("--train-cap", type=int, default=2000)
    p.add_argument("--eval-cap", type=int, default=900)
    p.add_argument("--out", default="benchdata/imitation15_r4.json")
    p.add_argument("--clips", default="")
    p.add_argument("--log-root", default="train_logs_imit15")
    p.add_argument("--ckpt-root", default="train_ckpt_imit15")
    p.add_argument("--device", default=None,
                   help="the subprocesses' torch device (default cuda; "
                        "pass cpu for the CPU)")
    args = p.parse_args(argv)

    clips = args.clips.split(",") if args.clips else CLIPS
    rows = []
    out_path = os.path.join(REPO, args.out)
    for motion in clips:
        print(f"=== {motion} ({time.strftime('%H:%M:%S')})", flush=True)
        try:
            row = run_clip(motion, args.iters, args.episodes,
                           args.train_cap, args.eval_cap,
                           os.path.join(REPO, args.log_root),
                           os.path.join(REPO, args.ckpt_root), args.device)
        except subprocess.TimeoutExpired as e:
            row = {"motion": motion, "error": f"timeout: {e.cmd[:3]}..."}
        rows.append(row)
        print(json.dumps(row), flush=True)
        with open(out_path, "w") as f:  # checkpoint after every clip
            json.dump({"iters": args.iters, "episodes": args.episodes,
                       "rows": rows}, f, indent=1)

    print("\n" + table(rows))
    print(f"\nwrote {out_path}")
    return rows


if __name__ == "__main__":
    main()
