#!/usr/bin/env python3
"""One independent imitation policy PER skill, all trained at once as lanes
of one batch (port of the JAX package's ``tools/imitation15_vmapped.py``).

Each skill's learner is a lane of ``algos/lanes.py:LaneTRPO`` over one
clip-indexed ``DPEnvV3Multi`` (``mocap_hinge_range`` model, PD-residual
control, 2 substeps, 300-step episodes, the ``imitation_dm`` reward, the
full obs, fall-contact termination); ``reset_mode="rsi_pinned"`` keeps
each lane on its own clip, so one env step steps every lane:

    lanes(15) x envs/lane(64) = 960 envs per step.

A NaN in one lane stays in that lane; the loop reports it and the other
lanes keep training.  After training (or with ``--eval-only``, of
``--resume``) every lane runs ``--eval-episodes`` deterministic episodes
of ``--eval-horizon`` steps from random frames of its clip (or from
``--frames``), and the tool prints and writes per skill the episode
length, the reward per step and the weighted pose error.

    python -m deepmimic_mujoco_torch.cli.imitation15_vmapped \\
        --iters 2200 --envs 64 --out benchdata/imitation15_r5.json

Its defaults are the JAX tool's: without ``--out``, ``--ckpt-root`` and
``--log-root`` it writes ``benchdata/imitation15_r5.json`` (under the
repository), ``train_ckpt_imit15_r5/`` and appends to
``train_logs_imit15_r5/progress.jsonl`` (under the working directory).
Without ``--device cpu`` it runs on the CUDA card."""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from deepmimic_mujoco_torch.algos import lanes
from deepmimic_mujoco_torch.algos.trpo import Draws, TRPOConfig
from deepmimic_mujoco_torch.envs.multi_clip import DPEnvV3Multi
from deepmimic_mujoco_torch.io_utils import checkpoint
from deepmimic_mujoco_torch.mocap.registry import SKILLS
from deepmimic_mujoco_torch.models.policy import MlpPolicy
from deepmimic_mujoco_torch.physics.humanoid import mocap_hinge_range
from deepmimic_mujoco_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CLIPS15 = list(SKILLS)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--clips", default=",".join(CLIPS15))
    p.add_argument("--envs", type=int, default=64, help="envs per lane")
    p.add_argument("--iters", type=int, default=2200)
    p.add_argument("--horizon", type=int, default=256)
    p.add_argument("--g-step", type=int, default=3)
    p.add_argument("--save-per-iter", type=int, default=200)
    p.add_argument("--eval-episodes", type=int, default=32)
    p.add_argument("--eval-horizon", type=int, default=300)
    p.add_argument("--hidden-sizes", default="1024,512")
    p.add_argument("--fixed-logstd", type=float, default=-3.0)
    p.add_argument("--gamma", type=float, default=0.95)
    p.add_argument("--lam", type=float, default=0.95)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="benchdata/imitation15_r5.json",
                   help="the result JSON, relative to the repository")
    p.add_argument("--ckpt-root", default="train_ckpt_imit15_r5")
    p.add_argument("--log-root", default="train_logs_imit15_r5")
    p.add_argument("--resume", default=None,
                   help="path of a lane imit15_state.npz to continue")
    p.add_argument("--resume-lanes", action="store_true",
                   help="slice this run's --clips lanes out of --resume (a "
                        "checkpoint trained with other or more clips, lane "
                        "order --resume-clips): params, optimizer and obs-RMS "
                        "move; env batches start fresh at the new --envs")
    p.add_argument("--resume-clips", default=",".join(CLIPS15),
                   help="the clip list --resume was trained with (lane "
                        "order), for --resume-lanes")
    p.add_argument("--env-clips", default=None,
                   help="clips to build the env over (default: --clips); "
                        "the parent run's list when resuming a lane subset, "
                        "so that the obs one-hot keeps its width and indices")
    p.add_argument("--eval-only", action="store_true",
                   help="skip training; evaluate --resume")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--frames", default=None,
                   help="evaluation start frames: one comma list per lane, "
                        "lanes separated by ';' (default: random frames "
                        "drawn with --seed)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; pass cpu for the CPU)")
    return p


def build(args, device):
    """(env, policy, learner, lane clip ids) of the tool's configuration."""
    clips = args.clips.split(",")
    env_clips = args.env_clips.split(",") if args.env_clips else clips
    lane_clip_ids = [env_clips.index(c) for c in clips]
    env = DPEnvV3Multi(
        clips=tuple(env_clips), model=mocap_hinge_range(device=device),
        control_mode="pd_residual", n_substeps=2, max_episode_steps=300,
        reward_mode="imitation_dm", obs_mode="full",
        termination="fall_contact")
    policy = MlpPolicy(
        ob_dim=env.observation_size, ac_dim=env.action_size,
        hidden_sizes=tuple(int(h) for h in args.hidden_sizes.split(",")),
        activation="relu", fixed_logstd=args.fixed_logstd)
    cfg = TRPOConfig(horizon=args.horizon, num_envs=args.envs,
                     g_step=args.g_step, gamma=args.gamma, lam=args.lam,
                     reset_mode="rsi_pinned")
    return env, policy, lanes.LaneTRPO(env, policy, cfg, len(clips)), \
        lane_clip_ids


def initial_state(args, learner, lane_clip_ids, device) -> lanes.LaneState:
    """Fresh lanes (lane k's generator seeded ``seed·1000 + k``), then the
    ``--resume`` checkpoint: the whole state (its params alone with
    ``--eval-only``), or with ``--resume-lanes`` this run's lanes' params
    and optimizer sliced out of it."""
    gens = [torch.Generator(device=device).manual_seed(args.seed * 1000 + k)
            for k in range(learner.lanes)]
    state = learner.init(gens, lane_clip_ids)
    if args.resume and (args.resume_lanes or args.eval_only):
        idx = None
        if args.resume_lanes:
            src = args.resume_clips.split(",")
            idx = [src.index(c) for c in args.clips.split(",")]
        params, vf_adam = checkpoint.load_lane_params(
            args.resume, learner.policy, device, lanes=idx)
        state = lanes.LaneState(**{**vars(state), "params": params,
                                   "vf_adam": vf_adam})
        if idx is not None:
            print(f"resumed lanes {list(zip(args.clips.split(','), idx))} "
                  f"from {args.resume}", flush=True)
    elif args.resume:
        state = checkpoint.load_lane_state(args.resume, learner,
                                           [Draws(g) for g in gens])
    return state


def eval_frames(args, env, lane_clip_ids, device) -> torch.Tensor:
    """(L, B) start frames of the evaluation: ``--frames``, or random
    frames of each lane's clip."""
    L, B = len(lane_clip_ids), args.eval_episodes
    if args.frames:
        rows = [[int(f) for f in lane.split(",")]
                for lane in args.frames.split(";")]
        frames = torch.tensor(rows, dtype=torch.int64, device=device)
        if frames.shape != (L, B):
            raise ValueError(f"--frames gives {tuple(frames.shape)} frames; "
                             f"expected {L} lanes x {B} episodes")
        return frames
    g = torch.Generator(device=device).manual_seed(args.seed + 11)
    cid = torch.tensor(lane_clip_ids, device=device)[:, None].expand(L, B)
    return env.rsi_frames(g, cid)


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    clips = args.clips.split(",")
    env, policy, learner, lane_clip_ids = build(args, device)
    L, E = learner.lanes, args.envs
    states = initial_state(args, learner, lane_clip_ids, device)

    os.makedirs(args.log_root, exist_ok=True)
    os.makedirs(args.ckpt_root, exist_ok=True)
    ckpt = os.path.join(args.ckpt_root, "imit15_state")
    steps_per_iter_lane = E * args.horizon * args.g_step
    nan_lanes: set[int] = set()
    t0 = time.time()
    with open(os.path.join(args.log_root, "progress.jsonl"), "a") as prog:
        if not args.eval_only:
            for it in range(args.iters):
                states, stats = learner.iteration(states)
                for b in lanes.nonfinite_lanes(stats):
                    if b not in nan_lanes:
                        print(f"!! lane {b} ({clips[b]}) went non-finite at "
                              f"iter {it}", flush=True)
                        nan_lanes.add(b)
                kl = stats.meankl.cpu().numpy()
                cnt = np.maximum(stats.ep_count.cpu().numpy(), 1)
                rew = stats.ep_ret_sum.cpu().numpy() / cnt
                lens = stats.ep_len_sum.cpu().numpy() / cnt
                row = {"iter": it, "t": round(time.time() - t0, 1),
                       "ep_rew": [round(float(x), 3) for x in rew],
                       "ep_len": [round(float(x), 1) for x in lens],
                       "meankl": [round(float(x), 5) for x in kl]}
                prog.write(json.dumps(row) + "\n")
                prog.flush()
                if it % args.log_every == 0:
                    sps = (steps_per_iter_lane * L * (it + 1)
                           / (time.time() - t0))
                    tops = ", ".join(f"{c}:{r:.0f}/{n:.0f}"
                                     for c, r, n in zip(clips, rew, lens))
                    print(f"[{it}/{args.iters}] {time.time() - t0:7.0f}s "
                          f"{sps:,.0f} steps/s  EpRew/EpLen {tops}",
                          flush=True)
                if (it + 1) % args.save_per_iter == 0:
                    checkpoint.save(ckpt, states)
            checkpoint.save(ckpt, states)

    # deterministic evaluation of every lane, in one batch
    B, H = args.eval_episodes, args.eval_horizon
    frames = eval_frames(args, env, lane_clip_ids, device)
    ev = lanes.evaluate(env, policy, states.params,
                        torch.tensor(lane_clip_ids, device=device), frames, H)
    ep_len = ev.ep_len.cpu().numpy().astype(float)
    rew_sum = ev.rew_sum.cpu().numpy().astype(np.float64)
    rows = []
    for k, c in enumerate(clips):
        el, pe = ep_len[k], float(ev.pose_err[k])
        rows.append({
            "motion": c,
            "eplen_mean": round(float(el.mean()), 1),
            "eplen_median": round(float(np.median(el)), 1),
            "horizon_cap": H,
            "eprew_mean": round(float(rew_sum[k].mean()), 2),
            "rew_per_step": round(float(rew_sum[k].mean()
                                        / max(el.mean(), 1)), 3),
            "pose_err_rad": round(pe, 3),
            "pose_err_deg": round(float(np.degrees(pe)), 1),
            "nan_lane": k in nan_lanes,
        })
    out = {
        "iters": 0 if args.eval_only else args.iters,
        "envs_per_lane": E, "horizon": args.horizon, "g_step": args.g_step,
        "steps_per_lane": (0 if args.eval_only
                           else args.iters * steps_per_iter_lane),
        "episodes": B, "joint_limits": "mocap",
        "pd_target_interp": True, "wall_s": round(time.time() - t0, 1),
        "rows": rows,
    }
    out_path = os.path.join(REPO, args.out)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)

    print("\n| motion | rew/step | EpRew | EpLen | pose err (deg) |")
    print("|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['motion']} | {r['rew_per_step']:.3f} "
              f"| {r['eprew_mean']:.1f} | {r['eplen_mean']:.0f} "
              f"| {r['pose_err_deg']:.1f} |")
    print(f"\nwrote {out_path}")
    return {"out": out, "eval": ev, "state": states}


if __name__ == "__main__":
    main()
