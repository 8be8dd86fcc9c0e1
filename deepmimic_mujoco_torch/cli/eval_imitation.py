#!/usr/bin/env python3
"""Imitation-tracking evaluation of a TRPO checkpoint (port of the JAX
package's ``tools/eval_imitation.py``): deterministic episodes of the
recipe env (``n_substeps`` 2, the episode capped at ``--horizon``), with
the mean and median episode length, the reward per step and the weighted
pose error.

    python -m deepmimic_mujoco_torch.cli.eval_imitation \\
        --ckpt train_ckpt_walk_r2/DPEnvV3/trpo-walk-0/trpo_state.npz \\
        --hidden-sizes 1024,512 --activation relu --episodes 32

Episodes start from random mocap frames drawn with ``--seed``, or from the
frames listed in ``--frames``.  ``--joint-limits mocap`` widens the hinge
ranges to the bundled clips' poses, as the checkpoint's training did.
Without ``--device cpu`` (or ``--platform cpu``) it runs on the CUDA
card."""

from __future__ import annotations

import argparse

import numpy as np
import torch

from deepmimic_mujoco_torch.envs import rewards
from deepmimic_mujoco_torch.envs.dp_env_v3 import DPEnvV3
from deepmimic_mujoco_torch.io_utils import checkpoint
from deepmimic_mujoco_torch.models.policy import MlpPolicy
from deepmimic_mujoco_torch.physics.humanoid import mocap_hinge_range
from deepmimic_mujoco_torch.utils.device import PLATFORMS, resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--motion", default="walk")
    p.add_argument("--reward-mode", default="imitation_dm")
    p.add_argument("--control-mode", default="pd_residual")
    p.add_argument("--fixed-logstd", type=float, default=-3.0)
    p.add_argument("--episodes", type=int, default=32)
    p.add_argument("--horizon", type=int, default=300)
    p.add_argument("--platform", default=None, choices=sorted(PLATFORMS))
    p.add_argument("--joint-limits", default="xml", choices=["xml", "mocap"],
                   help="must match the checkpoint's training flag")
    p.add_argument("--obs-mode", default=None, choices=["legacy", "full"])
    p.add_argument("--termination", default=None,
                   choices=["com", "fall_contact"])
    p.add_argument("--hidden-sizes", default=None,
                   help="comma list, e.g. 1024,512 (must match the ckpt)")
    p.add_argument("--activation", default="tanh", choices=["tanh", "relu"])
    p.add_argument("--frames", default=None,
                   help="comma list of start frames, one per episode")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; pass cpu for the CPU); "
                        "takes precedence over --platform")
    return p


@torch.no_grad()
def run(args) -> dict:
    """Rolls the episodes; returns the per-episode lengths and returns and
    the summary figures the tool prints."""
    device = resolve_device(args.device or PLATFORMS.get(args.platform))
    model = None
    if args.joint_limits == "mocap":
        model = mocap_hinge_range(device=device)
    env = DPEnvV3(clip=args.motion, model=model,
                  reward_mode=args.reward_mode,
                  control_mode=args.control_mode, n_substeps=2,
                  max_episode_steps=args.horizon, obs_mode=args.obs_mode,
                  termination=args.termination, device=device)
    hidden = (tuple(int(h) for h in args.hidden_sizes.split(","))
              if args.hidden_sizes else None)
    policy = MlpPolicy(ob_dim=env.observation_size, ac_dim=env.action_size,
                       fixed_logstd=args.fixed_logstd, hidden_sizes=hidden,
                       activation=args.activation)
    params = checkpoint.load_trpo_params(args.ckpt, policy, device)
    if args.frames:
        s = env.reset_at([int(f) for f in args.frames.split(",")])
    else:
        g = torch.Generator(device=device).manual_seed(args.seed)
        s = env.reset(g, args.episodes)
    B = s.qpos.shape[0]
    alive = torch.ones(B, dtype=torch.bool, device=device)
    ep_len = torch.zeros(B, dtype=torch.int64, device=device)
    rew_sum = torch.zeros(B, device=device)
    err_sum = torch.zeros((), device=device)
    for _ in range(args.horizon):
        mean, _ = policy.mean_logstd(params, s.obs)
        nxt = env.step(s, mean)
        # the JAX tool's tracking error: the post-step pose against the
        # frame at the pre-step cursor
        idx, _ = env._clip_index(s.mocap_idx, s.init_idx)
        pose_err = rewards.weighted_pose_error(nxt.qpos[:, 7:],
                                               env.clip_qpos[idx][:, 7:])
        err_sum = err_sum + torch.where(alive, pose_err, 0.0).sum()
        ep_len = ep_len + alive.long()
        rew_sum = rew_sum + torch.where(alive, nxt.reward, 0.0)
        s = nxt.where(alive, s)
        alive = alive & ~nxt.done
    lens = ep_len.cpu().numpy().astype(float)
    ret_mean = float(rew_sum.double().mean())
    return {"ep_len": ep_len.cpu(), "ep_ret": rew_sum.cpu(),
            "len_mean": float(lens.mean()),
            "len_median": float(np.median(lens)),
            "ret_mean": ret_mean,
            "reward_per_step": ret_mean / max(float(lens.mean()), 1.0),
            "pose_err": float(err_sum) / max(float(ep_len.sum()), 1.0)}


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    r = run(args)
    print(f"episodes           : {len(r['ep_len'])} (RSI starts, "
          f"deterministic policy)")
    print(f"EpLen   mean/median: {r['len_mean']:.1f} / "
          f"{r['len_median']:.0f}  (cap {args.horizon})")
    print(f"EpRew   mean       : {r['ret_mean']:.2f}  "
          f"({r['reward_per_step']:.3f}/step)")
    print(f"pose err (weighted): {r['pose_err']:.3f} rad"
          f" ≈ {np.degrees(r['pose_err']):.1f} deg")
    return r


if __name__ == "__main__":
    main()
