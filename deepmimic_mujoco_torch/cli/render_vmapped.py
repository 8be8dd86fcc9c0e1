#!/usr/bin/env python3
"""Render one lane of a lane-stacked multi-skill checkpoint
(``cli/imitation15_vmapped.py``) to video (port of the JAX package's
``tools/render_vmapped.py``).

    python -m deepmimic_mujoco_torch.cli.render_vmapped \\
        --ckpt train_ckpt_imit5_r5b/imit15_state.npz \\
        --clips walk,run,spinkick,backflip,getup_facedown \\
        --motion spinkick --out figures/spinkick_r5.avi

The lane's params come out of the checkpoint through the port's lane
reader; the rollout (``render_policy.rollout``) runs one env of the
15-clip ``DPEnvV3Multi`` on the device, the CUDA card unless ``--device
cpu`` (or ``--platform cpu``) asks for the CPU.  The JAX tool defaults to
the CPU; the port's entry points run on the card unless asked.  The
frames where the episode was alive are rendered through host MuJoCo,
which with cv2 is checked before the rollout starts."""

from __future__ import annotations

import argparse
import os

from deepmimic_mujoco_torch.algos import lanes
from deepmimic_mujoco_torch.cli.imitation15_vmapped import CLIPS15
from deepmimic_mujoco_torch.cli.render_policy import device_of, rollout
from deepmimic_mujoco_torch.envs.multi_clip import DPEnvV3Multi
from deepmimic_mujoco_torch.io_utils import checkpoint, video
from deepmimic_mujoco_torch.models.policy import MlpPolicy
from deepmimic_mujoco_torch.physics.humanoid import mocap_hinge_range
from deepmimic_mujoco_torch.utils.device import PLATFORMS


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--clips", required=True,
                   help="lane order the checkpoint was trained with")
    p.add_argument("--env-clips", default=",".join(CLIPS15))
    p.add_argument("--motion", required=True, help="lane to render")
    p.add_argument("--out", default=None)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--start-frame", type=int, default=0)
    p.add_argument("--hidden-sizes", default="1024,512")
    p.add_argument("--fixed-logstd", type=float, default=-3.0)
    p.add_argument("--platform", default=None, choices=sorted(PLATFORMS),
                   help="the JAX tool's flag: cpu, or gpu/cuda for the card")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; pass cpu for the CPU); "
                        "takes precedence over --platform")
    return p


def setup(args, device):
    """(env, policy, params, start state): the 15-clip env capped at
    ``--steps``, ``--motion``'s lane of the checkpoint, one env at
    ``--start-frame`` of its clip."""
    clips = args.clips.split(",")
    env_clips = args.env_clips.split(",")
    lane = clips.index(args.motion)
    env = DPEnvV3Multi(
        clips=tuple(env_clips), model=mocap_hinge_range(device=device),
        control_mode="pd_residual", n_substeps=2,
        max_episode_steps=args.steps, reward_mode="imitation_dm",
        obs_mode="full", termination="fall_contact")
    policy = MlpPolicy(
        ob_dim=env.observation_size, ac_dim=env.action_size,
        hidden_sizes=tuple(int(h) for h in args.hidden_sizes.split(",")),
        activation="relu", fixed_logstd=args.fixed_logstd)
    stacked, _ = checkpoint.load_lane_params(args.ckpt, policy, device,
                                             lanes=[lane])
    params = lanes.lane_params(stacked, 0)
    state = env.reset_at(env_clips.index(args.motion), [args.start_frame])
    return env, policy, params, state


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    video.require_renderer()
    env, policy, params, state = setup(args, device_of(args))
    qpos, alive = rollout(env, policy, params, state, args.steps)
    qpos = qpos[:, 0][alive[:, 0]].cpu().numpy()
    out = args.out or f"figures/{args.motion}_r5.avi"
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    video.render_qpos_trajectory(
        qpos, out, fps=int(round(1.0 / (env.model.dt * 2))))
    print(f"rendered {len(qpos)} frames -> {out}")
    return {"frames": len(qpos), "out": out}


if __name__ == "__main__":
    main()
