#!/usr/bin/env python3
"""Measure the reward delta of the hinge-for-ball-joint substitution in
DPEnvV1 (port of ``tools/ball_vs_hinge_study.py``).

The upstream v1 env runs on a ball-joint MJCF (the upstream DeepMimic
repository's ``src/mujoco/humanoid_deepmimic/envs/asset/dp_env_v1.xml``);
the port's ``envs/dp_env_v1.py`` runs the same reward semantics on the
hinge model and argues kinematic identity in its docstring.  This study
turns that argument into measurements, entirely inside real MuJoCo (no
port physics in the loop, so the deltas isolate the joint
parameterization, not the solver):

* **Test A — kinematic identity.** Map every frame of every clip onto
  (a) the reference ball-joint model (euler rxyz triple -> joint
  quaternion) and (b) a hinge *twin* of the same XML (each ball joint
  replaced by an x,y,z hinge stack; identical defaults, geoms, gears).
  Compare forward-kinematics body positions.  Identity predicts ~0.
* **Test B — dynamic PD tracking.** From matched initial states, run the
  same stable-PD clip-tracking controller on both models for a full
  episode (v1 control: frame_skip 6 at dt 0.002) and score both
  trajectories with the v1 reward.  Reports per-clip mean reward for
  ball vs hinge, the |delta|, and the open-loop root divergence.
* **Test C — ball cone limits.** The only v1 feature a hinge stack
  cannot express exactly is the ball joint's total-rotation-angle limit.
  Rerun Test B on the ball model with limits disabled; the delta bounds
  how much the cone limits matter under tracking control.

The twin XML is derived from ``--v1-xml`` at run time; without that file
the study prints a note and exits 0.  The default is the upstream
repository checked out as ``reference/`` in this repository's root.
Numpy and MuJoCo on the host only: it launches no kernel, and the card's
machine has no MuJoCo.

    python -m deepmimic_mujoco_torch.cli.ball_vs_hinge_study \
        --out benchdata/ball_vs_hinge_v1.json
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import xml.etree.ElementTree as ET

import numpy as np

from deepmimic_mujoco_torch.mocap.constants import (
    BODY_JOINTS,
    DOF_DEF,
    JOINT_WEIGHT,
    PARAMS_KP_KD,
)
from deepmimic_mujoco_torch.mocap.registry import available_clips, get_clip

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
V1_XML = os.path.join(REPO, "reference", "src", "mujoco",
                      "humanoid_deepmimic", "envs", "asset", "dp_env_v1.xml")

# ---------------------------------------------------------------- quaternions
# wxyz, numpy; conventions match deepmimic_mujoco_torch.utils.quaternion


def qmul(q, r):
    w1, x1, y1, z1 = q
    w2, x2, y2, z2 = r
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def quat_from_euler_rxyz(e):
    """Intrinsic rotating x-y-z (Gohlke 'rxyz') — the mocap euler layout."""
    out = np.array([1.0, 0.0, 0.0, 0.0])
    for ang, axis in zip(e, np.eye(3)):
        h = 0.5 * ang
        out = qmul(out, np.concatenate([[np.cos(h)], np.sin(h) * axis]))
    return out


def angle_between(q0, q1):
    d = np.clip(abs(float(np.dot(q0, q1))), 0.0, 1.0)
    return 2.0 * np.arccos(d)


# ----------------------------------------------------------------- twin model

def make_hinge_twin_xml(ball_xml_path: str) -> str:
    """Replace every ball joint with an x,y,z hinge stack, remap actuators."""
    tree = ET.parse(ball_xml_path)
    root = tree.getroot()
    ball_names = []
    for body in root.iter("body"):
        for j in list(body):
            if j.tag != "joint" or j.get("type") != "ball":
                continue
            name = j.get("name")
            ball_names.append(name)
            idx = list(body).index(j)
            body.remove(j)
            for k, ax in enumerate(("1 0 0", "0 1 0", "0 0 1")):
                h = copy.deepcopy(j)
                h.set("type", "hinge")
                h.set("axis", ax)
                h.set("name", f"{name}_{'xyz'[k]}")
                # a per-axis hinge range cannot express the ball's
                # total-angle cone; disable (Test C bounds the effect)
                h.set("limited", "false")
                h.attrib.pop("range", None)
                body.insert(idx + k, h)
    for mot in root.iter("motor"):
        jname = mot.get("joint")
        if jname in ball_names:
            gear = np.array(mot.get("gear").split(), float)
            axis = int(np.nonzero(gear)[0][0])
            mot.set("joint", f"{jname}_{'xyz'[axis]}")
            mot.set("gear", f"{gear[axis]:g}")
    return ET.tostring(root, encoding="unicode")


def disable_limits_xml(ball_xml_path: str) -> str:
    tree = ET.parse(ball_xml_path)
    root = tree.getroot()
    for j in root.iter("joint"):
        if j.get("type") == "ball":
            j.set("limited", "false")
    return ET.tostring(root, encoding="unicode")


# ------------------------------------------------------------- state mapping

def build_maps(m, mujoco):
    """Per-joint (name, type, qposadr, dofadr) in model order, skipping root."""
    out = []
    for j in range(m.njnt):
        name = mujoco.mj_id2name(m, mujoco.mjtObj.mjOBJ_JOINT, j)
        if name == "root":
            continue
        out.append((name, int(m.jnt_type[j]), int(m.jnt_qposadr[j]),
                    int(m.jnt_dofadr[j])))
    return out


def clip_frame_to_qpos(frame, joints, mujoco, hinge_layout):
    """Map a loader-layout frame (root7 + euler triples/hinges in
    BODY_JOINTS order) onto a model's qpos."""
    qpos = np.zeros(hinge_layout["nq"])
    qpos[:7] = frame[:7]
    off = 7
    vals = {}
    for jn in BODY_JOINTS:
        d = DOF_DEF[jn]
        vals[jn] = frame[off:off + d]
        off += d
    for name, jtype, qadr, _ in joints:
        base = name.rsplit("_", 1)[0] if name[-2:] in ("_x", "_y", "_z") \
            else name
        if jtype == 1:  # ball
            qpos[qadr:qadr + 4] = quat_from_euler_rxyz(vals[name])
        elif name in vals:  # plain hinge (elbow/knee)
            qpos[qadr] = vals[name][0]
        else:  # twin hinge component
            qpos[qadr] = vals[base]["xyz".index(name[-1])]
    return qpos


def finite_diff_qvel(m, d, mujoco, qp0, qp1, dt):
    """Model-consistent velocity between two qpos via mj_differentiatePos."""
    qvel = np.zeros(m.nv)
    mujoco.mj_differentiatePos(m, qvel, dt, qp0, qp1)
    return qvel


# ------------------------------------------------------------------ v1 reward

def v1_reward(m, mujoco, joints, qpos, qvel, ref_qpos, ref_qvel):
    """The v1 reward (dp_env_v1.py:130-139) computed model-agnostically:
    pose error from joint quaternion angles + root, L1 velocity, root pos."""
    e_pose = JOINT_WEIGHT["root"] * angle_between(qpos[3:7], ref_qpos[3:7])
    seen = set()
    for name, jtype, qadr, _ in joints:
        base = name.rsplit("_", 1)[0] if name[-2:] in ("_x", "_y", "_z") \
            else name
        if base in seen:
            continue
        if jtype == 1:  # ball
            q0, q1 = qpos[qadr:qadr + 4], ref_qpos[qadr:qadr + 4]
        elif name == base:  # plain hinge: 1-dof angle difference
            e_pose += JOINT_WEIGHT[base] * abs(qpos[qadr] - ref_qpos[qadr])
            seen.add(base)
            continue
        else:  # hinge-triple: rebuild quats from the three stacked angles
            q0 = quat_from_euler_rxyz(qpos[qadr:qadr + 3])
            q1 = quat_from_euler_rxyz(ref_qpos[qadr:qadr + 3])
        e_pose += JOINT_WEIGHT[base] * angle_between(q0, q1)
        seen.add(base)
    e_vel = float(np.sum(np.abs(ref_qvel[3:] - qvel[3:])))
    e_root = float(np.sum(np.abs(qpos[:3] - ref_qpos[:3])))
    return (0.5 * np.exp(-2.0 * e_pose) + 0.05 * np.exp(-0.1 * e_vel)
            + 0.2 * np.exp(-5.0 * e_root))


# ----------------------------------------------------------------------- main

def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--clips", default="")
    p.add_argument("--horizon", type=int, default=180,
                   help="PD-tracking control steps per clip (frame_skip 6)")
    p.add_argument("--fk-frames", type=int, default=0,
                   help="cap FK frames per clip (0 = all)")
    p.add_argument("--out", default="")
    p.add_argument("--v1-xml", default=V1_XML,
                   help="the upstream ball-joint dp_env_v1.xml")
    args = p.parse_args(argv)

    if not os.path.exists(args.v1_xml):
        note = {"skipped": "reference XML absent"}
        print(json.dumps(note))
        return note

    import mujoco

    m_ball = mujoco.MjModel.from_xml_path(args.v1_xml)
    m_hinge = mujoco.MjModel.from_xml_string(make_hinge_twin_xml(args.v1_xml))
    m_free = mujoco.MjModel.from_xml_string(disable_limits_xml(args.v1_xml))
    models = {"ball": m_ball, "hinge": m_hinge, "ball_nolimit": m_free}
    joints = {k: build_maps(v, mujoco) for k, v in models.items()}
    layouts = {k: {"nq": v.nq} for k, v in models.items()}
    assert m_ball.nu == m_hinge.nu == 28

    # per-dof PD gains in hinge/dof order == actuator order in both models
    kp, kd = [], []
    for jn in BODY_JOINTS:
        kp += [PARAMS_KP_KD[jn][0]] * DOF_DEF[jn]
        kd += [PARAMS_KP_KD[jn][1]] * DOF_DEF[jn]
    kp, kd = np.asarray(kp, float), np.asarray(kd, float)

    clips = args.clips.split(",") if args.clips else available_clips()
    report = {"fk_identity": {}, "pd_tracking": {}, "horizon": args.horizon}

    for clip_name in clips:
        clip = get_clip(clip_name)
        qp = np.asarray(clip.qpos, float)
        n = len(qp) if not args.fk_frames else min(len(qp), args.fk_frames)

        # ---- Test A: FK identity over every frame
        dat = {k: mujoco.MjData(v) for k, v in models.items()}
        max_dpos = 0.0
        for i in range(n):
            xpos = {}
            for k in ("ball", "hinge"):
                dat[k].qpos[:] = clip_frame_to_qpos(
                    qp[i], joints[k], mujoco, layouts[k])
                mujoco.mj_kinematics(models[k], dat[k])
                xpos[k] = dat[k].xpos.copy()
            max_dpos = max(max_dpos,
                           float(np.abs(xpos["ball"] - xpos["hinge"]).max()))
        report["fk_identity"][clip_name] = round(max_dpos, 9)

        # ---- Tests B/C: PD tracking from frame 0, v1 reward on each model
        frame_skip, dt = 6, float(models["ball"].opt.timestep)
        mocap_dt = float(clip.dt)
        upd = max(1, int(mocap_dt // (dt * frame_skip)))
        res = {}
        for k, m in models.items():
            d = dat[k]
            refs = [clip_frame_to_qpos(f, joints[k], mujoco, layouts[k])
                    for f in qp]
            ref_vel = [finite_diff_qvel(m, d, mujoco, refs[i],
                                        refs[min(i + 1, len(refs) - 1)],
                                        mocap_dt)
                       for i in range(len(refs))]
            mujoco.mj_resetData(m, d)
            d.qpos[:] = refs[0]
            d.qvel[:] = ref_vel[0]
            rews, divs = [], []
            for t in range(1, args.horizon + 1):
                ridx = min((t // upd) % len(refs), len(refs) - 1)
                tq = refs[ridx]
                for _ in range(frame_skip):
                    # stable PD toward the reference frame, velocity-damped
                    err = np.zeros(m.nv)
                    mujoco.mj_differentiatePos(m, err, 1.0, d.qpos, tq)
                    tau = kp * err[6:] - kd * d.qvel[6:]
                    gears = m.actuator_gear[:, :3].sum(axis=1)
                    d.ctrl[:] = np.clip(tau / gears, -20, 20)
                    mujoco.mj_step(m, d)
                rews.append(v1_reward(m, mujoco, joints[k], d.qpos.copy(),
                                      d.qvel.copy(), refs[ridx],
                                      ref_vel[ridx]))
                divs.append(float(np.linalg.norm(d.qpos[:3] - tq[:3])))
                if d.qpos[2] < 0.3 or not np.isfinite(d.qpos).all():
                    break
            res[k] = {"reward_mean": round(float(np.mean(rews)), 4),
                      "steps": len(rews),
                      "root_div_final": round(divs[-1], 4)}
        res["delta_hinge_vs_ball"] = round(
            abs(res["hinge"]["reward_mean"] - res["ball"]["reward_mean"]), 4)
        res["delta_cone_limits"] = round(
            abs(res["ball_nolimit"]["reward_mean"]
                - res["ball"]["reward_mean"]), 4)
        report["pd_tracking"][clip_name] = res
        print(f"{clip_name}: fk_max_dpos={report['fk_identity'][clip_name]} "
              f"ball={res['ball']['reward_mean']} "
              f"hinge={res['hinge']['reward_mean']} "
              f"d_joint={res['delta_hinge_vs_ball']} "
              f"d_limits={res['delta_cone_limits']}", flush=True)

    deltas = [v["delta_hinge_vs_ball"]
              for v in report["pd_tracking"].values()]
    report["summary"] = {
        "fk_max_dpos_all": max(report["fk_identity"].values()),
        "reward_delta_mean": round(float(np.mean(deltas)), 4),
        "reward_delta_max": round(float(np.max(deltas)), 4),
    }
    print(json.dumps(report["summary"]))
    if args.out:
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
