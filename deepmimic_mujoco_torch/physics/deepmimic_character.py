"""DeepMimic character importer: skeleton/body JSON → :class:`PhysicsModel`
(port of ``deepmimic_mujoco_tpu/physics/deepmimic_character.py``).

Reads the original DeepMimic character format (Skeleton Joints with attach
offsets, types and limits; BodyDefs with shapes and masses) and builds the
equivalent Z-up hinge model:

* Y-up → Z-up: positions (x, y, z) → (x, −z, y)
* spherical joints → x, y, z hinge stacks with the limits mapped
  (mj_x = dm_x; mj_y = −dm_z ⇒ range (−hi_z, −lo_z); mj_z = dm_y)
* revolute joints → a hinge about (0, −1, 0) with the DeepMimic range
* shapes: sphere (Param0 = diameter), capsule (Param0 = diameter, Param1 =
  cylinder length along the up axis), box (Params = full sizes)

A controller file, if given, supplies the motor gears (its TorqueLim).
``assets/characters/humanoid3d.json`` and ``assets/controllers/
humanoid3d_ctrl.json`` are :func:`export_character`'s output and load back
to ``build_humanoid``'s model."""

from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from deepmimic_mujoco_torch.physics.inertia import BOX, CAPSULE, SPHERE
from deepmimic_mujoco_torch.physics.model import ModelBuilder, PhysicsModel
from deepmimic_mujoco_torch.utils.device import resolve_device

_SHAPES = {"sphere": SPHERE, "capsule": CAPSULE, "box": BOX}
_SHAPE_NAMES = {SPHERE: "sphere", CAPSULE: "capsule", BOX: "box"}

# canonical joint order for qpos-layout compatibility with the mocap pipeline
_CANONICAL_JOINTS = [
    "chest", "neck", "right_shoulder", "right_elbow",
    "left_shoulder", "left_elbow", "right_hip", "right_knee",
    "right_ankle", "left_hip", "left_knee", "left_ankle",
]

_DEFAULT_GEARS = {
    "chest": 200, "neck": 50, "right_shoulder": 100, "right_elbow": 60,
    "left_shoulder": 100, "left_elbow": 60, "right_hip": 200,
    "right_knee": 150, "right_ankle": 90, "left_hip": 200,
    "left_knee": 150, "left_ankle": 90,
}


def _align(v) -> tuple:
    """(x, y, z)_Yup → (x, −z, y)_Zup."""
    return (v[0], -v[2], v[1])


def load_character(path: str, ctrl_path: Optional[str] = None,
                   dt: float = 0.0166, integrator: str = "rk4",
                   contact_cap: int = 16, limit_cap: int = 16,
                   device: torch.device | str | None = None) -> PhysicsModel:
    """The model of a DeepMimic character file (and, with ``ctrl_path``,
    the torque limits of its controller file as motor gears), on ``device``
    (CUDA by default, :func:`resolve_device`).  The :class:`ModelBuilder`
    defaults apply (exact-cold solves) with 16/16 contact/limit caps
    (ne 64)."""
    with open(path) as f:
        char = json.load(f)
    joints = {j["Name"]: j for j in char["Skeleton"]["Joints"]}
    by_id = {j["ID"]: j for j in char["Skeleton"]["Joints"]}
    bodies = {b["Name"]: b for b in char["BodyDefs"]}

    gears = dict(_DEFAULT_GEARS)
    if ctrl_path:
        with open(ctrl_path) as f:
            ctrl = json.load(f)
        for pd in ctrl.get("PDControllers", []):
            if pd.get("TorqueLim"):
                gears[pd["Name"]] = pd["TorqueLim"]

    b = ModelBuilder(dt=dt, integrator=integrator,
                     max_contacts=contact_cap, max_limits=limit_cap)

    # bodies in parent-first order (skip 'fixed' end effectors: their geoms
    # attach to the parent body, like the reference's wrist spheres)
    order = sorted(joints.values(), key=lambda j: j["ID"])
    name_of = {}
    root_pos = (0.0, 0.0, 0.9)
    for j in order:
        name = j["Name"]
        jtype = j["Type"]
        parent = None if j["Parent"] < 0 else by_id[j["Parent"]]["Name"]
        if jtype == "fixed":
            name_of[name] = name_of[parent]  # geoms go to the parent body
            continue
        pos = _align((j["AttachX"], j["AttachY"], j["AttachZ"]))
        if parent is None:
            b.add_body(name, None, pos=root_pos)
        else:
            b.add_body(name, name_of[parent], pos=pos)
        name_of[name] = name

    # geoms
    for bd in char["BodyDefs"]:
        name = bd["Name"]
        body = name_of[name]
        shape = _SHAPES[bd["Shape"]]
        mass = float(bd["Mass"])
        attach = np.asarray(
            _align((bd["AttachX"], bd["AttachY"], bd["AttachZ"])))
        if name != body:  # fixed joint: offset by the joint attach
            j = joints[name]
            attach = attach + np.asarray(
                _align((j["AttachX"], j["AttachY"], j["AttachZ"])))
        if shape == SPHERE:
            b.add_geom(name, body, SPHERE, mass,
                       size=(bd["Param0"] / 2, 0, 0), pos=tuple(attach))
        elif shape == CAPSULE:
            r = bd["Param0"] / 2
            half = bd["Param1"] / 2
            fromto = tuple(attach + np.array([0, 0, half])) + \
                tuple(attach - np.array([0, 0, half]))
            b.add_geom(name, body, CAPSULE, mass, size=(r, 0, 0), fromto=fromto)
        else:  # box: DM params are full sizes in the Y-up frame
            size_dm = (bd["Param0"], bd["Param1"], bd["Param2"])
            sx, sy, sz = size_dm[0] / 2, size_dm[2] / 2, size_dm[1] / 2
            b.add_geom(name, body, BOX, mass, size=(sx, sy, sz),
                       pos=tuple(attach))

    # joints in canonical order when possible
    names = [j["Name"] for j in order if j["Type"] in ("spherical", "revolute")]
    joint_order = [n for n in _CANONICAL_JOINTS if n in names] + \
        [n for n in names if n not in _CANONICAL_JOINTS]
    for name in joint_order:
        j = joints[name]
        if j["Type"] == "spherical":
            lims = [
                (j["LimLow0"], j["LimHigh0"]),                    # mj x = dm x
                (-j["LimHigh2"], -j["LimLow2"]),                  # mj y = -dm z
                (j["LimLow1"], j["LimHigh1"]),                    # mj z = dm y
            ]
            for axis_name, axis, rng in zip(
                    "xyz", ((1, 0, 0), (0, 1, 0), (0, 0, 1)), lims):
                b.add_hinge(f"{name}_{axis_name}", name, axis, rng)
        elif j["Type"] == "revolute":
            b.add_hinge(name, name, (0, -1, 0),
                        (j["LimLow0"], j["LimHigh0"]))

    for name in joint_order:
        j = joints[name]
        gear = gears.get(name, max(1.0, float(j.get("TorqueLim", 100))))
        if j["Type"] == "spherical":
            for axis_name in "xyz":
                b.add_motor(f"{name}_{axis_name}", gear)
        elif j["Type"] == "revolute":
            b.add_motor(name, gear)

    return b.finalize(root_pos=root_pos, device=resolve_device(device))


def _unalign(v) -> tuple:
    """(x, y, z)_Zup → (x, z, −y)_Yup — inverse of :func:`_align`."""
    return (float(v[0]), float(v[2]), float(-v[1]))


def export_character(gears: Optional[dict] = None) -> tuple[dict, dict]:
    """(character_json, controller_json) in the original DeepMimic format
    from the humanoid's tables (``physics/humanoid.py``): the inverse of
    :func:`load_character`, so the shipped assets round-trip through the
    importer.  The controller entries are Name/Kp/Kd/TorqueLim with
    UpdateRate 30, the shape of DeepMimic's humanoid3d_ctrl spec."""
    from deepmimic_mujoco_torch.mocap.constants import PARAMS_KP_KD
    from deepmimic_mujoco_torch.physics import humanoid as H

    gears = gears or H._GEARS
    joints_out, bodies_out, pd_out = [], [], []
    ids = {name: i for i, (name, _, _) in enumerate(H._BODIES)}

    for name, parent, pos in H._BODIES:
        ax, ay, az = _unalign(pos)
        j = {
            "ID": ids[name], "Name": name,
            "Parent": -1 if parent is None else ids[parent],
            "AttachX": ax, "AttachY": ay, "AttachZ": az,
            "TorqueLim": float(gears.get(name, 0)),
        }
        if name == "root":
            j["Type"] = "none"
        elif name in H._SPHERICAL:
            j["Type"] = "spherical"
            (xl, xh), (yl, yh), (zl, zh) = H._SPHERICAL[name]
            # inverse of the importer's axis mapping:
            # dm x = mj x; dm y = mj z; dm z-range = (−mj_y_hi, −mj_y_lo)
            j.update(LimLow0=xl, LimHigh0=xh, LimLow1=zl, LimHigh1=zh,
                     LimLow2=-yh, LimHigh2=-yl)
        else:
            j["Type"] = "revolute"
            lo, hi = H._REVOLUTE[name]
            j.update(LimLow0=lo, LimHigh0=hi)
        joints_out.append(j)

    # wrist end-effectors are 'fixed' joints in the DM format
    next_id = len(joints_out)
    for side in ("right", "left"):
        joints_out.append({
            "ID": next_id, "Name": f"{side}_wrist",
            "Parent": ids[f"{side}_elbow"], "Type": "fixed",
            "AttachX": 0.0, "AttachY": 0.0, "AttachZ": 0.0, "TorqueLim": 0.0,
        })
        next_id += 1

    for g_name, g_body, g_type, g_mass, spec in H._GEOMS:
        if "fromto" in spec:
            f = np.asarray(spec["fromto"], float)
            center = (f[:3] + f[3:]) / 2.0
            length = float(np.linalg.norm(f[:3] - f[3:]))
            ax, ay, az = _unalign(center)
            bodies_out.append({
                "Name": g_name, "Shape": "capsule", "Mass": g_mass,
                "AttachX": ax, "AttachY": ay, "AttachZ": az,
                "Param0": 2.0 * float(spec["size"][0]), "Param1": length,
                "Param2": 0.0,
            })
        else:
            ax, ay, az = _unalign(spec["pos"])
            if g_type == SPHERE:
                p0, p1, p2 = 2.0 * float(spec["size"][0]), 0.0, 0.0
            else:  # box: (sx, sy, sz) half → DM full sizes in Y-up order
                sx, sy, sz = (float(s) for s in spec["size"])
                p0, p1, p2 = 2 * sx, 2 * sz, 2 * sy
            bodies_out.append({
                "Name": g_name, "Shape": _SHAPE_NAMES[g_type], "Mass": g_mass,
                "AttachX": ax, "AttachY": ay, "AttachZ": az,
                "Param0": p0, "Param1": p1, "Param2": p2,
            })

    for name in H._JOINT_ORDER:
        kp, kd = PARAMS_KP_KD[name]
        pd_out.append({"Name": name, "Kp": kp, "Kd": kd,
                       "TorqueLim": float(gears[name]), "UpdateRate": 30})

    character = {"Skeleton": {"Joints": joints_out}, "BodyDefs": bodies_out}
    controller = {"PDControllers": pd_out}
    return character, controller
