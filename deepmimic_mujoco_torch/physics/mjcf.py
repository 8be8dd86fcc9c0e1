"""MJCF-subset importer → :class:`PhysicsModel` (port of
``deepmimic_mujoco_tpu/physics/mjcf.py``).

Covers what the reference's models use: nested ``<body>`` trees with a free
root and hinge joints (joint defaults: armature, damping, limited),
sphere / capsule (``fromto``) / box geoms with explicit masses, ``<motor>``
actuators with gear and ctrlrange, ``<option>`` timestep / integrator /
iterations, and a plane floor (its friction becomes the ground's).  Other
elements are ignored; ball and slide joints, a free joint below the root
and hinges anchored off their body's origin raise.

The model comes out with the :class:`ModelBuilder` defaults — exact-cold:
cold ``iterations``-budget solves, f32 dual matrix, no stage reuse — and
its M⁻¹ path chosen by :func:`engine.calibrate_minv_mode`."""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Optional

import numpy as np
import torch

from deepmimic_mujoco_torch.physics import engine
from deepmimic_mujoco_torch.physics.inertia import BOX, CAPSULE, SPHERE
from deepmimic_mujoco_torch.physics.model import ModelBuilder, PhysicsModel
from deepmimic_mujoco_torch.utils.device import resolve_device

_GEOM_TYPES = {"sphere": SPHERE, "capsule": CAPSULE, "box": BOX}


def _floats(s: Optional[str], default=None):
    if s is None:
        return default
    return tuple(float(x) for x in s.split())


def parse_mjcf(xml_string: str, contact_cap: int = 1 << 30,
               limit_cap: int = 1 << 30,
               device: torch.device | str | None = None) -> PhysicsModel:
    """The model an MJCF string describes, on ``device`` (CUDA by default,
    :func:`resolve_device`).  Euler is the integrator when ``<option>``
    names none, as in MuJoCo."""
    root = ET.fromstring(xml_string)

    joint_default = {"armature": 1.0, "damping": 1.0, "limited": True}
    motor_default = {"ctrlrange": (-0.5, 0.5)}
    default_el = root.find("default")
    if default_el is not None:
        jd = default_el.find("joint")
        if jd is not None:
            joint_default["armature"] = float(jd.get("armature", 1.0))
            joint_default["damping"] = float(jd.get("damping", 1.0))
            joint_default["limited"] = jd.get("limited", "true") == "true"
        md = default_el.find("motor")
        if md is not None:
            motor_default["ctrlrange"] = _floats(md.get("ctrlrange"),
                                                 (-0.5, 0.5))

    opt = root.find("option")
    dt = float(opt.get("timestep", 0.002)) if opt is not None else 0.002
    integrator = (opt.get("integrator", "Euler") if opt is not None
                  else "Euler").lower()
    integrator = "rk4" if integrator == "rk4" else "euler"
    iterations = int(opt.get("iterations", 50)) if opt is not None else 50

    b = ModelBuilder(dt=dt, integrator=integrator, iterations=iterations,
                     max_contacts=contact_cap, max_limits=limit_cap)

    worldbody = root.find("worldbody")
    if worldbody is None:
        raise ValueError("MJCF has no <worldbody>")

    for geom in worldbody.findall("geom"):
        if geom.get("type") == "plane":
            b.floor_friction = np.asarray(
                _floats(geom.get("friction"), (1.0, 0.1, 0.1)))

    geom_counter = [0]
    root_pose = [None, None]

    def walk(body_el, parent_name: Optional[str]):
        name = body_el.get("name") or f"body{len(b.bodies)}"
        pos = _floats(body_el.get("pos"), (0, 0, 0))
        quat = _floats(body_el.get("quat"), (1, 0, 0, 0))
        if parent_name is None:
            # the free root's XML pose is only its initial qpos: FK reads
            # the root pose from qpos
            root_pose[:] = [pos, quat]
        b.add_body(name, parent_name, pos=pos, quat=quat)

        for joint in body_el.findall("joint"):
            jtype = joint.get("type", "hinge")
            if jtype == "free":
                if parent_name is not None:
                    raise ValueError(
                        "free joint only supported on the root body")
                continue
            if jtype != "hinge":
                raise ValueError(f"unsupported joint type {jtype!r}")
            jpos = _floats(joint.get("pos"), (0, 0, 0))
            if any(abs(v) > 1e-12 for v in jpos):
                # the engine anchors hinges at the body origin
                # (kinematics.fk): importing another anchor would simulate
                # other dynamics than MuJoCo's
                raise ValueError(
                    f"hinge {joint.get('name')!r} has a non-origin pos "
                    f"{jpos}; re-author the model with joint anchors at "
                    "body origins (supported engine convention)")
            default_limited = "true" if joint_default["limited"] else "false"
            b.add_hinge(
                joint.get("name") or f"{name}_j", name,
                _floats(joint.get("axis"), (0, 0, 1)),
                range=_floats(joint.get("range"), (0.0, 0.0)),
                limited=joint.get("limited", default_limited) == "true",
                armature=float(joint.get("armature",
                                         joint_default["armature"])),
                damping=float(joint.get("damping", joint_default["damping"])))

        for geom in body_el.findall("geom"):
            gtype = geom.get("type", "sphere")
            if gtype not in _GEOM_TYPES:
                continue
            gname = geom.get("name") or f"geom{geom_counter[0]}"
            geom_counter[0] += 1
            size = _floats(geom.get("size"), (0.1,))
            kwargs = dict(size=tuple(size) + (0.0,) * (3 - len(size)),
                          mass=float(geom.get("mass", 1.0)))
            if geom.get("fromto"):
                kwargs["fromto"] = _floats(geom.get("fromto"))
            else:
                kwargs["pos"] = _floats(geom.get("pos"), (0, 0, 0))
                kwargs["quat"] = _floats(geom.get("quat"), (1, 0, 0, 0))
            if geom.get("friction"):
                kwargs["friction"] = _floats(geom.get("friction"))
            b.add_geom(gname, name, _GEOM_TYPES[gtype], **kwargs)

        for child in body_el.findall("body"):
            walk(child, name)

    bodies = worldbody.findall("body")
    if len(bodies) != 1:
        raise ValueError("expected exactly one root <body> under <worldbody>")
    walk(bodies[0], None)

    actuator_el = root.find("actuator")
    if actuator_el is not None:
        for motor in actuator_el.findall("motor"):
            b.add_motor(motor.get("joint"), float(motor.get("gear", 1.0)),
                        ctrl_range=_floats(motor.get("ctrlrange"),
                                           motor_default["ctrlrange"]))

    model = b.finalize(root_pos=root_pose[0] or (0, 0, 0),
                       root_quat=root_pose[1] or (1, 0, 0, 0),
                       device=resolve_device(device))
    # an imported model may condition M worse than the humanoid the
    # Newton–Schulz budget was tuned for: pick the M⁻¹ path once, here
    return engine.calibrate_minv_mode(model)


def load_mjcf(path: str, **kwargs) -> PhysicsModel:
    """:func:`parse_mjcf` of a file."""
    with open(path) as f:
        return parse_mjcf(f.read(), **kwargs)
