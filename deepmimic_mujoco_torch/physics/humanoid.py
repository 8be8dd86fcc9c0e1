"""The humanoid3d model (port of ``deepmimic_mujoco_tpu/physics/humanoid.py:
build_humanoid``): 13 bodies, 28 hinges, 45 kg, built through
:class:`ModelBuilder` with the same geometry, masses, ranges and gears."""

from __future__ import annotations

import dataclasses

import torch

from deepmimic_mujoco_torch.physics.inertia import BOX, CAPSULE, SPHERE
from deepmimic_mujoco_torch.physics.model import ModelBuilder, PhysicsModel
from deepmimic_mujoco_torch.utils.device import resolve_device

# (name, parent, body_pos) — offsets in parent frame
_BODIES = [
    ("root", None, (0.0, 0.0, 0.9)),
    ("chest", "root", (0.0, 0.0, 0.236151)),
    ("neck", "chest", (0.0, 0.0, 0.223894)),
    ("right_shoulder", "chest", (-0.02405, -0.18311, 0.2435)),
    ("right_elbow", "right_shoulder", (0.0, 0.0, -0.274788)),
    ("left_shoulder", "chest", (-0.02405, 0.18311, 0.2435)),
    ("left_elbow", "left_shoulder", (0.0, 0.0, -0.274788)),
    ("right_hip", "root", (0.0, -0.084887, 0.0)),
    ("right_knee", "right_hip", (0.0, 0.0, -0.421546)),
    ("right_ankle", "right_knee", (0.0, 0.0, -0.40987)),
    ("left_hip", "root", (0.0, 0.084887, 0.0)),
    ("left_knee", "left_hip", (0.0, 0.0, -0.421546)),
    ("left_ankle", "left_knee", (0.0, 0.0, -0.40987)),
]

# spherical joints as x,y,z hinge stacks: (joint, ranges per axis)
_SPHERICAL = {
    "chest": ((-1.2, 1.2), (-1.2, 1.2), (-1.2, 1.2)),
    "neck": ((-1.0, 1.0), (-1.0, 1.0), (-1.0, 1.0)),
    "right_shoulder": ((-3.14, 0.5), (-3.14, 0.7), (-1.5, 1.5)),
    "left_shoulder": ((-0.5, 3.14), (-3.14, 0.7), (-1.5, 1.5)),
    "right_hip": ((-1.2, 1.2), (-2.57, 1.57), (-1.0, 1.0)),
    "left_hip": ((-1.2, 1.2), (-2.57, 1.57), (-1.0, 1.0)),
    "right_ankle": ((-1.0, 1.0), (-1.0, 1.57), (-1.0, 1.0)),
    "left_ankle": ((-1.0, 1.0), (-1.0, 1.57), (-1.0, 1.0)),
}
# 1-dof hinges about (0,-1,0)
_REVOLUTE = {
    "right_elbow": (0.0, 2.8),
    "left_elbow": (0.0, 2.8),
    "right_knee": (-2.7, 0.0),
    "left_knee": (-2.7, 0.0),
}

# geoms: (name, body, type, mass, spec)
_GEOMS = [
    ("root", "root", SPHERE, 6.0, dict(size=(0.09, 0, 0), pos=(0, 0, 0.07))),
    ("chest", "chest", SPHERE, 14.0, dict(size=(0.11, 0, 0), pos=(0, 0, 0.12))),
    ("neck", "neck", SPHERE, 2.0, dict(size=(0.1025, 0, 0), pos=(0, 0, 0.175))),
    ("right_shoulder", "right_shoulder", CAPSULE, 1.5,
     dict(size=(0.045, 0, 0), fromto=(0, 0, -0.05, 0, 0, -0.23))),
    ("right_elbow", "right_elbow", CAPSULE, 1.0,
     dict(size=(0.04, 0, 0), fromto=(0, 0, -0.0525, 0, 0, -0.1875))),
    ("right_wrist", "right_elbow", SPHERE, 0.5,
     dict(size=(0.04, 0, 0), pos=(0, 0, -0.258947))),
    ("left_shoulder", "left_shoulder", CAPSULE, 1.5,
     dict(size=(0.045, 0, 0), fromto=(0, 0, -0.05, 0, 0, -0.23))),
    ("left_elbow", "left_elbow", CAPSULE, 1.0,
     dict(size=(0.04, 0, 0), fromto=(0, 0, -0.0525, 0, 0, -0.1875))),
    ("left_wrist", "left_elbow", SPHERE, 0.5,
     dict(size=(0.04, 0, 0), pos=(0, 0, -0.258947))),
    ("right_hip", "right_hip", CAPSULE, 4.5,
     dict(size=(0.055, 0, 0), fromto=(0, 0, -0.06, 0, 0, -0.36))),
    ("right_knee", "right_knee", CAPSULE, 3.0,
     dict(size=(0.05, 0, 0), fromto=(0, 0, -0.045, 0, 0, -0.355))),
    ("right_ankle", "right_ankle", BOX, 1.0,
     dict(size=(0.0885, 0.045, 0.0275), pos=(0.045, 0, -0.0225))),
    ("left_hip", "left_hip", CAPSULE, 4.5,
     dict(size=(0.055, 0, 0), fromto=(0, 0, -0.06, 0, 0, -0.36))),
    ("left_knee", "left_knee", CAPSULE, 3.0,
     dict(size=(0.05, 0, 0), fromto=(0, 0, -0.045, 0, 0, -0.355))),
    ("left_ankle", "left_ankle", BOX, 1.0,
     dict(size=(0.0885, 0.045, 0.0275), pos=(0.045, 0, -0.0225))),
]

# motor gear per joint (spherical → same gear on x,y,z)
_GEARS = {
    "chest": 200, "neck": 50, "right_shoulder": 100, "right_elbow": 60,
    "left_shoulder": 100, "left_elbow": 60, "right_hip": 200,
    "right_knee": 150, "right_ankle": 90, "left_hip": 200,
    "left_knee": 150, "left_ankle": 90,
}

# qpos joint ordering (after the free root) — matches the mocap pipeline
_JOINT_ORDER = [
    "chest", "neck", "right_shoulder", "right_elbow",
    "left_shoulder", "left_elbow", "right_hip", "right_knee",
    "right_ankle", "left_hip", "left_knee", "left_ankle",
]


def build_humanoid(dt: float = 0.0166, integrator: str = "rk4",
                   iterations: int = 50, contact_cap: int = 8,
                   limit_cap: int = 8, warm_iterations: int = 15,
                   solver_dtype: str = "bf16", stage_reuse: str = "kin",
                   stage_iterations: int = 8, apgd_layout: str = "blocks",
                   device: torch.device | str | None = None) -> PhysicsModel:
    """The reference's default configuration: 8/8 contact/limit caps (dual
    dimension ne = 32), stage-frozen RK4 kinematics, warm-started stage-1
    solves at 15 APGD iterations and stages 2-4 at 8, and a bf16-stored dual
    matrix.  ``device`` defaults to CUDA (see :func:`resolve_device`)."""
    if apgd_layout not in ("blocks", "lanes"):
        raise ValueError(f"unknown apgd_layout {apgd_layout!r}")
    b = ModelBuilder(dt=dt, integrator=integrator, iterations=iterations,
                     max_contacts=contact_cap, max_limits=limit_cap)
    for name, parent, pos in _BODIES:
        b.add_body(name, parent, pos=pos)
    for g_name, g_body, g_type, g_mass, spec in _GEOMS:
        b.add_geom(g_name, g_body, g_type, g_mass, **spec)
    for joint in _JOINT_ORDER:
        if joint in _SPHERICAL:
            for axis_name, axis, rng in zip(
                    "xyz", ((1, 0, 0), (0, 1, 0), (0, 0, 1)),
                    _SPHERICAL[joint]):
                b.add_hinge(f"{joint}_{axis_name}", joint, axis, rng)
        else:
            b.add_hinge(joint, joint, (0, -1, 0), _REVOLUTE[joint])
    for joint in _JOINT_ORDER:
        if joint in _SPHERICAL:
            for axis_name in "xyz":
                b.add_motor(f"{joint}_{axis_name}", _GEARS[joint])
        else:
            b.add_motor(joint, _GEARS[joint])
    return dataclasses.replace(
        b.finalize(root_pos=(0.0, 0.0, 0.9), device=resolve_device(device)),
        warm_iterations=warm_iterations, solver_dtype=solver_dtype,
        stage_reuse=stage_reuse, stage_iterations=stage_iterations,
        apgd_layout=apgd_layout)


def mocap_hinge_range(model: PhysicsModel | None = None, clips=None,
                      margin: float = 0.1,
                      device: torch.device | str | None = None
                      ) -> PhysicsModel:
    """The model with its hinge limit ranges widened to the union of the
    bundled clips' continuous pose tracks ± ``margin`` (never narrowed):
    the reference XML's ranges exclude poses of its own acrobatic clips
    (spinkick, backflip), and the limit rows then fight the PD controller.
    ``clips`` defaults to every bundled clip.  The returned model is on
    ``model``'s device (``build_humanoid(device=device)`` when ``model`` is
    None).  Port of ``deepmimic_mujoco_tpu/physics/humanoid.py:
    mocap_hinge_range``; the recipe opts in with ``--joint-limits mocap``."""
    import numpy as np

    from deepmimic_mujoco_torch.mocap.registry import available_clips, get_clip

    if model is None:
        model = build_humanoid(device=device)
    rng = model.hinge_range.cpu().numpy().copy()
    for name in (clips if clips is not None else available_clips()):
        t = get_clip(name).qpos_cont[:, 7:]
        rng[:, 0] = np.minimum(rng[:, 0], t.min(0) - margin)
        rng[:, 1] = np.maximum(rng[:, 1], t.max(0) + margin)
    return dataclasses.replace(model, hinge_range=torch.as_tensor(
        rng, dtype=torch.float32, device=model.device))
