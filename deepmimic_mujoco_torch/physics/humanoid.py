"""The humanoid3d model (port of ``deepmimic_mujoco_tpu/physics/humanoid.py``):
13 bodies, 28 hinges, 45 kg, built through :class:`ModelBuilder` with the
same geometry, masses, ranges and gears; ``to_mjcf`` and ``to_mjcf_v1_ball``
export it as MJCF for host MuJoCo."""

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


def to_mjcf(model: PhysicsModel | None = None, timestep: float = 0.0166,
            integrator: str = "RK4", visual: bool = False) -> str:
    """An MJCF string equivalent to :func:`build_humanoid`, for host MuJoCo
    (``physics/mj_host.py``, the checks against MuJoCo) and for rendering;
    byte for byte the JAX package's.  ``model`` is not read (the tables of
    this module are).  ``visual=True`` adds render-only dressing (a checker
    ground texture, a headlight) that :func:`parse_mjcf` ignores."""
    lines = [
        '<mujoco model="humanoid_tpu">',
        '  <compiler angle="radian" inertiafromgeom="true"/>',
        '  <default>',
        '    <joint limited="true" armature="1" damping="1"/>',
        '    <geom conaffinity="1" condim="1" contype="1" margin="0.001"/>',
        '    <motor ctrllimited="true" ctrlrange="-0.5 0.5"/>',
        '  </default>',
        f'  <option integrator="{integrator}" iterations="50" solver="PGS" timestep="{timestep}"/>',
    ]
    floor_visual = ""
    if visual:
        lines += [
            '  <visual>',
            '    <headlight ambient="0.4 0.4 0.4" diffuse="0.6 0.6 0.6"/>',
            '  </visual>',
            '  <asset>',
            '    <texture name="grid" type="2d" builtin="checker" '
            'rgb1="0.2 0.3 0.4" rgb2="0.8 0.8 0.8" width="512" height="512"/>',
            '    <material name="grid_mat" texture="grid" texrepeat="8 8" '
            'texuniform="true" reflectance="0.2"/>',
            '  </asset>',
        ]
        floor_visual = ' material="grid_mat"'
    lines += [
        '  <worldbody>',
        f'    <geom condim="3" friction="1 .1 .1" name="floor" pos="0 0 0" '
        f'size="50 50 0.2" type="plane"{floor_visual}/>',
    ]

    children: dict[str, list[str]] = {}
    parents = {}
    for name, parent, pos in _BODIES:
        parents[name] = parent
        children.setdefault(parent, []).append(name)

    def fmt(v):
        return " ".join(repr(round(float(x), 9)) for x in v)

    def emit_body(name: str, indent: str):
        pos = dict((n, p) for n, par, p in [(x[0], x[1], x[2]) for x in _BODIES])[name]
        lines.append(f'{indent}<body name="{name}" pos="{fmt(pos)}">')
        if name == "root":
            lines.append(
                f'{indent}  <joint armature="0" damping="0" limited="false" '
                f'name="root" pos="0 0 0" stiffness="0" type="free"/>'
            )
        elif name in _SPHERICAL:
            for axis_name, axis, rng in zip(
                "xyz", ("1 0 0", "0 1 0", "0 0 1"), _SPHERICAL[name]
            ):
                lines.append(
                    f'{indent}  <joint name="{name}_{axis_name}" axis="{axis}" '
                    f'pos="0 0 0" range="{rng[0]} {rng[1]}" type="hinge"/>'
                )
        else:
            rng = _REVOLUTE[name]
            lines.append(
                f'{indent}  <joint name="{name}" axis="0 -1 0" pos="0 0 0" '
                f'range="{rng[0]} {rng[1]}" type="hinge"/>'
            )
        for g_name, g_body, g_type, g_mass, spec in _GEOMS:
            if g_body != name:
                continue
            if "fromto" in spec:
                lines.append(
                    f'{indent}  <geom name="{g_name}" type="capsule" mass="{g_mass}" '
                    f'size="{spec["size"][0]}" fromto="{fmt(spec["fromto"])}"/>'
                )
            else:
                tname = {SPHERE: "sphere", BOX: "box"}[g_type]
                size = spec["size"] if g_type == BOX else spec["size"][:1]
                lines.append(
                    f'{indent}  <geom name="{g_name}" type="{tname}" mass="{g_mass}" '
                    f'pos="{fmt(spec["pos"])}" size="{fmt(size)}"/>'
                )
        for child in children.get(name, []):
            emit_body(child, indent + "  ")
        lines.append(f"{indent}</body>")

    emit_body("root", "    ")
    lines.append("  </worldbody>")
    # same contact excludes as the reference model
    lines.append("  <contact>")
    for b1, b2 in [
        ("right_hip", "root"), ("left_hip", "root"),
        ("right_hip", "right_knee"), ("left_hip", "left_knee"),
        ("right_knee", "right_ankle"), ("left_knee", "left_ankle"),
        ("right_elbow", "right_shoulder"), ("left_elbow", "left_shoulder"),
    ]:
        lines.append(f'    <exclude body1="{b1}" body2="{b2}"/>')
    lines.append("  </contact>")
    lines.append("  <actuator>")
    for joint in _JOINT_ORDER:
        if joint in _SPHERICAL:
            for axis_name in "xyz":
                nm = f"{joint}_{axis_name}"
                lines.append(f'    <motor gear="{_GEARS[joint]}" joint="{nm}" name="{nm}"/>')
        else:
            lines.append(f'    <motor gear="{_GEARS[joint]}" joint="{joint}" name="{joint}"/>')
    lines.append("  </actuator>")
    lines.append("</mujoco>")
    return "\n".join(lines)


def to_mjcf_v1_ball(timestep: float = 0.002) -> str:
    """The ball-joint v1 variant of the humanoid as MJCF, byte for byte the
    JAX package's: the bodies, geoms and gears of :func:`to_mjcf`, each
    3-dof hinge stack as one MuJoCo ``ball`` joint with per-axis motors, in
    the v1 parameters (dt 0.002, armature 0.02, damping 5).  For host MuJoCo
    only (the engine is hinge-native).  A ball's range is a cone on the
    total rotation angle: the largest per-axis magnitude of the hinge
    ranges."""
    lines = [
        '<mujoco model="humanoid_tpu_v1_ball">',
        '  <compiler angle="radian" inertiafromgeom="true"/>',
        '  <default>',
        '    <joint limited="true" armature="0.02" damping="5"/>',
        '    <geom conaffinity="1" condim="1" contype="1" margin="0.001"/>',
        '    <motor ctrllimited="true" ctrlrange="-0.5 0.5"/>',
        '  </default>',
        f'  <option integrator="RK4" iterations="50" solver="PGS" '
        f'timestep="{timestep}"/>',
        '  <worldbody>',
        '    <geom condim="3" friction="1 .1 .1" name="floor" pos="0 0 0" '
        'size="50 50 0.2" type="plane"/>',
    ]
    children: dict[str, list[str]] = {}
    for name, parent, pos in _BODIES:
        children.setdefault(parent, []).append(name)
    body_pos = {n: p for n, _, p in _BODIES}

    def fmt(v):
        return " ".join(repr(round(float(x), 9)) for x in v)

    def emit_body(name: str, indent: str):
        lines.append(f'{indent}<body name="{name}" pos="{fmt(body_pos[name])}">')
        if name == "root":
            lines.append(
                f'{indent}  <joint armature="0" damping="0" limited="false" '
                f'name="root" pos="0 0 0" stiffness="0" type="free"/>')
        elif name in _SPHERICAL:
            cone = max(abs(b) for rng in _SPHERICAL[name] for b in rng)
            lines.append(
                f'{indent}  <joint name="{name}" pos="0 0 0" '
                f'range="0 {round(cone, 6)}" type="ball"/>')
        else:
            rng = _REVOLUTE[name]
            lines.append(
                f'{indent}  <joint name="{name}" axis="0 -1 0" pos="0 0 0" '
                f'range="{rng[0]} {rng[1]}" type="hinge"/>')
        for g_name, g_body, g_type, g_mass, spec in _GEOMS:
            if g_body != name:
                continue
            if "fromto" in spec:
                lines.append(
                    f'{indent}  <geom name="{g_name}" type="capsule" '
                    f'mass="{g_mass}" size="{spec["size"][0]}" '
                    f'fromto="{fmt(spec["fromto"])}"/>')
            else:
                tname = {SPHERE: "sphere", BOX: "box"}[g_type]
                size = spec["size"] if g_type == BOX else spec["size"][:1]
                lines.append(
                    f'{indent}  <geom name="{g_name}" type="{tname}" '
                    f'mass="{g_mass}" pos="{fmt(spec["pos"])}" '
                    f'size="{fmt(size)}"/>')
        for child in children.get(name, []):
            emit_body(child, indent + "  ")
        lines.append(f"{indent}</body>")

    emit_body("root", "    ")
    lines.append("  </worldbody>")
    lines.append("  <contact>")
    for b1, b2 in [
        ("right_hip", "root"), ("left_hip", "root"),
        ("right_hip", "right_knee"), ("left_hip", "left_knee"),
        ("right_knee", "right_ankle"), ("left_knee", "left_ankle"),
        ("right_elbow", "right_shoulder"), ("left_elbow", "left_shoulder"),
    ]:
        lines.append(f'    <exclude body1="{b1}" body2="{b2}"/>')
    lines.append("  </contact>")
    lines.append("  <actuator>")
    for joint in _JOINT_ORDER:
        if joint in _SPHERICAL:
            for k, axis_name in enumerate("xyz"):
                gear = [0, 0, 0]
                gear[k] = _GEARS[joint]
                lines.append(
                    f'    <motor gear="{gear[0]} {gear[1]} {gear[2]}" '
                    f'joint="{joint}" name="{joint}_{axis_name}"/>')
        else:
            lines.append(
                f'    <motor gear="{_GEARS[joint]}" joint="{joint}" '
                f'name="{joint}"/>')
    lines.append("  </actuator>")
    lines.append("</mujoco>")
    return "\n".join(lines)


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
