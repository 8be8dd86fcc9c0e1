"""Physics model specification (port of ``deepmimic_mujoco_tpu/physics/
model.py``).

:class:`ModelBuilder` assembles the kinematic tree in numpy (float64) on the
host; :meth:`ModelBuilder.finalize` returns a :class:`PhysicsModel` whose
array fields are float32 / int64 / bool torch tensors on one device.  The
tuple, string and number fields are static metadata that drive Python-level
loops (tree order, per-body hinge lists)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from deepmimic_mujoco_torch.physics import inertia as geom_inertia_mod
from deepmimic_mujoco_torch.physics.inertia import BOX, CAPSULE, SPHERE


@dataclasses.dataclass(frozen=True)
class PhysicsModel:
    """Static physics model.  Tensor fields live on ``device``."""

    # --- tree ---
    body_pos: torch.Tensor       # (nbody, 3) fixed offset in parent frame
    body_quat: torch.Tensor      # (nbody, 4) fixed rotation in parent frame (wxyz)
    body_mass: torch.Tensor      # (nbody,)
    body_com: torch.Tensor       # (nbody, 3) local COM
    body_inertia: torch.Tensor   # (nbody, 3, 3) about COM, body frame
    # --- hinges (all non-root dofs) ---
    hinge_body: torch.Tensor     # (nh,) int64
    hinge_axis: torch.Tensor     # (nh, 3) local axis
    hinge_range: torch.Tensor    # (nh, 2)
    hinge_limited: torch.Tensor  # (nh,) bool
    armature: torch.Tensor       # (nh,)
    damping: torch.Tensor        # (nh,)
    # --- actuators ---
    actuator_hinge: torch.Tensor  # (nu,) int64 hinge index
    actuator_gear: torch.Tensor   # (nu,)
    ctrl_range: torch.Tensor      # (nu, 2)
    # --- geoms ---
    geom_body: torch.Tensor      # (ngeom,) int64
    geom_pos: torch.Tensor       # (ngeom, 3)
    geom_quat: torch.Tensor      # (ngeom, 4)
    geom_size: torch.Tensor      # (ngeom, 3)
    # --- floor-contact candidates (static set) ---
    cand_body: torch.Tensor      # (ncand,) int64
    cand_pos: torch.Tensor       # (ncand, 3) local point
    cand_radius: torch.Tensor    # (ncand,)
    cand_mu: torch.Tensor        # (ncand,)
    # --- dof structure ---
    ancestor_mask: torch.Tensor  # (nbody, nv) 1.0 where dof moves body
    # --- initial state ---
    qpos0: torch.Tensor          # (nq,)
    # --- options ---
    gravity: torch.Tensor        # (3,)
    solref: torch.Tensor         # (2,) timeconst, dampratio
    solimp: torch.Tensor         # (5,) dmin, dmax, width, midpoint, power
    # --- static metadata ---
    parent: tuple = ()
    max_contacts: int = 1 << 30   # top-k cap on simultaneous floor contacts
    max_limits: int = 1 << 30     # top-k cap on simultaneous limit rows
    # M⁻¹: "ns" = Jacobi-scaled Newton–Schulz (batched matmuls) or
    # "cholesky" (a batched Cholesky factor and solves: slower, robust for
    # any SPD M); engine.calibrate_minv_mode measures the NS residual of a
    # model and picks, as the MJCF importer does
    minv_mode: str = "ns"
    # constraint solver: "apgd" (the batched APGD kernels) or "pgs"
    # (sequential projected Gauss–Seidel sweeps, the structure of MuJoCo's
    # PGS: the parity mode for A/B runs against host MuJoCo)
    solver_mode: str = "apgd"
    dt: float = 0.0166
    iterations: int = 50          # cold APGD budget
    warm_iterations: int = 0      # >0: warm-started stage-1 solves at this budget
    solver_dtype: str = "f32"     # storage of the dual matrix A: "f32" | "bf16"
    stage_reuse: str = "none"     # "kin": freeze FK/M⁻¹/contacts/A across RK4 stages
    stage_iterations: int = 0     # budget of RK4 stages 2-4 under stage_reuse="kin"
    # batched APGD kernel layout on CUDA: "blocks" = (B, ne, ne) batch-major
    # (apgd_solve), "lanes" = (ne, ne, B) env axis last (apgd_solve_lanes)
    apgd_layout: str = "blocks"
    integrator: str = "rk4"
    nbody: int = 0
    nq: int = 0
    nv: int = 0
    nhinge: int = 0
    nu: int = 0
    ncand: int = 0
    body_hinges: tuple = ()
    geom_type: tuple = ()
    body_names: tuple = ()
    geom_names: tuple = ()
    hinge_names: tuple = ()

    @property
    def device(self) -> torch.device:
        return self.qpos0.device

    def body_index(self, name: str) -> int:
        return self.body_names.index(name)

    def geom_index(self, name: str) -> int:
        return self.geom_names.index(name)


@dataclasses.dataclass
class _Body:
    name: str
    parent: int
    pos: np.ndarray
    quat: np.ndarray


@dataclasses.dataclass
class _Hinge:
    name: str
    body: int
    axis: np.ndarray
    range: tuple
    limited: bool
    armature: float
    damping: float


@dataclasses.dataclass
class _Geom:
    name: str
    body: int
    gtype: int
    size: np.ndarray
    pos: np.ndarray
    quat: np.ndarray
    mass: float
    friction: np.ndarray


def _quat_to_mat_f32(q) -> np.ndarray:
    """Rotation matrix of a wxyz quaternion, evaluated in float32 as the
    reference builder does (its ``to_mat`` runs in f32)."""
    w, x, y, z = np.asarray(q, np.float32)
    one, two = np.float32(1), np.float32(2)
    m = np.array([
        [one - two * (y * y + z * z), two * (x * y - w * z), two * (x * z + w * y)],
        [two * (x * y + w * z), one - two * (x * x + z * z), two * (y * z - w * x)],
        [two * (x * z - w * y), two * (y * z + w * x), one - two * (x * x + y * y)],
    ], np.float32)
    return m.astype(np.float64)


def _zaxis_quat(fromto: np.ndarray) -> tuple[np.ndarray, np.ndarray, float]:
    """Capsule fromto → (center pos, quat aligning z to segment, half-length)."""
    a, b = fromto[:3], fromto[3:]
    center = 0.5 * (a + b)
    d = b - a
    L = np.linalg.norm(d)
    z = d / L
    v = np.cross([0.0, 0.0, 1.0], z)
    c = np.dot([0.0, 0.0, 1.0], z)
    if np.linalg.norm(v) < 1e-12:
        quat = np.array([1.0, 0, 0, 0]) if c > 0 else np.array([0.0, 1.0, 0, 0])
    else:
        s = np.sqrt((1 + c) * 2)
        quat = np.concatenate([[s / 2], v / s])
        quat = quat / np.linalg.norm(quat)
    return center, quat, L / 2


class ModelBuilder:
    """Programmatic model construction (MJCF-equivalent subset)."""

    def __init__(self, dt: float = 0.0166, integrator: str = "rk4",
                 iterations: int = 50, gravity=(0.0, 0.0, -9.81),
                 max_contacts: int = 1 << 30, max_limits: int = 1 << 30):
        self.max_contacts = max_contacts
        self.max_limits = max_limits
        self.bodies: list[_Body] = []
        self.hinges: list[_Hinge] = []
        self.geoms: list[_Geom] = []
        self.actuators: list[tuple] = []  # (hinge_name, gear, ctrl_lo, ctrl_hi)
        self.dt = dt
        self.integrator = integrator
        self.iterations = iterations
        self.gravity = np.asarray(gravity, np.float64)
        self.solref = np.array([0.02, 1.0])
        self.solimp = np.array([0.9, 0.95, 0.001, 0.5, 2.0])
        self.floor_friction = np.array([1.0, 0.1, 0.1])

    def add_body(self, name: str, parent: Optional[str], pos=(0, 0, 0),
                 quat=(1, 0, 0, 0)) -> int:
        pidx = -1 if parent is None else self.body_index(parent)
        self.bodies.append(_Body(name, pidx, np.asarray(pos, np.float64),
                                 np.asarray(quat, np.float64)))
        return len(self.bodies) - 1

    def body_index(self, name: str) -> int:
        for i, b in enumerate(self.bodies):
            if b.name == name:
                return i
        raise KeyError(name)

    def add_hinge(self, name: str, body: str, axis, range=(0.0, 0.0),
                  limited: bool = True, armature: float = 1.0,
                  damping: float = 1.0) -> int:
        a = np.asarray(axis, np.float64)
        self.hinges.append(_Hinge(name, self.body_index(body),
                                  a / np.linalg.norm(a), tuple(range),
                                  limited, armature, damping))
        return len(self.hinges) - 1

    def add_geom(self, name: str, body: str, gtype: int, mass: float,
                 size=(0.0, 0.0, 0.0), pos=(0, 0, 0), quat=(1, 0, 0, 0),
                 fromto=None, friction=(1.0, 0.005, 0.0001)) -> int:
        size = np.asarray(size, np.float64)
        pos = np.asarray(pos, np.float64)
        quat = np.asarray(quat, np.float64)
        if fromto is not None:
            pos, quat, half_len = _zaxis_quat(np.asarray(fromto, np.float64))
            size = np.array([size[0], half_len, 0.0])
        self.geoms.append(_Geom(name, self.body_index(body), gtype, size,
                                pos, quat, mass, np.asarray(friction)))
        return len(self.geoms) - 1

    def add_motor(self, hinge_name: str, gear: float,
                  ctrl_range=(-0.5, 0.5)) -> None:
        self.actuators.append((hinge_name, gear, ctrl_range[0], ctrl_range[1]))

    def finalize(self, root_pos=(0.0, 0.0, 0.9), root_quat=(1.0, 0.0, 0.0, 0.0),
                 device: torch.device | str = "cpu") -> PhysicsModel:
        nbody = len(self.bodies)
        nh = len(self.hinges)
        nq, nv = 7 + nh, 6 + nh

        # body inertias from geoms (MuJoCo inertiafromgeom)
        body_mass = np.zeros(nbody)
        body_com = np.zeros((nbody, 3))
        body_inertia = np.zeros((nbody, 3, 3))
        for i in range(nbody):
            gs = [g for g in self.geoms if g.body == i]
            if not gs:
                continue
            m, c, inert = geom_inertia_mod.combine_inertia(
                [g.mass for g in gs], [g.pos for g in gs],
                [geom_inertia_mod.geom_inertia(g.gtype, g.size, g.mass)
                 for g in gs],
                [_quat_to_mat_f32(g.quat) for g in gs])
            body_mass[i], body_com[i], body_inertia[i] = m, c, inert

        body_hinges = tuple(
            tuple(j for j, h in enumerate(self.hinges) if h.body == i)
            for i in range(nbody))

        # floor-contact candidates: sphere centre, capsule end centres,
        # box corners
        cand_body, cand_pos, cand_radius, cand_mu = [], [], [], []
        for g in self.geoms:
            mu = float(np.maximum(g.friction, self.floor_friction)[0])
            rot = _quat_to_mat_f32(g.quat)
            if g.gtype == SPHERE:
                pts, r = [g.pos], g.size[0]
            elif g.gtype == CAPSULE:
                h = g.size[1]
                pts = [g.pos + rot @ [0, 0, h], g.pos + rot @ [0, 0, -h]]
                r = g.size[0]
            elif g.gtype == BOX:
                a, b, c = g.size
                pts = [g.pos + rot @ [sx * a, sy * b, sz * c]
                       for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
                r = 0.0
            else:
                continue
            for p in pts:
                cand_body.append(g.body)
                cand_pos.append(p)
                cand_radius.append(r)
                cand_mu.append(mu)

        qpos0 = np.zeros(nq)
        qpos0[0:3] = np.asarray(root_pos)
        rq = np.asarray(root_quat, np.float64)
        qpos0[3:7] = rq / np.linalg.norm(rq)

        # dof d moves body i iff the dof's body is an ancestor-or-self of i;
        # the root free-joint dofs (0..5) move everything
        def ancestors(i: int) -> set:
            out = set()
            while i >= 0:
                out.add(i)
                i = self.bodies[i].parent
            return out

        ancestor_mask = np.zeros((nbody, nv))
        ancestor_mask[:, 0:6] = 1.0
        anc = [ancestors(i) for i in range(nbody)]
        for j, h in enumerate(self.hinges):
            for i in range(nbody):
                if h.body in anc[i]:
                    ancestor_mask[i, 6 + j] = 1.0

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        def i64(x):
            return torch.as_tensor(np.asarray(x, np.int64), device=device)

        return PhysicsModel(
            max_contacts=int(self.max_contacts),
            max_limits=int(self.max_limits),
            parent=tuple(b.parent for b in self.bodies),
            body_pos=f32([b.pos for b in self.bodies]),
            body_quat=f32([b.quat for b in self.bodies]),
            body_mass=f32(body_mass),
            body_com=f32(body_com),
            body_inertia=f32(body_inertia),
            hinge_body=i64([h.body for h in self.hinges]),
            hinge_axis=f32([h.axis for h in self.hinges]),
            hinge_range=f32([h.range for h in self.hinges]),
            hinge_limited=torch.as_tensor(
                np.asarray([h.limited for h in self.hinges], bool),
                device=device),
            armature=f32([h.armature for h in self.hinges]),
            damping=f32([h.damping for h in self.hinges]),
            actuator_hinge=i64([
                next(j for j, h in enumerate(self.hinges) if h.name == nm)
                for nm, _, _, _ in self.actuators]),
            actuator_gear=f32([g for _, g, _, _ in self.actuators]),
            ctrl_range=f32([[lo, hi] for _, _, lo, hi in self.actuators]),
            geom_body=i64([g.body for g in self.geoms]),
            geom_pos=f32([g.pos for g in self.geoms]),
            geom_quat=f32([g.quat for g in self.geoms]),
            geom_size=f32([g.size for g in self.geoms]),
            cand_body=i64(cand_body),
            cand_pos=f32(cand_pos),
            cand_radius=f32(cand_radius),
            cand_mu=f32(cand_mu),
            ancestor_mask=f32(ancestor_mask),
            qpos0=f32(qpos0),
            gravity=f32(self.gravity),
            solref=f32(self.solref),
            solimp=f32(self.solimp),
            dt=float(self.dt),
            iterations=int(self.iterations),
            integrator=self.integrator,
            nbody=nbody, nq=nq, nv=nv, nhinge=nh,
            nu=len(self.actuators), ncand=len(cand_body),
            body_hinges=body_hinges,
            geom_type=tuple(g.gtype for g in self.geoms),
            body_names=tuple(b.name for b in self.bodies),
            geom_names=tuple(g.name for g in self.geoms),
            hinge_names=tuple(h.name for h in self.hinges),
        )
