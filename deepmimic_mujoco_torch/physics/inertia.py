"""Geom mass→inertia computation, MuJoCo ``inertiafromgeom`` (numpy copy of
``deepmimic_mujoco_tpu/physics/inertia.py``).  Sizes are MuJoCo half-sizes.
"""

from __future__ import annotations

import numpy as np

SPHERE, CAPSULE, BOX, PLANE = 0, 1, 2, 3


def geom_inertia(gtype: int, size: np.ndarray, mass: float) -> np.ndarray:
    """Diagonal inertia (3,) of a geom about its own COM, in geom frame
    (z = symmetry axis for capsule)."""
    if gtype == SPHERE:
        r = size[0]
        i = 0.4 * mass * r * r
        return np.array([i, i, i])
    if gtype == CAPSULE:
        r, h = size[0], size[1]  # radius, cylinder half-length
        v_cyl = np.pi * r * r * (2 * h)
        v_sph = (4.0 / 3.0) * np.pi * r ** 3
        m_cyl = mass * v_cyl / (v_cyl + v_sph)
        m_sph = mass * v_sph / (v_cyl + v_sph)
        iz = 0.5 * m_cyl * r * r + 0.4 * m_sph * r * r
        ix = (
            m_cyl * (r * r / 4.0 + h * h / 3.0)
            + m_sph * (0.4 * r * r + h * h + 0.75 * h * r)
        )
        return np.array([ix, ix, iz])
    if gtype == BOX:
        a, b, c = size[:3]
        return (mass / 3.0) * np.array([b * b + c * c, a * a + c * c, a * a + b * b])
    raise ValueError(f"no inertia for geom type {gtype}")


def combine_inertia(
    masses: list[float],
    coms: list[np.ndarray],
    inertias: list[np.ndarray],
    rots: list[np.ndarray],
) -> tuple[float, np.ndarray, np.ndarray]:
    """Combine several geom inertias into one body inertia.

    Parameters: per-geom mass, COM position in body frame, diagonal inertia in
    geom frame, and geom→body rotation matrix.  Returns (total mass, body COM,
    3x3 inertia about the body COM in body frame).
    """
    m_tot = float(sum(masses))
    com = sum(m * c for m, c in zip(masses, coms)) / m_tot
    I_tot = np.zeros((3, 3))
    for m, c, i_diag, rot in zip(masses, coms, inertias, rots):
        I_g = rot @ np.diag(i_diag) @ rot.T  # inertia in body-frame axes
        d = c - com
        # parallel axis theorem
        I_tot += I_g + m * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
    return m_tot, com, I_tot
