"""Bundled motion clips: the repository's ``assets/motions/*.npz``."""

from __future__ import annotations

import os

from deepmimic_mujoco_torch.mocap.loader import MocapClip, load_npz

ASSET_DIR = os.path.normpath(
    os.path.join(os.path.dirname(__file__), "..", "..", "assets", "motions"))


def clip_path(name: str) -> str:
    if not name.startswith("humanoid3d_"):
        name = "humanoid3d_" + name
    return os.path.join(ASSET_DIR, name + ".npz")


def get_clip(name: str) -> MocapClip:
    path = clip_path(name)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no bundled clip {name!r} at {path}")
    return load_npz(path)
