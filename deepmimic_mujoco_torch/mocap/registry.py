"""Bundled motion clips: the repository's ``assets/motions/*.npz`` (port of
``deepmimic_mujoco_tpu/mocap/registry.py``: the skill list, the clip paths,
``available_clips`` and the cached ``get_clip``)."""

from __future__ import annotations

import functools
import os

from deepmimic_mujoco_torch.mocap.loader import MocapClip, load_npz

ASSET_DIR = os.path.normpath(
    os.path.join(os.path.dirname(__file__), "..", "..", "assets", "motions"))

SKILLS = [
    "backflip", "cartwheel", "crawl", "dance_a", "dance_b",
    "getup_facedown", "getup_faceup", "jump", "kick", "punch",
    "roll", "run", "spin", "spinkick", "walk",
]


def clip_path(name: str) -> str:
    if not name.startswith("humanoid3d_"):
        name = "humanoid3d_" + name
    return os.path.join(ASSET_DIR, name + ".npz")


def available_clips() -> list[str]:
    """The bundled clips' file names without ``.npz`` (``humanoid3d_``
    prefix included), sorted."""
    if not os.path.isdir(ASSET_DIR):
        return []
    return sorted(os.path.splitext(f)[0] for f in os.listdir(ASSET_DIR)
                  if f.endswith(".npz"))


@functools.lru_cache(maxsize=None)
def get_clip(name: str) -> MocapClip:
    path = clip_path(name)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no bundled clip {name!r} at {path}; "
                                f"available: {available_clips()}")
    return load_npz(path)
