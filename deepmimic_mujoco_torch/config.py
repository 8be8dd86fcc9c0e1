"""The global experiment config (port of ``deepmimic_mujoco_tpu/config.py``):
the reference's static ``Config`` selector — one motion every env trains
on — with the clip path resolved through the port's registry.  The motion
comes from the ``DMTPU_MOTION`` environment variable (default walk) or
:func:`set_motion`."""

from __future__ import annotations

import os

from deepmimic_mujoco_torch.mocap import registry


class Config:
    all_motions = list(registry.SKILLS)
    curr_path = os.path.dirname(os.path.abspath(__file__))
    motion = os.environ.get("DMTPU_MOTION", "walk")
    env_name = "dp_env_v3"

    @classmethod
    def motion_name(cls) -> str:
        return f"humanoid3d_{cls.motion}"

    @classmethod
    def mocap_path(cls) -> str:
        return registry.clip_path(cls.motion_name())


def set_motion(name: str) -> None:
    if name.startswith("humanoid3d_"):
        name = name[len("humanoid3d_"):]
    if name not in Config.all_motions:
        raise ValueError(f"unknown motion {name!r}")
    Config.motion = name
