"""The fall-contact body list of the DeepMimic arg files (port of
``load_fall_contact_bodies`` and ``DEFAULT_FALL_CONTACT_BODIES`` of
``deepmimic_mujoco_tpu/envs/deepmimic_surface.py``; the 197-D surface env
of that module is not ported)."""

from __future__ import annotations

import os

# fall-contact body indices (into mocap.constants.BODY_DEFS) when no arg
# file exists: every body except the ankles (5, 11), the list carried by
# all train_humanoid3d_*_args.txt files
DEFAULT_FALL_CONTACT_BODIES = (0, 1, 2, 3, 4, 6, 7, 8, 9, 10, 12, 13, 14)

_ARGS_DIR = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "assets", "args"))


def load_fall_contact_bodies(clip_name: str) -> tuple:
    """``--fall_contact_bodies`` of ``assets/args/train_humanoid3d_<clip>_
    args.txt``.  Precedence: ``--enable_char_contact_fall false`` gives
    ``()`` (the floor-borne skills); an arg file without a body list gives
    ``()``; a missing arg file gives :data:`DEFAULT_FALL_CONTACT_BODIES`."""
    short = clip_name.replace("humanoid3d_", "")
    path = os.path.join(_ARGS_DIR, f"train_humanoid3d_{short}_args.txt")
    try:
        with open(path) as f:
            toks = f.read().split()
    except OSError:
        return DEFAULT_FALL_CONTACT_BODIES
    if "--enable_char_contact_fall" in toks:
        i = toks.index("--enable_char_contact_fall")
        if i + 1 < len(toks) and toks[i + 1].lower() == "false":
            return ()
    if "--fall_contact_bodies" not in toks:
        return ()
    out = []
    for t in toks[toks.index("--fall_contact_bodies") + 1:]:
        if t.startswith("--"):
            break
        out.append(int(t))
    return tuple(out)
