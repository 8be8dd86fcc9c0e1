#!/usr/bin/env python3
"""Generate the spec assets (port of ``tools/gen_assets.py``): the DeepMimic
character and controller JSON of the humanoid (``physics/
deepmimic_character.export_character``), the PPO agent spec
(``dp_policy/ppo_agent.DEFAULT_SPEC``), the train and run arg files of the
15 skills and the plane terrain, under ``--out`` (default: the repository's
``assets/``).  The reference ships these as data files (``data/
characters/humanoid3d.txt``, ``data/controllers/humanoid3d_ctrl.txt``,
``data/agents/ct_agent_humanoid_ppo.txt``, ``args/*.txt``).  Run after
changing the model or hyperparameter tables:

    python -m deepmimic_mujoco_torch.cli.gen_assets [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import os

ASSETS = os.path.normpath(os.path.join(os.path.dirname(__file__), "..", "..",
                                       "assets"))

SKILLS = [
    "backflip", "cartwheel", "crawl", "dance_a", "dance_b",
    "getup_facedown", "getup_faceup", "jump", "kick", "punch",
    "roll", "run", "spin", "spinkick", "walk",
]

# the contact-fall lines per skill (the reference's src/args/): floor-borne
# skills never end on contact (getup_*, roll turn contact falls off), crawl
# allows everything but root, chest and neck; the upright skills take the
# full list.  JAX's tools/gen_assets.py writes no line for getup_* and roll;
# the committed arg files, which the surface env reads, carry it.
_NO_FALL = "--enable_char_contact_fall false\n"
FALL_LINES = {
    "getup_facedown": _NO_FALL, "getup_faceup": _NO_FALL, "roll": _NO_FALL,
    "crawl": "--fall_contact_bodies 0 1 2\n",
}
DEFAULT_FALL = "--fall_contact_bodies 0 1 2 3 4 6 7 8 9 10 12 13 14\n"

_SCENE = """\
--scene imitate

--num_update_substeps 10
--num_sim_substeps 2
--world_scale 4

--terrain_file assets/terrain/plane.json
--char_types general
--character_files assets/characters/humanoid3d.json
--enable_char_soft_contact false
{fall}
--char_ctrls ct_pd
--char_ctrl_files assets/controllers/humanoid3d_ctrl.json
--motion_file assets/motions/humanoid3d_{skill}.npz
--sync_char_root_pos true
--sync_char_root_rot false

--agent_files assets/agents/ct_agent_humanoid_ppo.json
"""
_TRAIN_TAIL = """\
--train_agents true

--output_path output
--int_output_path output/intermediate
"""
_RUN_TAIL = """\
--train_agents false

--model_files none
"""


def arg_files(skill: str) -> tuple[str, str]:
    """(train, run) arg files of a skill: the original DeepMimic
    ``--key value`` scene configs (``args/{train,run}_humanoid3d_<skill>_
    args.txt``); only the train file carries the contact-fall line."""
    fall = FALL_LINES.get(skill, DEFAULT_FALL)
    return (_SCENE.format(fall=fall, skill=skill) + _TRAIN_TAIL,
            _SCENE.format(fall="", skill=skill) + _RUN_TAIL)


def _write(path: str, text: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)


def main(argv=None) -> list:
    """Writes the assets; returns the paths written."""
    from deepmimic_mujoco_torch.dp_policy.ppo_agent import DEFAULT_SPEC
    from deepmimic_mujoco_torch.physics.deepmimic_character import (
        export_character,
    )

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default=ASSETS)
    args = p.parse_args(argv)

    character, controller = export_character()
    files = {
        ("characters", "humanoid3d.json"): json.dumps(character, indent=2),
        ("controllers", "humanoid3d_ctrl.json"): json.dumps(controller,
                                                            indent=2),
        ("agents", "ct_agent_humanoid_ppo.json"): json.dumps(DEFAULT_SPEC,
                                                             indent=2),
    }
    for skill in SKILLS:
        train, run = arg_files(skill)
        files["args", f"train_humanoid3d_{skill}_args.txt"] = train
        files["args", f"run_humanoid3d_{skill}_args.txt"] = run
    # the terrain spec (the reference's data/terrain/plane.txt)
    files["terrain", "plane.json"] = json.dumps({"Type": "plane"})
    written = []
    for parts, text in files.items():
        path = os.path.join(args.out, *parts)
        _write(path, text)
        written.append(path)
    n = sum(len(fs) for _, _, fs in os.walk(args.out))
    print(f"assets generated under {args.out} ({n} files)")
    return written


if __name__ == "__main__":
    main()
