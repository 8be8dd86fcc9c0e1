#!/usr/bin/env python3
"""Import DeepMimic JSON motion clips (``{"Loop": ..., "Frames": [...]}`` in
``.txt`` or ``.json`` files) into ``.npz`` bundles (port of
``tools/import_motions.py``):

    python -m deepmimic_mujoco_torch.cli.import_motions <dirs or files...> \\
        [--out assets/motions]

A bundle holds the raw frames, the loop flag and the clip's name (the file's
base name); conversion re-runs when ``mocap.loader.load_npz`` reads it.
Each clip is converted once on the way (``load_deepmimic_json``), so a file
the loader cannot read is refused here."""

from __future__ import annotations

import argparse
import glob
import os

from deepmimic_mujoco_torch.mocap.loader import load_deepmimic_json

MOTIONS = os.path.normpath(os.path.join(os.path.dirname(__file__), "..", "..",
                                        "assets", "motions"))


def clip_files(sources) -> list:
    """The clip files of ``sources``: a directory gives its ``*.txt`` then
    its ``*.json`` files, sorted; a file is taken as it is."""
    files = []
    for src in sources:
        if os.path.isdir(src):
            files += sorted(glob.glob(os.path.join(src, "*.txt")))
            files += sorted(glob.glob(os.path.join(src, "*.json")))
        else:
            files.append(src)
    return files


def main(argv=None) -> list:
    """Writes one bundle per clip; returns their paths."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("sources", nargs="+",
                   help="files or directories of DeepMimic JSON clips")
    p.add_argument("--out", default=MOTIONS)
    args = p.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    written = []
    for f in clip_files(args.sources):
        clip = load_deepmimic_json(f)
        out = os.path.join(args.out, clip.name + ".npz")
        clip.save_npz(out)
        written.append(out)
        print(f"{clip.name}: {clip.raw_frames.shape[0]} frames x "
              f"{clip.raw_frames.shape[1]} -> {out}")
    return written


if __name__ == "__main__":
    main()
