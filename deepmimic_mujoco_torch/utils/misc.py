"""Misc utilities (port of ``deepmimic_mujoco_tpu/utils/misc.py``, the
reference's ``misc_util``)."""

from __future__ import annotations

import random

import numpy as np


def zipsame(*seqs):
    """zip() that asserts equal lengths."""
    length = len(seqs[0])
    assert all(len(seq) == length for seq in seqs[1:])
    return zip(*seqs)


def set_global_seeds(seed: int) -> None:
    """Seed numpy's and Python's global generators.  torch's global
    generator is left alone: the port's randomness goes through explicit
    ``torch.Generator`` objects that the caller seeds and passes."""
    np.random.seed(seed)
    random.seed(seed)


def boolean_flag(parser, name: str, default: bool = False, help: str = ""):
    """Add --name / --no-name flags."""
    dest = name.replace("-", "_")
    parser.add_argument(
        "--" + name, action="store_true", default=default, dest=dest,
        help=help)
    parser.add_argument("--no-" + name, action="store_false", dest=dest)


class EzPickle:
    """Pickles an object as its constructor's arguments."""

    def __init__(self, *args, **kwargs):
        self._ezpickle_args = args
        self._ezpickle_kwargs = kwargs

    def __getstate__(self):
        return {"_ezpickle_args": self._ezpickle_args,
                "_ezpickle_kwargs": self._ezpickle_kwargs}

    def __setstate__(self, d):
        out = type(self)(*d["_ezpickle_args"], **d["_ezpickle_kwargs"])
        self.__dict__.update(out.__dict__)
