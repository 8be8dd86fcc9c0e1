"""Console helpers (port of ``deepmimic_mujoco_tpu/utils/console.py``, the
reference's ``console_util``): ANSI colours, fixed-width table rows and a
phase timer that prints its wall time."""

from __future__ import annotations

import time
from contextlib import contextmanager

color2num = dict(gray=30, red=31, green=32, yellow=33, blue=34,
                 magenta=35, cyan=36, white=37, crimson=38)


def colorize(string: str, color: str, bold: bool = False,
             highlight: bool = False) -> str:
    attr = []
    num = color2num[color]
    if highlight:
        num += 10
    attr.append(str(num))
    if bold:
        attr.append("1")
    return f"\x1b[{';'.join(attr)}m{string}\x1b[0m"


def fmt_row(width: int, row, header: bool = False) -> str:
    def fmt_item(x):
        if hasattr(x, "__float__"):
            v = float(x)
            rep = f"{v:8.3g}" if abs(v) < 1e4 else f"{v:8.1e}"
        else:
            rep = str(x)
        return rep.ljust(width)

    out = " | ".join(fmt_item(x) for x in row)
    if header:
        out = out + "\n" + "-" * len(out)
    return out


@contextmanager
def timed(msg: str, verbose: bool = True):
    """Prints ``msg``, runs the block and prints its wall time.  Work
    queued on a card is not waited for: synchronize inside the block to
    time it."""
    if verbose:
        print(colorize(msg, color="magenta"))
        tstart = time.time()
        yield
        print(colorize(f"done in {time.time() - tstart:.3f} seconds",
                       color="magenta"))
    else:
        yield
