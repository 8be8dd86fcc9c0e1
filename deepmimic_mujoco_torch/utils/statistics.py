"""TensorBoard scalar stats (port of
``deepmimic_mujoco_tpu/utils/statistics.py``, the reference's ``stats``
class): named scalar summaries written per step, a row holding a NaN or
None skipped.

The JAX package writes through TensorFlow's summary writer when TensorFlow
can be imported; the port writes through
``torch.utils.tensorboard.SummaryWriter`` (``simple_value`` scalars) when
the ``tensorboard`` package can be imported, and otherwise JAX's JSONL
fallback: ``<logdir>/<int(time)>/stats.jsonl``, one line
``{"step": s, key: value, ...}`` per row."""

from __future__ import annotations

import json
import math
import os
import tempfile
import time
from typing import Sequence


class Stats:
    def __init__(self, scalar_keys: Sequence[str] = (),
                 logdir: str | None = None):
        self.scalar_keys = list(scalar_keys)
        if logdir is None:
            logdir = os.path.join(tempfile.gettempdir(), "experiments")
        path = os.path.join(logdir, str(int(time.time())))
        os.makedirs(path, exist_ok=True)
        self._writer = None
        self._jsonl = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self._jsonl = open(os.path.join(path, "stats.jsonl"), "a")
        else:
            self._writer = SummaryWriter(log_dir=path)

    def add_all_summary(self, values: Sequence[float], step: int) -> None:
        """One scalar per key at ``step``; nothing when any value is None
        or a float NaN."""
        if any((v is None) or (isinstance(v, float) and math.isnan(v))
               for v in values):
            return
        if self._writer is not None:
            for k, v in zip(self.scalar_keys, values):
                self._writer.add_scalar(k, float(v), step)
            self._writer.flush()
        else:
            self._jsonl.write(json.dumps(
                {"step": step,
                 **{k: float(v) for k, v in zip(self.scalar_keys, values)}}
            ) + "\n")
            self._jsonl.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
        else:
            self._jsonl.close()


# the reference's name
stats = Stats
