"""Tabular logger (port of ``deepmimic_mujoco_tpu/utils/logger.py``, the
baselines-style logger of the reference): key/value records per iteration,
dumped to stdout as a table (``stdout``), to ``log.txt`` (``log``), to a
CSV whose header grows with new keys (``csv``, ``progress.csv``), to JSON
lines (``json``, ``progress.json``) and to TensorBoard scalars
(``tensorboard``, ``tb/`` through ``utils/statistics.Stats``); plus the
``wait_<scope>`` wall-time keys of ``profile_kv``.

``configure`` reads ``DMTPU_LOGDIR``/``OPENAI_LOGDIR`` and
``DMTPU_LOG_FORMAT``/``OPENAI_LOG_FORMAT`` as the JAX package's does."""

from __future__ import annotations

import contextlib
import datetime
import json
import math
import os
import sys
import tempfile
import time
from collections import defaultdict
from typing import Optional

DEBUG, INFO, WARN, ERROR, DISABLED = 10, 20, 30, 40, 50


class HumanOutputFormat:
    def __init__(self, filename_or_file):
        if isinstance(filename_or_file, str):
            self.file = open(filename_or_file, "wt")
            self.own_file = True
        else:
            self.file = filename_or_file
            self.own_file = False

    def writekvs(self, kvs: dict) -> None:
        key2str = {}
        for key, val in sorted(kvs.items()):
            valstr = f"{val:<8.3g}" if hasattr(val, "__float__") else str(val)
            key2str[self._trunc(key)] = self._trunc(valstr)
        if not key2str:
            return
        keywidth = max(map(len, key2str.keys()))
        valwidth = max(map(len, key2str.values()))
        dashes = "-" * (keywidth + valwidth + 7)
        lines = [dashes]
        for key, val in sorted(key2str.items()):
            lines.append(f"| {key}{' ' * (keywidth - len(key))} | "
                         f"{val}{' ' * (valwidth - len(val))} |")
        lines.append(dashes)
        self.file.write("\n".join(lines) + "\n")
        self.file.flush()

    @staticmethod
    def _trunc(s: str) -> str:
        return s[:20] + "..." if len(s) > 23 else s

    def writeseq(self, seq) -> None:
        self.file.write(" ".join(map(str, seq)) + "\n")
        self.file.flush()

    def close(self) -> None:
        if self.own_file:
            self.file.close()


class JSONOutputFormat:
    def __init__(self, filename: str):
        self.file = open(filename, "wt")

    def writekvs(self, kvs: dict) -> None:
        out = {k: float(v) if hasattr(v, "dtype") else v
               for k, v in kvs.items()}
        self.file.write(json.dumps(out) + "\n")
        self.file.flush()

    def close(self) -> None:
        self.file.close()


class CSVOutputFormat:
    """CSV whose header is rewritten when new keys appear."""

    def __init__(self, filename: str):
        self.file = open(filename, "w+t")
        self.keys: list = []

    def writekvs(self, kvs: dict) -> None:
        extra_keys = [k for k in kvs if k not in self.keys]
        if extra_keys:
            self.keys.extend(extra_keys)
            self.file.seek(0)
            lines = self.file.readlines()
            self.file.seek(0)
            self.file.write(",".join(self.keys) + "\n")
            for line in lines[1:]:
                self.file.write(line[:-1] + "," * len(extra_keys) + "\n")
        self.file.write(",".join(
            "" if kvs.get(k) is None else str(kvs.get(k)) for k in self.keys
        ) + "\n")
        self.file.flush()

    def close(self) -> None:
        self.file.close()


def make_output_format(fmt: str, ev_dir: str, log_suffix: str = ""):
    os.makedirs(ev_dir, exist_ok=True)
    if fmt == "stdout":
        return HumanOutputFormat(sys.stdout)
    if fmt == "log":
        return HumanOutputFormat(os.path.join(ev_dir, f"log{log_suffix}.txt"))
    if fmt == "json":
        return JSONOutputFormat(
            os.path.join(ev_dir, f"progress{log_suffix}.json"))
    if fmt == "csv":
        return CSVOutputFormat(
            os.path.join(ev_dir, f"progress{log_suffix}.csv"))
    if fmt == "tensorboard":
        return TensorBoardOutputFormat(
            os.path.join(ev_dir, f"tb{log_suffix}"))
    raise ValueError(f"Unknown format {fmt!r}")


class TensorBoardOutputFormat:
    """One scalar per key and row through ``utils/statistics.Stats``, at a
    step that counts the rows written.  A non-finite or non-numeric value
    is dropped on its own (``Stats`` would skip the whole row for one NaN,
    e.g. EpLenMean before the first episode ends)."""

    def __init__(self, dirname: str):
        from deepmimic_mujoco_torch.utils.statistics import Stats

        self._stats = Stats([], logdir=dirname)
        self._step = 0

    def writekvs(self, kvs: dict) -> None:
        numeric = {k: v for k, v in sorted(kvs.items())
                   if isinstance(v, (int, float)) and math.isfinite(v)}
        self._stats.scalar_keys = list(numeric.keys())
        self._stats.add_all_summary(list(numeric.values()), self._step)
        self._step += 1

    def close(self) -> None:
        self._stats.close()


class Logger:
    CURRENT: Optional["Logger"] = None

    def __init__(self, dir: Optional[str], output_formats: list):
        self.name2val: dict = defaultdict(float)
        self.name2cnt: dict = defaultdict(int)
        self.level = INFO
        self.dir = dir
        self.output_formats = output_formats

    def logkv(self, key: str, val) -> None:
        self.name2val[key] = val

    def logkv_mean(self, key: str, val) -> None:
        """The running mean of the values logged under ``key`` since the
        last dump."""
        oldval, cnt = self.name2val[key], self.name2cnt[key]
        self.name2val[key] = oldval * cnt / (cnt + 1) + val / (cnt + 1)
        self.name2cnt[key] = cnt + 1

    def dumpkvs(self) -> None:
        if self.level == DISABLED:
            return
        for fmt in self.output_formats:
            fmt.writekvs(self.name2val)
        self.name2val.clear()
        self.name2cnt.clear()

    def log(self, *args, level: int = INFO) -> None:
        if self.level <= level:
            for fmt in self.output_formats:
                if isinstance(fmt, HumanOutputFormat):
                    fmt.writeseq(map(str, args))

    def set_level(self, level: int) -> None:
        self.level = level

    def get_dir(self) -> Optional[str]:
        return self.dir

    def close(self) -> None:
        for fmt in self.output_formats:
            fmt.close()


def configure(dir: Optional[str] = None, format_strs=None,
              log_suffix: str = "") -> Logger:
    """Log to ``dir`` (default ``$DMTPU_LOGDIR``, ``$OPENAI_LOGDIR``, else a
    new dated directory under the temporary directory) in ``format_strs``
    (default ``$DMTPU_LOG_FORMAT`` or ``$OPENAI_LOG_FORMAT``, comma
    separated, else stdout, log and csv); closes the files of the logger
    this replaces."""
    if dir is None:
        dir = os.getenv("DMTPU_LOGDIR") or os.getenv("OPENAI_LOGDIR")
    if dir is None:
        dir = os.path.join(
            tempfile.gettempdir(),
            datetime.datetime.now().strftime("dmtpu-%Y-%m-%d-%H-%M-%S-%f"))
    os.makedirs(dir, exist_ok=True)
    if format_strs is None:
        strs = os.getenv("DMTPU_LOG_FORMAT") or os.getenv("OPENAI_LOG_FORMAT")
        format_strs = strs.split(",") if strs else ["stdout", "log", "csv"]
    if Logger.CURRENT is not None:
        Logger.CURRENT.close()
    Logger.CURRENT = Logger(dir, [make_output_format(f, dir, log_suffix)
                                  for f in format_strs])
    log(f"Logging to {dir}")
    return Logger.CURRENT


def _get() -> Logger:
    if Logger.CURRENT is None:
        Logger.CURRENT = Logger(None, [HumanOutputFormat(sys.stdout)])
    return Logger.CURRENT


def logkv(key: str, val) -> None:
    _get().logkv(key, val)


def logkv_mean(key: str, val) -> None:
    _get().logkv_mean(key, val)


def record_tabular(key: str, val) -> None:
    logkv(key, val)


def dump_tabular() -> None:
    _get().dumpkvs()


def dumpkvs() -> None:
    _get().dumpkvs()


def log(*args, level: int = INFO) -> None:
    _get().log(*args, level=level)


def set_level(level: int) -> None:
    _get().set_level(level)


def get_dir() -> Optional[str]:
    return _get().get_dir()


@contextlib.contextmanager
def profile_kv(scopename: str):
    """Adds the block's wall time to the key ``wait_<scopename>``."""
    logkey = "wait_" + scopename
    tstart = time.time()
    try:
        yield
    finally:
        _get().name2val[logkey] += time.time() - tstart


def profile(n: str):
    """Decorator: :func:`profile_kv` around every call."""
    def decorator_with_name(func):
        def func_wrapper(*args, **kwargs):
            with profile_kv(n):
                return func(*args, **kwargs)

        return func_wrapper

    return decorator_with_name


@contextlib.contextmanager
def timed(msg: str, enabled: bool = True, color: str = "\033[35m"):
    """Phase timer printing to stdout.  Work queued on a card is not waited
    for: synchronize inside the block to time it."""
    if enabled:
        print(f"{color}{msg}\033[0m")
        t = time.time()
        yield
        print(f"{color}done in {time.time() - t:.3f} seconds\033[0m")
    else:
        yield
