"""Tabular logger (port of ``deepmimic_mujoco_tpu/utils/logger.py``, the
baselines-style logger of the reference): key/value records per iteration,
dumped to stdout as a table (``stdout``), to ``log.txt`` (``log``), to a
CSV whose header grows with new keys (``csv``, ``progress.csv``) and to JSON
lines (``json``, ``progress.json``).  TensorBoard output is not ported
(ROADMAP.md queue A, item 9)."""

from __future__ import annotations

import json
import os
import sys
from typing import Optional


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


def make_output_format(fmt: str, ev_dir: str):
    os.makedirs(ev_dir, exist_ok=True)
    if fmt == "stdout":
        return HumanOutputFormat(sys.stdout)
    if fmt == "log":
        return HumanOutputFormat(os.path.join(ev_dir, "log.txt"))
    if fmt == "json":
        return JSONOutputFormat(os.path.join(ev_dir, "progress.json"))
    if fmt == "csv":
        return CSVOutputFormat(os.path.join(ev_dir, "progress.csv"))
    raise ValueError(f"Unknown format {fmt!r}")


class Logger:
    CURRENT: Optional["Logger"] = None

    def __init__(self, dir: Optional[str], output_formats: list):
        self.name2val: dict = {}
        self.dir = dir
        self.output_formats = output_formats

    def logkv(self, key: str, val) -> None:
        self.name2val[key] = val

    def dumpkvs(self) -> None:
        for fmt in self.output_formats:
            fmt.writekvs(self.name2val)
        self.name2val.clear()

    def log(self, *args) -> None:
        for fmt in self.output_formats:
            if isinstance(fmt, HumanOutputFormat):
                fmt.writeseq(map(str, args))

    def close(self) -> None:
        for fmt in self.output_formats:
            fmt.close()


def configure(dir: str, format_strs=None) -> Logger:
    """Log to ``dir`` in ``format_strs`` (default stdout, log, csv); closes
    the files of the logger this replaces."""
    os.makedirs(dir, exist_ok=True)
    if format_strs is None:
        format_strs = ["stdout", "log", "csv"]
    if Logger.CURRENT is not None:
        Logger.CURRENT.close()
    Logger.CURRENT = Logger(dir, [make_output_format(f, dir)
                                  for f in format_strs])
    log(f"Logging to {dir}")
    return Logger.CURRENT


def _get() -> Logger:
    if Logger.CURRENT is None:
        Logger.CURRENT = Logger(None, [HumanOutputFormat(sys.stdout)])
    return Logger.CURRENT


def record_tabular(key: str, val) -> None:
    _get().logkv(key, val)


def dump_tabular() -> None:
    _get().dumpkvs()


def log(*args) -> None:
    _get().log(*args)
