"""Build of the port's CUDA sources: ``nvcc`` into a shared library with a
plain C interface, loaded with :mod:`ctypes`.

A source is compiled at first use into ``deepmimic_mujoco_torch/_build/``
(listed in ``.gitignore``) under a name that carries the hash of the source
and the flags, and is reused while that hash is unchanged.  The library is
written under a temporary name and renamed into place, so concurrent
builders never see a half-written file and no lock file is left behind."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import NamedTuple

CSRC = os.path.join(os.path.dirname(__file__), "csrc")
BUILD_DIR = os.path.normpath(
    os.path.join(os.path.dirname(__file__), "..", "_build"))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class Built(NamedTuple):
    path: str       # the shared library
    log: str        # nvcc's output (``-Xptxas -v``: registers, spills)
    seconds: float  # compile time of this call, 0.0 when reused


def nvcc_path() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise FileNotFoundError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin)")
    return nvcc


def build(name: str) -> Built:
    """Compile ``csrc/<name>.cu`` unless a library of the same source and
    flags exists; raise ``RuntimeError`` with nvcc's output if it fails."""
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode())
    tag = digest.hexdigest()[:16]
    lib = os.path.join(BUILD_DIR, f"lib{name}_{tag}.so")
    log_path = lib[:-3] + ".log"
    if os.path.exists(lib) and os.path.exists(log_path):
        with open(log_path) as fh:
            return Built(lib, fh.read(), 0.0)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed on {src}:\n{log}")
    with open(log_path + f".{os.getpid()}.tmp", "w") as fh:
        fh.write(log)
    os.replace(log_path + f".{os.getpid()}.tmp", log_path)
    os.replace(tmp, lib)
    return Built(lib, log, seconds)


def load(name: str) -> tuple[ctypes.CDLL, Built]:
    """Build (or reuse) and load ``csrc/<name>.cu``."""
    built = build(name)
    return ctypes.CDLL(built.path), built
