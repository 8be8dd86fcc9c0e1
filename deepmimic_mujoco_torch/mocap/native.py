"""ctypes bindings for the native (C++) mocap ingestion library (port of
``deepmimic_mujoco_tpu/mocap/native.py``).

``native/dmtpu_mocap.cpp`` implements the clip JSON parser and the
frame → qpos/qvel conversion with the loader's semantics: a batch importer,
and an oracle independent of the Python pipeline.  At first use it is
compiled with g++ (``native/Makefile``'s flags) into ``BUILD_DIR``
(``deepmimic_mujoco_torch/_build/``, git-ignored) under a name that carries
the hash of the source and the flags; ``native/`` itself is never written.
Every entry point raises :class:`NativeUnavailable` when the library cannot
be built; the Python loader (``mocap/loader.py``) does not need it."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

from deepmimic_mujoco_torch.mocap.loader import MocapClip
from deepmimic_mujoco_torch.ops._build import BUILD_DIR

SOURCE = os.path.normpath(os.path.join(
    os.path.dirname(__file__), "..", "..", "native", "dmtpu_mocap.cpp"))
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-shared")
MAX_FRAMES = 64 * 1024      # parse_clip's buffer, as in JAX's binding
WIDTH = 44                  # values per frame

_lib: Optional[ctypes.CDLL] = None


class NativeUnavailable(RuntimeError):
    pass


def _build() -> str:
    """The library's path, compiled unless a build of the same source and
    flags is in ``BUILD_DIR`` (written under a temporary name, then
    renamed into place)."""
    try:
        with open(SOURCE, "rb") as fh:
            digest = hashlib.sha256(fh.read() + " ".join(CXX_FLAGS).encode())
    except OSError as e:
        raise NativeUnavailable(f"no source at {SOURCE}: {e}") from e
    lib = os.path.join(BUILD_DIR,
                       f"libdmtpu_mocap_{digest.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    try:
        subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp,
                        SOURCE], check=True, capture_output=True, text=True,
                       timeout=300)
    except FileNotFoundError as e:
        raise NativeUnavailable(f"no C++ compiler: {e}") from e
    except subprocess.CalledProcessError as e:
        raise NativeUnavailable(
            f"g++ failed on {SOURCE}:\n{e.stdout}{e.stderr}") from e
    os.replace(tmp, lib)
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(_build())
    lib.dmtpu_convert_frames.restype = ctypes.c_int
    lib.dmtpu_convert_frames.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double)]
    lib.dmtpu_parse_clip.restype = ctypes.c_int64
    lib.dmtpu_parse_clip.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int64]
    _lib = lib
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except NativeUnavailable:
        return False


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def convert_frames(frames: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(T, 44) raw frames → (qpos (T, 35), qvel (T, 34)), in C++."""
    lib = _load()
    frames = np.ascontiguousarray(frames, np.float64)
    if frames.ndim != 2 or frames.shape[1] != WIDTH:
        raise ValueError(f"frames must be (T, {WIDTH}), got {frames.shape}")
    T = frames.shape[0]
    qpos = np.zeros((T, 35))
    qvel = np.zeros((T, 34))
    rc = lib.dmtpu_convert_frames(_ptr(frames), T, WIDTH, _ptr(qpos),
                                  _ptr(qvel))
    if rc != 0:
        raise ValueError(f"native conversion failed (rc={rc})")
    return qpos, qvel


def parse_clip(path: str) -> tuple[np.ndarray, str]:
    """A DeepMimic JSON file → (frames (T, 44), loop), in C++."""
    lib = _load()
    cap = MAX_FRAMES * WIDTH
    buf = np.zeros(cap)
    loop = ctypes.create_string_buffer(32)
    T = lib.dmtpu_parse_clip(path.encode(), _ptr(buf), cap, loop, 32)
    if T < 0:
        raise ValueError(f"native parse failed for {path}")
    return buf[:T * WIDTH].reshape(T, WIDTH).copy(), loop.value.decode()


def load_clip_native(path: str) -> MocapClip:
    """Parse and convert in C++ → ``MocapClip``.  As in JAX, the C++ path
    makes no aligned quaternion frames: ``quat_frames`` is zeros."""
    frames, loop = parse_clip(path)
    qpos, qvel = convert_frames(frames)
    durations = frames[:, 0].copy()
    return MocapClip(
        name=os.path.splitext(os.path.basename(path))[0], loop=loop,
        dt=float(durations[0]), durations=durations, qpos=qpos, qvel=qvel,
        quat_frames=np.zeros((len(frames), WIDTH)), raw_frames=frames)
