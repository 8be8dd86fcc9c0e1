"""TRPO (port of ``deepmimic_mujoco_tpu/algos/trpo.py``).  Slice 1 ports the
episode-start reset choice; the update is ROADMAP.md queue A, slice 2."""

from __future__ import annotations


def pick_reset_fn(env, reset_mode: str):
    """Episode-start reset ``(generator, n) → EnvState``: "rsi" = random
    mocap frame, "noise" = the v3 noise reset.  Unlike the JAX version,
    which falls back to noise resets for any other string, an unknown mode
    raises."""
    if reset_mode == "rsi":
        return env.reset
    if reset_mode == "noise":
        return env.reset_init
    raise ValueError(f"unknown reset_mode {reset_mode!r}; expected 'rsi' or "
                     "'noise'")
