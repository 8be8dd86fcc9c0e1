"""A batch of envs with auto-reset (port of ``deepmimic_mujoco_tpu/envs/
vector.py``).  The port's envs are batch-first already, so the batch is the
env's own; what this class adds is the reset of the envs that finished.

``autoreset``: "init" (the env's noise reset, the reference training
behaviour; "rsi" where the env has no ``reset_init``), "rsi" (a random
mocap frame) or "none".  After a step, an env that finished holds a fresh
episode start: its qpos, qvel, **obs**, cursor and step count are the
fresh reset's, while reward and done are those of the finished transition.
This is what the JAX code returns (its docstring says the terminal obs
stays visible; the code returns the fresh one).

The JAX version draws fresh starts for every env at every step inside its
traced program; the port draws them from the caller's generator only at a
step where some env finished (one host read of the done flags per step),
one batch of ``num_envs`` starts, of which the finished envs take theirs.
"""

from __future__ import annotations

import dataclasses

import torch

from deepmimic_mujoco_torch.envs.types import EnvState


class VectorEnv:
    """``num_envs`` instances of a batch-first env, with auto-reset."""

    def __init__(self, env, num_envs: int, autoreset: str = "init"):
        if autoreset not in ("init", "rsi", "none"):
            raise ValueError(f"unknown autoreset {autoreset!r}")
        self.env = env
        self.num_envs = num_envs
        self.autoreset = autoreset
        if autoreset == "init" and not hasattr(env, "reset_init"):
            self.autoreset = "rsi"

    @property
    def observation_size(self):
        return self.env.observation_size

    @property
    def action_size(self):
        return self.env.action_size

    def reset(self, generator: torch.Generator) -> EnvState:
        return self.env.reset(generator, self.num_envs)

    def reset_init(self, generator: torch.Generator) -> EnvState:
        return getattr(self.env, "reset_init", self.env.reset)(
            generator, self.num_envs)

    def step(self, state: EnvState, actions: torch.Tensor,
             generator: torch.Generator | None = None) -> EnvState:
        """Step every env; the envs that finished start again from a fresh
        reset drawn from ``generator`` (needed unless ``autoreset`` is
        "none")."""
        nxt = self.env.step(state, actions)
        if self.autoreset == "none" or not bool(nxt.done.any()):
            return nxt
        if generator is None:
            raise ValueError("an env finished: auto-reset needs a generator")
        if self.autoreset == "init":
            fresh = self.reset_init(generator)
        else:
            fresh = self.reset(generator)
        return dataclasses.replace(fresh.where(nxt.done, nxt),
                                   reward=nxt.reward, done=nxt.done)
