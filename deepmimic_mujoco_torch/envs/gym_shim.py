"""Gymnasium-API shim over the port's batch-first envs (port of
``deepmimic_mujoco_tpu/envs/gym_shim.py``): one env (a batch of 1 on the
env's device) behind ``reset`` / ``step``, and the registry ids of the
reference's gym packages.  gymnasium is optional: without it ``GymEnv``
derives from ``object``, has no spaces, and registration does nothing."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

try:
    import gymnasium
    from gymnasium import spaces

    _HAS_GYM = True
except Exception:  # pragma: no cover
    gymnasium = None
    _HAS_GYM = False


class GymEnv(gymnasium.Env if _HAS_GYM else object):
    """One env of a batch-first env in the gymnasium single-env API.

    ``reset()`` is the env's ``reset`` (RSI for the mocap envs); pass
    ``options={"init": True}`` for its noise reset (``reset_init``).  The
    draws come from a generator on the env's device, seeded by ``seed``
    (and again by ``reset(seed=...)``)."""

    metadata = {"render_modes": []}

    def __init__(self, env, seed: int = 0):
        self.fenv = env
        self._generator = torch.Generator(device=env.device).manual_seed(seed)
        self._state = None
        if _HAS_GYM:
            hi = np.inf * np.ones(env.observation_size, np.float32)
            self.observation_space = spaces.Box(-hi, hi, dtype=np.float32)
            self.action_space = spaces.Box(
                -1.0, 1.0, shape=(env.action_size,), dtype=np.float32)

    def reset(self, *, seed: Optional[int] = None, options=None):
        if seed is not None:
            self._generator.manual_seed(seed)
        init = bool(options and options.get("init"))
        fn = (getattr(self.fenv, "reset_init", self.fenv.reset) if init
              else self.fenv.reset)
        self._state = fn(self._generator, 1)
        return self._state.obs[0].cpu().numpy(), {}

    def step(self, action):
        a = torch.as_tensor(np.asarray(action, np.float32),
                            device=self.fenv.device)[None]
        self._state = s = self.fenv.step(self._state, a)
        return (s.obs[0].cpu().numpy(), float(s.reward[0]), bool(s.done[0]),
                False, {"mocap_idx": int(s.mocap_idx[0])})

    @property
    def state(self):
        return self._state


def register_gym_envs() -> None:
    """Register the reference's gym ids with gymnasium ('HumanoidDeepMimic-
    v0' and the rest).  An id that is already registered is skipped: in a
    process that imports both packages, the first registration wins."""
    if not _HAS_GYM:
        return
    from gymnasium.envs.registration import register, registry

    specs = {
        "HumanoidDeepMimic-v0": {"entry": "DPEnvV3", "kwargs": {}},
        "HumanoidDeepMimicExtraHard-v0": {
            "entry": "DPEnvV3", "kwargs": {"reward_mode": "imitation"}},
        "DPEnvV3-v0": {"entry": "DPEnvV3", "kwargs": {}},
        "DPEnvV2-v0": {"entry": "DPEnvV2", "kwargs": {}},
        "DPEnvV1-v0": {"entry": "DPEnvV1", "kwargs": {}},
    }
    for env_id, spec in specs.items():
        if env_id in registry:
            continue
        register(
            id=env_id,
            entry_point=lambda entry=spec["entry"], kw=spec["kwargs"], **kwargs:
                make(entry, **{**kw, **kwargs}),
        )


def make(env_id: str = "DPEnvV3", **kwargs) -> GymEnv:
    """Registry-style constructor: DPEnvV1/V2/V3, HumanoidDeepMimic-v0 and
    HumanoidTest; ``seed`` seeds the shim, the rest (``device=`` among
    them) goes to the env."""
    from deepmimic_mujoco_torch.envs import (
        DPEnvV1,
        DPEnvV2,
        DPEnvV3,
        HumanoidTestEnv,
    )

    envs = {
        "DPEnvV1": DPEnvV1,
        "DPEnvV2": DPEnvV2,
        "DPEnvV3": DPEnvV3,
        "HumanoidDeepMimic-v0": DPEnvV3,
        "HumanoidTest": HumanoidTestEnv,
    }
    seed = kwargs.pop("seed", 0)
    return GymEnv(envs[env_id](**kwargs), seed=seed)
