"""Observation and return normalization over a :class:`VectorEnv` (port of
``deepmimic_mujoco_tpu/envs/vec_normalize.py``, the reference's
``VecNormalize``): running statistics of the observations and of the
discounted returns, observations and rewards clipped to ±10.  The
statistics are carried in :class:`VecNormalizeState`, as in JAX."""

from __future__ import annotations

from typing import NamedTuple

import torch

from deepmimic_mujoco_torch.envs.types import EnvState
from deepmimic_mujoco_torch.utils import running_stats


class VecNormalizeState(NamedTuple):
    env_state: EnvState
    ob_rms: running_stats.RunningMeanStd
    ret_rms: running_stats.RunningMeanStd   # scalar statistics
    ret: torch.Tensor                       # (B,) running discounted returns


class VecNormalize:
    def __init__(self, venv, ob: bool = True, ret: bool = True,
                 clipob: float = 10.0, cliprew: float = 10.0,
                 gamma: float = 0.99):
        self.venv = venv
        self.norm_ob = ob
        self.norm_ret = ret
        self.clipob = clipob
        self.cliprew = cliprew
        self.gamma = gamma

    def reset(self, generator: torch.Generator) -> VecNormalizeState:
        env_state = self.venv.reset(generator)
        dev = env_state.obs.device
        ob_rms = running_stats.init((self.venv.observation_size,), dev)
        ret_rms = running_stats.init((), dev)
        ob_rms = running_stats.update(ob_rms, env_state.obs)
        return VecNormalizeState(
            env_state=env_state, ob_rms=ob_rms, ret_rms=ret_rms,
            ret=torch.zeros(self.venv.num_envs, device=dev))

    def observe(self, state: VecNormalizeState) -> torch.Tensor:
        obs = state.env_state.obs
        if not self.norm_ob:
            return obs
        return torch.clamp((obs - state.ob_rms.mean) / state.ob_rms.std,
                           -self.clipob, self.clipob)

    def step(self, state: VecNormalizeState, actions: torch.Tensor,
             generator: torch.Generator | None = None):
        """(state, normalized obs, normalized reward, done), in the JAX
        order: the return, then the obs statistics, the return statistics,
        the reward scaled by the return's std, and the return zeroed where
        an episode ended.  ``generator`` feeds the auto-reset."""
        env_state = self.venv.step(state.env_state, actions, generator)
        ret = state.ret * self.gamma + env_state.reward
        ob_rms = (running_stats.update(state.ob_rms, env_state.obs)
                  if self.norm_ob else state.ob_rms)
        ret_rms = (running_stats.update(state.ret_rms, ret)
                   if self.norm_ret else state.ret_rms)
        rew = env_state.reward
        if self.norm_ret:
            rew = torch.clamp(rew / ret_rms.std, -self.cliprew, self.cliprew)
        ret = torch.where(env_state.done, 0.0, ret)
        new_state = VecNormalizeState(env_state=env_state, ob_rms=ob_rms,
                                      ret_rms=ret_rms, ret=ret)
        return new_state, self.observe(new_state), rew, env_state.done
