"""Gaussian MLP policy and value function (port of ``deepmimic_mujoco_tpu/
models/policy.py:MlpPolicy``): observations normalized by running mean/std
and clipped to ±5, two separate MLPs (``pol`` for the action mean, ``vf`` for
the value; tanh 100×2 by default) and a state-independent ``logstd``.

Parameters are a dict with the JAX package's structure:
``{"pol": [...], "vf": [...], "logstd": (ac_dim,), "ob_rms": RunningMeanStd}``.
"""

from __future__ import annotations

import dataclasses

import torch

from deepmimic_mujoco_torch.models.mlp import apply_mlp, init_mlp
from deepmimic_mujoco_torch.utils import running_stats

_ACTIVATIONS = {"tanh": torch.tanh, "relu": torch.relu}


@dataclasses.dataclass(frozen=True)
class MlpPolicy:
    ob_dim: int
    ac_dim: int
    hid_size: int = 100
    num_hid_layers: int = 2
    activation: str = "tanh"

    @property
    def sizes(self) -> list[int]:
        return [self.ob_dim] + [self.hid_size] * self.num_hid_layers

    def init(self, generator: torch.Generator,
             device: torch.device | str) -> dict:
        """Random parameters (normc init; the policy head at scale 0.01)."""
        return {
            "pol": init_mlp(generator, self.sizes + [self.ac_dim],
                            final_scale=0.01, device=device),
            "vf": init_mlp(generator, self.sizes + [1], device=device),
            "logstd": torch.zeros(self.ac_dim, device=device),
            "ob_rms": running_stats.init(self.ob_dim, device),
        }

    def mean_logstd(self, params: dict, ob: torch.Tensor):
        obz = running_stats.normalize(params["ob_rms"], ob)
        mean = apply_mlp(params["pol"], obz, _ACTIVATIONS[self.activation])
        return mean, params["logstd"].expand_as(mean)

    def value(self, params: dict, ob: torch.Tensor) -> torch.Tensor:
        obz = running_stats.normalize(params["ob_rms"], ob)
        return apply_mlp(params["vf"], obz, _ACTIVATIONS[self.activation])[..., 0]
