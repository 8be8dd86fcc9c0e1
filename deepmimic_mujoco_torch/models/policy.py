"""Gaussian MLP policy and value function (port of ``deepmimic_mujoco_tpu/
models/policy.py:MlpPolicy``): observations normalized by running mean/std
and clipped to ±5, two separate MLPs (``pol`` for the action mean, ``vf`` for
the value; tanh 100×2 by default) and a state-independent ``logstd``.

Parameters are a dict with the JAX package's structure:
``{"pol": [...], "vf": [...], "logstd": (ac_dim,), "ob_rms": RunningMeanStd}``.
TRPO treats ``pol`` and ``logstd`` as the policy parameters; ``ob_rms`` is
updated from samples, never by gradients.

``fixed_logstd``: the exploration noise is a constant (DeepMimic's fixed
noise).  The value is stored in ``logstd``, so ``act``/``kl``/``entropy``
are unchanged, and TRPO masks its coordinates out of the update.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from deepmimic_mujoco_torch.models import distributions
from deepmimic_mujoco_torch.models.mlp import apply_mlp, init_mlp
from deepmimic_mujoco_torch.utils import running_stats

_ACTIVATIONS = {"tanh": torch.tanh, "relu": torch.relu}


@dataclasses.dataclass(frozen=True)
class MlpPolicy:
    ob_dim: int
    ac_dim: int
    hid_size: int = 100
    num_hid_layers: int = 2
    fixed_logstd: Optional[float] = None
    # overrides hid_size × num_hid_layers when set, e.g. (1024, 512)
    hidden_sizes: Optional[tuple] = None
    activation: str = "tanh"

    @property
    def sizes(self) -> list[int]:
        """[ob_dim, hidden...]: the input and hidden widths of both MLPs."""
        hidden = (list(self.hidden_sizes) if self.hidden_sizes
                  else [self.hid_size] * self.num_hid_layers)
        return [self.ob_dim] + hidden

    def init(self, generator: torch.Generator,
             device: torch.device | str) -> dict:
        """Random parameters (normc init; the policy head at scale 0.01;
        ``logstd`` at ``fixed_logstd`` or 0)."""
        logstd0 = 0.0 if self.fixed_logstd is None else float(
            self.fixed_logstd)
        return {
            "pol": init_mlp(generator, self.sizes + [self.ac_dim],
                            final_scale=0.01, device=device),
            "vf": init_mlp(generator, self.sizes + [1], device=device),
            "logstd": torch.full((self.ac_dim,), logstd0, device=device),
            "ob_rms": running_stats.init(self.ob_dim, device),
        }

    def mean_logstd(self, params: dict, ob: torch.Tensor):
        obz = running_stats.normalize(params["ob_rms"], ob)
        mean = apply_mlp(params["pol"], obz, _ACTIVATIONS[self.activation])
        return mean, params["logstd"].expand_as(mean)

    def value(self, params: dict, ob: torch.Tensor) -> torch.Tensor:
        obz = running_stats.normalize(params["ob_rms"], ob)
        return apply_mlp(params["vf"], obz, _ACTIVATIONS[self.activation])[..., 0]

    def act(self, params: dict, generator: torch.Generator, ob: torch.Tensor,
            stochastic: bool = True):
        """(action, vpred): a sample from ``generator`` or the mean."""
        mean, logstd = self.mean_logstd(params, ob)
        ac = (distributions.diag_gaussian.sample(generator, mean, logstd)
              if stochastic else mean)
        return ac, self.value(params, ob)

    def neglogp(self, params: dict, ob: torch.Tensor,
                ac: torch.Tensor) -> torch.Tensor:
        mean, logstd = self.mean_logstd(params, ob)
        return distributions.diag_gaussian.neglogp(mean, logstd, ac)

    def entropy(self, params: dict, ob: torch.Tensor) -> torch.Tensor:
        _, logstd = self.mean_logstd(params, ob)
        return distributions.diag_gaussian.entropy(logstd)

    def kl(self, params_old: dict, params_new: dict,
           ob: torch.Tensor) -> torch.Tensor:
        """KL(old ‖ new) per sample."""
        m0, s0 = self.mean_logstd(params_old, ob)
        m1, s1 = self.mean_logstd(params_new, ob)
        return distributions.diag_gaussian.kl(m0, s0, m1, s1)

    def update_ob_rms(self, params: dict, obs: torch.Tensor,
                      group=None) -> dict:
        """``params`` with ob_rms updated from ``obs`` (summed over
        ``group``'s ranks where given)."""
        return {**params, "ob_rms": running_stats.update(params["ob_rms"],
                                                         obs, group)}
