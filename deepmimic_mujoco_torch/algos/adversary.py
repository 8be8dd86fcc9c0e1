"""GAIL discriminator (port of ``deepmimic_mujoco_tpu/algos/adversary.py:
TransitionClassifier``): the observation, normalized by its own running
mean/std without the policy's ±5 clip, concatenated with the action,
through a tanh MLP of two ``hidden_size`` layers to one logit.

Losses: sigmoid cross-entropy pushing generator transitions to 0 and
expert transitions to 1, written as JAX writes it, plus a Bernoulli-entropy
bonus (``entcoeff``·H).  The policy's reward is −log(1 − σ(logit) + 1e-8).
Parameters: ``{"net": [{"w", "b"}, ...], "obs_rms": RunningMeanStd}``."""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from deepmimic_mujoco_torch.models.mlp import apply_mlp, init_mlp
from deepmimic_mujoco_torch.utils import running_stats


def _softplus_neg_abs(x: torch.Tensor) -> torch.Tensor:
    return torch.log1p(torch.exp(-torch.abs(x)))


class TransitionClassifier(NamedTuple):
    ob_dim: int
    ac_dim: int
    hidden_size: int = 100
    entcoeff: float = 0.001

    def init(self, generator: torch.Generator,
             device: torch.device | str) -> dict:
        return {
            "net": init_mlp(generator, [self.ob_dim + self.ac_dim,
                                        self.hidden_size, self.hidden_size, 1],
                            device=device),
            "obs_rms": running_stats.init(self.ob_dim, device),
        }

    def logits(self, params: dict, obs: torch.Tensor,
               acs: torch.Tensor) -> torch.Tensor:
        rms = params["obs_rms"]
        obz = (obs - rms.mean) / rms.std    # no clip, unlike the policy's
        return apply_mlp(params["net"], torch.cat([obz, acs], dim=-1))[..., 0]

    def loss(self, params: dict, gen_obs: torch.Tensor, gen_acs: torch.Tensor,
             exp_obs: torch.Tensor, exp_acs: torch.Tensor):
        """(total loss, metrics): generator and expert losses, entropy,
        entropy loss and both accuracies."""
        gen_logits = self.logits(params, gen_obs, gen_acs)
        exp_logits = self.logits(params, exp_obs, exp_acs)
        gen_loss = torch.mean(torch.clamp(gen_logits, min=0)
                              + _softplus_neg_abs(gen_logits))
        exp_loss = torch.mean(torch.clamp(exp_logits, min=0) - exp_logits
                              + _softplus_neg_abs(exp_logits))
        logits = torch.cat([gen_logits, exp_logits])
        p = torch.sigmoid(logits)
        entropy = torch.mean(-p * F.logsigmoid(logits)
                             - (1 - p) * F.logsigmoid(-logits))
        entropy_loss = -self.entcoeff * entropy
        total = gen_loss + exp_loss + entropy_loss
        return total, {
            "generator_loss": gen_loss, "expert_loss": exp_loss,
            "entropy": entropy, "entropy_loss": entropy_loss,
            "generator_acc": torch.mean((gen_logits < 0).float()),
            "expert_acc": torch.mean((exp_logits > 0).float()),
        }

    def reward(self, params: dict, obs: torch.Tensor,
               acs: torch.Tensor) -> torch.Tensor:
        """−log(1 − σ(D) + 1e-8): the GAIL learning signal."""
        logits = self.logits(params, obs, acs)
        return -torch.log(1.0 - torch.sigmoid(logits) + 1e-8)

    def update_obs_rms(self, params: dict, obs: torch.Tensor) -> dict:
        return {**params, "obs_rms": running_stats.update(params["obs_rms"],
                                                          obs)}
