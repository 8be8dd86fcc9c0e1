"""Diagonal Gaussian action distribution (port of ``diag_gaussian`` in
``deepmimic_mujoco_tpu/models/distributions.py``), with the reference's
logp, KL and entropy formulas."""

from __future__ import annotations

import math

import torch

_LOG2PI = math.log(2.0 * math.pi)
_LOG2PIE = math.log(2.0 * math.pi * math.e)


class diag_gaussian:
    @staticmethod
    def neglogp(mean: torch.Tensor, logstd: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
        std = torch.exp(logstd)
        return (0.5 * torch.sum(torch.square((x - mean) / std), dim=-1)
                + 0.5 * _LOG2PI * x.shape[-1]
                + torch.sum(logstd, dim=-1))

    @staticmethod
    def logp(mean: torch.Tensor, logstd: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
        return -diag_gaussian.neglogp(mean, logstd, x)

    @staticmethod
    def kl(mean_p: torch.Tensor, logstd_p: torch.Tensor,
           mean_q: torch.Tensor, logstd_q: torch.Tensor) -> torch.Tensor:
        """KL(p ‖ q)."""
        std_p, std_q = torch.exp(logstd_p), torch.exp(logstd_q)
        return torch.sum(
            logstd_q - logstd_p
            + (torch.square(std_p) + torch.square(mean_p - mean_q))
            / (2.0 * torch.square(std_q)) - 0.5, dim=-1)

    @staticmethod
    def entropy(logstd: torch.Tensor) -> torch.Tensor:
        return torch.sum(logstd + 0.5 * _LOG2PIE, dim=-1)

    @staticmethod
    def sample(generator: torch.Generator, mean: torch.Tensor,
               logstd: torch.Tensor) -> torch.Tensor:
        noise = torch.randn(mean.shape, generator=generator,
                            device=mean.device, dtype=mean.dtype)
        return mean + torch.exp(logstd) * noise

    @staticmethod
    def mode(mean: torch.Tensor, logstd: torch.Tensor) -> torch.Tensor:
        return mean
