"""Diagonal Gaussian action distribution (port of ``diag_gaussian`` in
``deepmimic_mujoco_tpu/models/distributions.py``: the evaluation's
``sample`` and ``mode``)."""

from __future__ import annotations

import torch


class diag_gaussian:
    @staticmethod
    def sample(generator: torch.Generator, mean: torch.Tensor,
               logstd: torch.Tensor) -> torch.Tensor:
        noise = torch.randn(mean.shape, generator=generator,
                            device=mean.device, dtype=mean.dtype)
        return mean + torch.exp(logstd) * noise

    @staticmethod
    def mode(mean: torch.Tensor, logstd: torch.Tensor) -> torch.Tensor:
        return mean
