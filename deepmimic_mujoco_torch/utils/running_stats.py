"""Running mean/std of observations (port of ``deepmimic_mujoco_tpu/utils/
running_stats.py``: the state and ``normalize``; the update is training's,
slice 2)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class RunningMeanStd(NamedTuple):
    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor

    @property
    def std(self) -> torch.Tensor:
        return torch.sqrt(torch.clamp(self.var, min=1e-2 ** 2))


def init(dim: int, device: torch.device | str, epsilon: float = 1e-2
         ) -> RunningMeanStd:
    """Mean 0, std ε, count ε (the reference's init)."""
    return RunningMeanStd(
        mean=torch.zeros(dim, device=device),
        var=torch.full((dim,), epsilon ** 2, device=device),
        count=torch.tensor(epsilon, device=device))


def normalize(rms: RunningMeanStd, x: torch.Tensor, clip: float = 5.0
              ) -> torch.Tensor:
    """(x - mean)/std clipped to ±clip (the reference's obs filter)."""
    return torch.clamp((x - rms.mean) / rms.std, -clip, clip)
