"""Running mean/std of observations (port of ``deepmimic_mujoco_tpu/utils/
running_stats.py``: the state, the Chan parallel ``update`` and
``normalize``).  The port runs in one process, so the update has no
``axis_name``."""

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


def update(rms: RunningMeanStd, batch: torch.Tensor) -> RunningMeanStd:
    """Chan et al. parallel update from a batch (leading axis = samples).
    The batch variance is ``sq/n - mean²``, as in the JAX version."""
    batch = batch.reshape((-1,) + tuple(rms.mean.shape))
    n = float(batch.shape[0])
    batch_mean = torch.sum(batch, dim=0) / n
    batch_var = torch.sum(torch.square(batch), dim=0) / n - torch.square(
        batch_mean)
    delta = batch_mean - rms.mean
    tot = rms.count + n
    new_mean = rms.mean + delta * n / tot
    m2 = (rms.var * rms.count + batch_var * n
          + torch.square(delta) * rms.count * n / tot)
    return RunningMeanStd(mean=new_mean, var=m2 / tot, count=tot)
