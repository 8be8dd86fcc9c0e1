"""Running mean/std of observations and returns (port of
``deepmimic_mujoco_tpu/utils/running_stats.py``: the state, the Chan
parallel ``update`` and ``normalize``).  The statistics have any shape,
() included (``VecNormalize``'s return statistics).  The port runs in one
process, so the update has no ``axis_name``."""

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


def init(shape: int | tuple, device: torch.device | str,
         epsilon: float = 1e-2) -> RunningMeanStd:
    """Mean 0, std ε, count ε (the reference's init) of ``shape``: an int
    is a feature dimension, a tuple the statistics' shape (``()``: a
    scalar)."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return RunningMeanStd(
        mean=torch.zeros(shape, device=device),
        var=torch.full(shape, epsilon ** 2, device=device),
        count=torch.tensor(epsilon, device=device))


def normalize(rms: RunningMeanStd, x: torch.Tensor, clip: float = 5.0
              ) -> torch.Tensor:
    """(x - mean)/std clipped to ±clip (the reference's obs filter)."""
    return torch.clamp((x - rms.mean) / rms.std, -clip, clip)


def update(rms: RunningMeanStd, batch: torch.Tensor) -> RunningMeanStd:
    """Chan et al. parallel update from a batch whose samples lie along
    the leading axis, each of the statistics' shape (``batch.reshape((-1,)
    + mean.shape)``, as in the JAX version; a scalar's batch is (n,)).  The
    batch variance is ``sq/n - mean²``.  Lane-stacked stats (mean (L, 1,
    d), count (L, 1, 1); ``algos/lanes.py``) update each lane from its own
    samples, batch (L, n, d)."""
    if rms.count.dim():  # lane-stacked
        lead, d = tuple(rms.mean.shape[:-2]), rms.mean.shape[-1]
        batch, axis = batch.reshape(lead + (-1, d)), -2
    else:
        batch, axis = batch.reshape((-1,) + tuple(rms.mean.shape)), 0
    n = float(batch.shape[axis])
    batch_mean = (torch.sum(batch, dim=axis) / n).reshape(rms.mean.shape)
    batch_var = (torch.sum(torch.square(batch), dim=axis) / n).reshape(
        rms.mean.shape) - torch.square(batch_mean)
    delta = batch_mean - rms.mean
    tot = rms.count + n
    new_mean = rms.mean + delta * n / tot
    m2 = (rms.var * rms.count + batch_var * n
          + torch.square(delta) * rms.count * n / tot)
    return RunningMeanStd(mean=new_mean, var=m2 / tot, count=tot)
