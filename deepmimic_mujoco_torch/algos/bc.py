"""Behaviour-cloning pretraining for GAIL (port of ``deepmimic_mujoco_tpu/
algos/bc.py:behavior_clone``): maximum-likelihood regression of the
policy on expert (obs, acs) minibatches with Adam over ``{logstd, pol}``
(JAX's ravel order), the obs running stats updated from each batch before
its loss."""

from __future__ import annotations

import torch

from deepmimic_mujoco_torch.algos import adam
from deepmimic_mujoco_torch.algos.trpo import (
    _layers,
    _unflatten,
    flatten,
    policy_leaves,
)
from deepmimic_mujoco_torch.models import distributions
from deepmimic_mujoco_torch.utils import running_stats


def behavior_clone(policy, params: dict, dataset, max_iters: int = 10_000,
                   batch_size: int = 128, stepsize: float = 3e-4,
                   verbose_every: int = 1000) -> dict:
    """``params`` after ``max_iters`` BC steps on ``dataset`` (a
    ``MujocoDset``: ``get_next_batch(batch_size, "train")``), on the
    params' device.  Prints the loss every ``verbose_every`` steps and at
    the last."""
    like = policy_leaves(params)
    theta = flatten(like).detach()
    opt = adam.init(theta.numel(), theta.device)
    ob_rms = params["ob_rms"]
    for it in range(max_iters):
        obs, acs = dataset.get_next_batch(batch_size, "train")
        obs = torch.as_tensor(obs, dtype=torch.float32, device=theta.device)
        acs = torch.as_tensor(acs, dtype=torch.float32, device=theta.device)
        ob_rms = running_stats.update(ob_rms, obs)
        th = theta.requires_grad_(True)
        leaves = _unflatten(th, like)
        p = {**params, "logstd": leaves[0], "pol": _layers(leaves[1:]),
             "ob_rms": ob_rms}
        mean, logstd = policy.mean_logstd(p, obs)
        loss = torch.mean(distributions.diag_gaussian.neglogp(mean, logstd,
                                                              acs))
        grad = torch.autograd.grad(loss, th)[0]
        with torch.no_grad():
            theta, opt = adam.update(opt, grad, th.detach(), stepsize)
        if verbose_every and (it % verbose_every == 0
                              or it == max_iters - 1):
            print(f"BC iter {it}: loss {float(loss.detach()):.4f}")
    leaves = _unflatten(theta, like)
    return {**params, "logstd": leaves[0], "pol": _layers(leaves[1:]),
            "ob_rms": ob_rms}
