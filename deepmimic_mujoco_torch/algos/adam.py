"""Flat-parameter Adam (port of ``deepmimic_mujoco_tpu/algos/adam.py``, the
reference's ``MpiAdam``): bias-corrected stepsize
a = lr·√(1−β₂ᵗ)/(1−β₁ᵗ), update θ ← θ − a·m/(√v+ε)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class AdamState(NamedTuple):
    m: torch.Tensor
    v: torch.Tensor
    t: torch.Tensor  # () float32, as in the JAX state


def init(n: int, device: torch.device | str) -> AdamState:
    return AdamState(m=torch.zeros(n, device=device),
                     v=torch.zeros(n, device=device),
                     t=torch.zeros((), device=device))


def update(state: AdamState, flat_grad: torch.Tensor, theta: torch.Tensor,
           stepsize: float, beta1: float = 0.9, beta2: float = 0.999,
           epsilon: float = 1e-8) -> tuple[torch.Tensor, AdamState]:
    """Returns (new_theta, new_state).  The reference's sign convention: it
    adds ``-a · m/(√v+ε)``.  ``t`` stays a device tensor (no host sync)."""
    t = state.t + 1.0
    a = stepsize * torch.sqrt(1.0 - beta2 ** t) / (1.0 - beta1 ** t)
    m = beta1 * state.m + (1.0 - beta1) * flat_grad
    v = beta2 * state.v + (1.0 - beta2) * torch.square(flat_grad)
    step = -a * m / (torch.sqrt(v) + epsilon)
    return theta + step, AdamState(m=m, v=v, t=t)
