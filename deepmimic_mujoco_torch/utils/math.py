"""Math utilities (port of ``deepmimic_mujoco_tpu/utils/math.py``).  Every
variance is the population variance (ddof 0, ``correction=0``), as
``jnp.var`` computes it."""

from __future__ import annotations

import torch


def explained_variance(ypred: torch.Tensor, y: torch.Tensor,
                       dim: int | None = None) -> torch.Tensor:
    """1 - Var[y - ypred]/Var[y] (over ``dim``, all axes when None); NaN
    when Var[y] == 0, like the reference."""
    vary = torch.var(y, dim=dim, correction=0)
    return 1.0 - torch.var(y - ypred, dim=dim, correction=0) / vary


def discount(x: torch.Tensor, gamma: float) -> torch.Tensor:
    """y[t] = Σ_k γ^k x[t+k] along the leading axis."""
    out = torch.empty_like(x)
    carry = torch.zeros_like(x[0])
    for t in range(x.shape[0] - 1, -1, -1):
        carry = x[t] + gamma * carry
        out[t] = carry
    return out


def discount_with_boundaries(x: torch.Tensor, new: torch.Tensor,
                             gamma: float) -> torch.Tensor:
    """Like :func:`discount`, reset at episode starts:
    y[t] = x[t] + γ·y[t+1]·(1 - new[t+1])."""
    nonterm = 1.0 - torch.cat([new[1:], torch.zeros_like(new[:1])]).to(x.dtype)
    out = torch.empty_like(x)
    carry = torch.zeros_like(x[0])
    for t in range(x.shape[0] - 1, -1, -1):
        carry = x[t] + gamma * carry * nonterm[t]
        out[t] = carry
    return out
