"""Conjugate gradient on an implicit SPD operator (port of
``deepmimic_mujoco_tpu/algos/cg.py``): the same update order, residual
tolerance and iteration cap.  The stopping test runs on the host, one
device sync per iteration, so the loop stops where JAX's ``while_loop``
does."""

from __future__ import annotations

from typing import Callable

import torch


def cg(f_Ax: Callable, b: torch.Tensor, cg_iters: int = 10,
       residual_tol: float = 1e-10) -> torch.Tensor:
    x = torch.zeros_like(b)
    r = b.clone()
    p = b.clone()
    rdotr = torch.dot(r, r)
    for _ in range(cg_iters):
        if not float(rdotr) > residual_tol:
            break
        z = f_Ax(p)
        v = rdotr / torch.dot(p, z)
        x = x + v * p
        r = r - v * z
        newrdotr = torch.dot(r, r)
        p = r + (newrdotr / rdotr) * p
        rdotr = newrdotr
    return x
