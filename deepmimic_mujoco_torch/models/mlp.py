"""Plain functional MLP with baselines' column-normalized init (port of
``deepmimic_mujoco_tpu/models/mlp.py``).  Parameters are a list of
``{"w": (in, out), "b": (out,)}`` dicts, the JAX package's layout."""

from __future__ import annotations

from typing import Callable

import torch


def normc_init(generator: torch.Generator, shape: tuple[int, int],
               scale: float = 1.0, device: torch.device | str = "cpu"
               ) -> torch.Tensor:
    """Gaussian columns scaled to norm ``scale``."""
    w = torch.randn(shape, generator=generator, device=device)
    return w * scale / torch.sqrt(torch.sum(w * w, dim=0, keepdim=True))


def init_mlp(generator: torch.Generator, sizes: list[int],
             final_scale: float = 1.0, device: torch.device | str = "cpu"
             ) -> list[dict]:
    """sizes = [in, h1, ..., out]."""
    params = []
    for i in range(len(sizes) - 1):
        scale = final_scale if i == len(sizes) - 2 else 1.0
        params.append({
            "w": normc_init(generator, (sizes[i], sizes[i + 1]), scale, device),
            "b": torch.zeros(sizes[i + 1], device=device),
        })
    return params


def apply_mlp(params: list[dict], x: torch.Tensor,
              activation: Callable = torch.tanh) -> torch.Tensor:
    """Hidden layers use ``activation``; the output layer is linear."""
    for layer in params[:-1]:
        x = activation(x @ layer["w"] + layer["b"])
    return x @ params[-1]["w"] + params[-1]["b"]
