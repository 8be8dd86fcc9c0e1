"""Net builders of the original-stack agents (port of
``deepmimic_mujoco_tpu/dp_policy/nets.py``): name → builder; the
canonical net is a 1024-512 relu MLP on the port's ``models/mlp.py``."""

from __future__ import annotations

import torch

from deepmimic_mujoco_torch.models.mlp import apply_mlp, init_mlp


def fc_2layers_1024units(generator: torch.Generator, input_dim: int,
                         out_dim: int, device: torch.device | str = "cpu"):
    """1024-512 relu trunk and a linear head."""
    return init_mlp(generator, [input_dim, 1024, 512, out_dim],
                    device=device)


def apply_relu_mlp(params: list[dict], x: torch.Tensor) -> torch.Tensor:
    return apply_mlp(params, x, activation=torch.relu)


_BUILDERS = {
    "fc_2layers_1024units": fc_2layers_1024units,
}


def build_net(net_name: str, generator: torch.Generator, input_dim: int,
              out_dim: int, device: torch.device | str = "cpu"):
    if net_name not in _BUILDERS:
        raise ValueError(f"Unsupported net: {net_name}")
    return _BUILDERS[net_name](generator, input_dim, out_dim, device)
