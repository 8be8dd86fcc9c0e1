"""Device selection for the port's entry points."""

from __future__ import annotations

import torch

# the JAX CLIs' --platform values → the port's device
PLATFORMS = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Raises when CUDA is asked for (or implied) and absent — there
    is no silent fallback to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
