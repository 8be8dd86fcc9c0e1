"""Every random draw of the original-stack agent and its driver, behind one
seam (the counterpart of the JAX driver's key, which it splits at each
chunk, train step and test).  The tests replace it with one that replays
JAX's draws; the smoke run records the CPU's draws and replays them on the
card."""

from __future__ import annotations

import torch


class Draws:
    """Draws on the device the generators live on: the rollout's and the
    tests' from ``generator``, the train step's from ``shared`` (the same
    generator unless one is given; across ranks, one seeded alike on every
    rank)."""

    def __init__(self, generator: torch.Generator,
                 shared: torch.Generator | None = None):
        self.generator = generator
        self.shared = generator if shared is None else shared

    def rollout_chunk(self, steps: int, n_envs: int, action_size: int,
                      device: torch.device):
        """A rollout chunk's ε-coins (steps, n_envs) in [0, 1) and its
        standard normal action noise (steps, n_envs, action_size)."""
        g = self.generator
        return (torch.rand((steps, n_envs), generator=g, device=device),
                torch.randn((steps, n_envs, action_size), generator=g,
                            device=device))

    def fresh_states(self, reset_fn, done: torch.Tensor):
        """Fresh episode starts for all envs, of which the rollout keeps
        those that are ``done``: the draw does not depend on the data and
        reads nothing back to the host.  ``reset_fn(generator, n)``."""
        return reset_fn(self.generator, done.shape[0])

    def test_starts(self, reset_fn, n: int):
        """The starts of ``n`` test episodes."""
        return reset_fn(self.generator, n)

    def minibatch_indices(self, p_critic: torch.Tensor, p_actor: torch.Tensor,
                          epochs: int, n_mb: int, size: int):
        """(epochs·n_mb, size) record indices for the critic and for the
        actor, one row per minibatch step, drawn with replacement with the
        probabilities ``p_critic`` and ``p_actor``."""
        g = self.shared
        return tuple(torch.multinomial(p.expand(epochs * n_mb, -1), size,
                                       replacement=True, generator=g)
                     for p in (p_critic, p_actor))

    def epoch_permutations(self, n: int, epochs: int,
                           device: torch.device) -> torch.Tensor:
        """(epochs, n): one permutation of the rows per epoch
        (``PPOAgent.update``)."""
        return torch.stack([torch.randperm(n, generator=self.shared,
                                           device=device)
                            for _ in range(epochs)])
