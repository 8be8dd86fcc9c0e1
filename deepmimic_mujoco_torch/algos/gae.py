"""Generalized Advantage Estimation (port of ``deepmimic_mujoco_tpu/algos/
gae.py``): the reference's recursion over a segment that crosses episode
boundaries, as a reverse loop over the time axis."""

from __future__ import annotations

import torch


def add_vtarg_and_adv(rew: torch.Tensor, vpred: torch.Tensor,
                      new: torch.Tensor, nextvpred, gamma: float,
                      lam: float) -> tuple[torch.Tensor, torch.Tensor]:
    """rew/vpred/new: (T,) or (T, B); nextvpred: scalar or (B,).  Returns
    (adv, tdlamret) with

      nonterminal[t] = 1 - new[t+1]   (new[T] := 0)
      delta[t] = rew[t] + γ·vpred[t+1]·nonterminal[t] - vpred[t]
      adv[t]   = delta[t] + γλ·nonterminal[t]·adv[t+1]

    where vpred[T] := nextvpred (0 where the last step ended an episode)."""
    nonterm = 1.0 - torch.cat([new[1:], torch.zeros_like(new[:1])]).to(
        rew.dtype)
    nextvpred = torch.as_tensor(nextvpred, dtype=vpred.dtype,
                                device=vpred.device)
    vpred_next = torch.cat([vpred[1:], nextvpred.expand_as(vpred[:1])])
    adv = torch.empty_like(rew)
    carry = torch.zeros_like(rew[0])
    for t in range(rew.shape[0] - 1, -1, -1):
        delta = rew[t] + gamma * vpred_next[t] * nonterm[t] - vpred[t]
        carry = delta + gamma * lam * nonterm[t] * carry
        adv[t] = carry
    return adv, adv + vpred
