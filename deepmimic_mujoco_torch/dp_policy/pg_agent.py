"""Vanilla policy-gradient agent of the original stack (port of
``deepmimic_mujoco_tpu/dp_policy/pg_agent.py``): everything of
:class:`PPOAgent` but the actor objective, an advantage-weighted
regression toward the taken actions,

    L_actor = 0.5·mean(adv · Σ(norm_a − norm_mean)²)
              + bound_loss / noise + weight decay,

whose clip fraction is 0."""

from __future__ import annotations

import torch

from deepmimic_mujoco_torch.dp_policy.ppo_agent import PPOAgent


class PGAgent(PPOAgent):
    def _actor_loss(self, params, s, a, old_logp, adv):
        """``old_logp`` is unused (no ratio)."""
        _, noise_std = self.exp_params_at(params["sample_count"])
        mean = self.actor_mean(params, s)
        norm_mean = self.a_norm.normalize(params["a_norm"], mean)
        norm_a = self.a_norm.normalize(params["a_norm"], a)
        sq = torch.sum(torch.square(norm_a - norm_mean), dim=-1)
        loss = 0.5 * torch.mean(adv * sq)
        loss = loss + self._bound_loss(params, norm_mean) / noise_std
        if self.actor_wd:
            loss = loss + self.actor_wd * 0.5 * sum(
                torch.sum(torch.square(layer["w"]))
                for layer in params["actor"])
        return loss, torch.zeros((), device=loss.device)
