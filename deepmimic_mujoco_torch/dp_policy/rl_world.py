"""The original stack's world and agent builder (port of
``deepmimic_mujoco_tpu/dp_policy/rl_world.py``): agents built from the JSON
specs of ``--agent_files``, params loaded from ``--model_files`` (the JAX
layout, ``io_utils/checkpoint.load_dp_ppo_params``), and ``get_action`` on
a state."""

from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from deepmimic_mujoco_torch.dp_policy.pg_agent import PGAgent
from deepmimic_mujoco_torch.dp_policy.ppo_agent import PPOAgent
from deepmimic_mujoco_torch.io_utils import checkpoint
from deepmimic_mujoco_torch.utils.arg_parser import ArgParser
from deepmimic_mujoco_torch.utils.device import resolve_device

# the original humanoid3d sizes
DEFAULT_STATE_SIZE = 197
DEFAULT_ACTION_SIZE = 36


def build_agent(spec: dict, state_size: int, action_size: int,
                **kwargs) -> PPOAgent:
    """The agent of the spec's ``AgentType``: PPO or PG."""
    agent_type = spec.get("AgentType", "PPO")
    if agent_type == "PPO":
        return PPOAgent(state_size, action_size, spec=spec, **kwargs)
    if agent_type == "PG":
        return PGAgent(state_size, action_size, spec=spec, **kwargs)
    raise ValueError(f"Unsupported agent type {agent_type!r}")


class RLWorld:
    """Owns the agents and their params, on ``device`` (cuda unless named)."""

    def __init__(self, arg_parser: Optional[ArgParser] = None,
                 state_size: int = DEFAULT_STATE_SIZE,
                 action_size: int = DEFAULT_ACTION_SIZE, seed: int = 0,
                 device: torch.device | str | None = None):
        self.arg_parser = arg_parser or ArgParser()
        self.device = resolve_device(device)
        self.agents: list[PPOAgent] = []
        self.agent_params: list[dict] = []
        self.state_size = state_size
        self.action_size = action_size
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self.build_agents()

    def build_agents(self) -> None:
        """One agent per ``--agent_files`` spec; its params from the
        matching ``--model_files`` entry unless that is "none" (a missing
        file fails: a fresh random agent would pass for a trained one)."""
        agent_files = self.arg_parser.parse_strings("agent_files")
        model_files = self.arg_parser.parse_strings("model_files")
        for i, f in enumerate(agent_files):
            with open(f) as fin:
                spec = json.load(fin)
            agent = build_agent(spec, self.state_size, self.action_size)
            params = agent.init(self._generator, self.device)
            if i < len(model_files) and model_files[i] not in ("", "none"):
                params = checkpoint.load_dp_ppo_params(model_files[i], agent,
                                                       self.device)
            self.agents.append(agent)
            self.agent_params.append(params)

    def get_action(self, agent_id: int, state) -> np.ndarray:
        """The agent's deterministic action (its actor's mean)."""
        s = torch.as_tensor(np.asarray(state, np.float32), device=self.device)
        agent, params = self.agents[agent_id], self.agent_params[agent_id]
        with torch.no_grad():
            a = agent.get_action(params, s)
        return a.cpu().numpy()


class ActionGiver:
    """Query actions from a world built from an arg file."""

    def __init__(self, arg_file: Optional[str] = None,
                 state_size: int = DEFAULT_STATE_SIZE,
                 action_size: int = DEFAULT_ACTION_SIZE,
                 device: torch.device | str | None = None):
        parser = ArgParser()
        if arg_file:
            parser.load_file(arg_file)
        self.world = RLWorld(parser, state_size, action_size, device=device)

    def get_ac(self, state, goal=None) -> np.ndarray:
        return self.world.get_action(0, state)
