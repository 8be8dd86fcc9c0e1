"""Trajectory container (copy of ``deepmimic_mujoco_tpu/dp_policy/
path.py``).  A path of n steps holds n + 1 states (the last is the
terminal or bootstrap state) and n actions, rewards, logps and flags."""

from __future__ import annotations

import numpy as np


class Terminate:
    NULL = 0
    FAIL = 1
    SUCC = 2


class Path:
    def __init__(self):
        self.clear()

    def clear(self):
        self.states: list = []
        self.goals: list = []
        self.actions: list = []
        self.logps: list = []
        self.rewards: list = []
        self.flags: list = []
        self.terminate = Terminate.NULL

    def pathlength(self) -> int:
        return len(self.actions)

    def is_valid(self) -> bool:
        n = self.pathlength()
        return (len(self.states) == n + 1 and len(self.actions) == n
                and len(self.rewards) == n)

    def calc_return(self) -> float:
        return float(np.sum(self.rewards))
