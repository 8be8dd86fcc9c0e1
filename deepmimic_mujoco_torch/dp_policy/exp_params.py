"""Exploration-parameter annealing (copy of ``deepmimic_mujoco_tpu/
dp_policy/exp_params.py``): rate and noise interpolate from the initial to
the final values over the annealing samples."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ExpParams:
    rate: float = 0.2
    noise: float = 0.1
    noise_internal: float = 0.0
    temp: float = 0.1

    def lerp(self, other: "ExpParams", t: float) -> "ExpParams":
        t = min(max(t, 0.0), 1.0)
        return ExpParams(
            rate=(1 - t) * self.rate + t * other.rate,
            noise=(1 - t) * self.noise + t * other.noise,
            noise_internal=(1 - t) * self.noise_internal
            + t * other.noise_internal,
            temp=self.temp ** (1 - t) * other.temp ** t,
        )

    @staticmethod
    def from_json(d: dict) -> "ExpParams":
        return ExpParams(
            rate=d.get("Rate", 0.2), noise=d.get("Noise", 0.1),
            noise_internal=d.get("NoiseInternal", 0.0),
            temp=d.get("Temp", 0.1),
        )
