"""Benchmark registry (port of ``deepmimic_mujoco_tpu/utils/benchmarks.py``,
the reference's ``bench/benchmarks.py``): name → {env_id, trials,
num_timesteps} suites for reproducible evaluation."""

from __future__ import annotations

_BENCHMARKS: list[dict] = []


def register_benchmark(benchmark: dict) -> None:
    for b in _BENCHMARKS:
        if b["name"] == benchmark["name"]:
            raise ValueError(
                f"Benchmark with name {benchmark['name']} already registered!")
    _BENCHMARKS.append(benchmark)


def list_benchmarks() -> list[str]:
    return [b["name"] for b in _BENCHMARKS]


def get_benchmark(benchmark_name: str) -> dict:
    for b in _BENCHMARKS:
        if b["name"] == benchmark_name:
            return b
    raise ValueError(
        f"{benchmark_name!r} not found! Known: {list_benchmarks()}")


def get_task(benchmark: dict, env_id: str) -> dict | None:
    return next((t for t in benchmark["tasks"] if t["env_id"] == env_id),
                None)


register_benchmark({
    "name": "DeepMimicStandup",
    "description": "dp_env_v3 alive-bonus standup/balance (the bundled baseline task)",
    "tasks": [{"env_id": "DPEnvV3", "trials": 3, "num_timesteps": int(1e6)}],
})

register_benchmark({
    "name": "DeepMimicImitation15",
    "description": "imitation reward across all 15 bundled skills",
    "tasks": [
        {"env_id": "DPEnvV3", "motion": m, "trials": 1,
         "num_timesteps": int(2e6)}
        for m in [
            "backflip", "cartwheel", "crawl", "dance_a", "dance_b",
            "getup_facedown", "getup_faceup", "jump", "kick", "punch",
            "roll", "run", "spin", "spinkick", "walk",
        ]
    ],
})
