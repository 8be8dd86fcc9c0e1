#!/usr/bin/env python3
"""Data-parallel scaling benchmark: TRPO iteration throughput against the
number of ranks (port of ``tools/scaling_bench.py``).

For each size n of ``--devices``: TRPO on ``DPEnvV3(clip="walk")`` with
the default ``MlpPolicy`` and ``TRPOConfig(horizon, num_envs =
envs-per-device·n, g_step=1)``, the env batch split over n ranks and the
parameters replicated (``parallel/``: one process per rank, the learners'
collectives).  One warm-up iteration, then ``--iters`` timed ones; one JSON
line per size with the JAX tool's keys: ``devices``, ``env_steps_per_s``
and ``scaling_efficiency``, the env-steps/s over the first size's scaled
by n / first.

On the CUDA card (the default) each rank has a card of its own and the
ranks talk over NCCL; a size above the card count raises.  With
``--platform cpu`` the n ranks are gloo processes on the host, the
counterpart of JAX's virtual host devices: they share the host's cores, so
the figures check the path, not the speed-up.  A size of 1 runs in this
process.

    python -m deepmimic_mujoco_torch.cli.scaling_bench --platform cpu --devices 1,2
    python -m deepmimic_mujoco_torch.cli.scaling_bench --devices 1
"""

from __future__ import annotations

import argparse
import json
import time

import torch
import torch.distributed as dist

from deepmimic_mujoco_torch.parallel.dryrun import (
    rank_draws,
    shard_state,
    walk_learner,
)
from deepmimic_mujoco_torch.parallel.mesh import launch, rank_device, replicate
from deepmimic_mujoco_torch.utils.device import PLATFORMS, resolve_device

SEED = 0


def scale_rank(rank: int, world: int, device: str, envs_per_device: int,
               horizon: int, iters: int) -> float:
    """Seconds of ``iters`` TRPO iterations on this rank, after one
    warm-up iteration, the ranks started together by a barrier."""
    dev = rank_device(device)
    group = dist.group.WORLD if world > 1 else None
    glob = walk_learner(dev, envs_per_device * world, horizon)
    state = shard_state(glob.init(torch.Generator(device=dev).manual_seed(
        SEED)), rank, world, rank_draws(SEED, rank, dev))
    learner = walk_learner(dev, envs_per_device, horizon, group)
    replicate(state.params, group)
    state, _ = learner.iteration(state)          # warm-up
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if group is not None:
        dist.barrier(group)
    t0 = time.perf_counter()
    for _ in range(iters):
        state, _ = learner.iteration(state)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def run_one(n_devices: int, envs_per_device: int, horizon: int, iters: int,
            device: torch.device) -> float:
    """Env-steps/s of ``n_devices`` ranks: every rank's env steps over the
    slowest rank's seconds."""
    if device.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"need {n_devices} devices, have "
                           f"{torch.cuda.device_count()}")
    args = (device.type, envs_per_device, horizon, iters)
    if n_devices == 1:
        seconds = [scale_rank(0, 1, *args)]
    else:
        seconds = launch(scale_rank, n_devices,
                         "nccl" if device.type == "cuda" else "gloo",
                         args=args, device=device.type)
    return iters * horizon * envs_per_device * n_devices / max(seconds)


def efficiency(results: dict, sizes: list, n: int) -> float:
    """The JAX tool's scaling efficiency of size ``n``: its env-steps/s over
    the first size's times n / first, to 3 decimals."""
    base = results[sizes[0]]
    return round(results[n] / (base * n / sizes[0]), 3)


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--devices", default="1,2,4,8")
    p.add_argument("--envs-per-device", type=int, default=64)
    p.add_argument("--horizon", type=int, default=32)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--platform", default=None, choices=sorted(PLATFORMS),
                   help="cpu: gloo ranks on the host (default: the card)")
    args = p.parse_args(argv)
    device = resolve_device(PLATFORMS.get(args.platform))

    sizes = [int(s) for s in args.devices.split(",")]
    results, rows = {}, []
    for n in sizes:
        sps = run_one(n, args.envs_per_device, args.horizon, args.iters,
                      device)
        results[n] = round(sps, 1)
        rows.append({"devices": n, "env_steps_per_s": results[n],
                     "scaling_efficiency": efficiency(results, sizes, n)})
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
