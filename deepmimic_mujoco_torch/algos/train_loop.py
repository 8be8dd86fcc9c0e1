"""Host-side training loop (port of ``deepmimic_mujoco_tpu/algos/
train_loop.py:train``): runs the iterations of a TRPO or PPO learner with
the tabular log, the per-episode monitor and checkpoints (``trpo_state.npz``
for either learner, as JAX names them) at iteration 0, every
``save_per_iter`` iterations and at the end."""

from __future__ import annotations

import dataclasses
import os
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from deepmimic_mujoco_torch.algos.ppo import PPO
from deepmimic_mujoco_torch.algos.trpo import TRPO, Draws
from deepmimic_mujoco_torch.io_utils import checkpoint
from deepmimic_mujoco_torch.utils import logger
from deepmimic_mujoco_torch.utils.monitor import Monitor


def train(learner: TRPO | PPO, seed: int = 0, max_timesteps: int = 0,
          max_iters: int = 0, ckpt_dir: Optional[str] = None,
          log_dir: Optional[str] = None, save_per_iter: int = 100,
          resume_from: Optional[str] = None, verbose: bool = True,
          override_logstd: Optional[float] = None):
    """Train until ``max_timesteps`` env steps or ``max_iters`` iterations
    (exactly one of them); returns the learner's final state.
    ``resume_from``: a checkpoint of the learner's kind whose whole state
    (params, Adam, envs, episode accounting) the run continues from;
    ``override_logstd`` then sets the exploration logstd, which the
    checkpoint's value would otherwise fix."""
    if (max_timesteps > 0) == (max_iters > 0):
        raise ValueError("specify exactly one of max_timesteps / max_iters")
    monitor = None
    if log_dir is not None:
        logger.configure(log_dir)
        monitor = Monitor(os.path.join(log_dir, "monitor.json"))

    generator = torch.Generator(device=learner.device).manual_seed(seed)
    if resume_from is not None:
        load = (checkpoint.load_ppo_state if isinstance(learner, PPO)
                else checkpoint.load_trpo_state)
        state = load(resume_from, learner, Draws(generator))
    else:
        state = learner.init(generator)
    if override_logstd is not None:
        params = dict(state.params, logstd=torch.full_like(
            state.params["logstd"], float(override_logstd)))
        state = dataclasses.replace(state, params=params)

    lenbuffer: deque = deque(maxlen=40)
    rewbuffer: deque = deque(maxlen=40)
    episodes_so_far = timesteps_so_far = counted_so_far = iters_so_far = 0
    tstart = time.time()
    try:
        while True:
            if max_timesteps and timesteps_so_far >= max_timesteps:
                break
            if max_iters and iters_so_far >= max_iters:
                break
            if ckpt_dir is not None and iters_so_far % save_per_iter == 0:
                checkpoint.save(os.path.join(ckpt_dir, "trpo_state"), state)

            state, stats = learner.iteration(state)

            # NaN tripwire: a corrupted state would otherwise propagate
            if not np.isfinite(float(stats.meankl)):
                raise FloatingPointError(
                    f"non-finite meankl at iter {iters_so_far}; aborting "
                    "(resume from the last checkpoint)")
            ep_count = int(stats.ep_count)
            if ep_count > 0:
                # one record per finished episode, in completion order
                lens = stats.ep_lens.reshape(-1).cpu().numpy()
                rets = stats.ep_rets.reshape(-1).cpu().numpy()
                ended = lens > 0
                for r, n in zip(rets[ended], lens[ended]):
                    rewbuffer.append(float(r))
                    lenbuffer.append(int(n))
                    if monitor is not None:
                        monitor.record(float(r), int(n))
            episodes_so_far += ep_count
            timesteps_so_far += int(stats.timesteps)
            counted_so_far += int(stats.ep_len_sum_last)
            iters_so_far += 1

            if verbose:
                for key in ("optimgain", "meankl", "entloss", "surrgain",
                            "entropy", "ev_tdlam_before"):
                    logger.record_tabular(key, float(getattr(stats, key)))
                logger.record_tabular(
                    "EpLenMean", np.mean(lenbuffer) if lenbuffer else np.nan)
                logger.record_tabular(
                    "EpRewMean", np.mean(rewbuffer) if rewbuffer else np.nan)
                logger.record_tabular("EpThisIter", ep_count)
                logger.record_tabular("EpisodesSoFar", episodes_so_far)
                logger.record_tabular("TimestepsSoFar", timesteps_so_far)
                # the reference's TimestepsSoFar counts only the steps of
                # episodes completed in the last segment
                logger.record_tabular("RefCountedSteps", counted_so_far)
                logger.record_tabular("TimeElapsed", time.time() - tstart)
                logger.dump_tabular()

        if ckpt_dir is not None:
            checkpoint.save(os.path.join(ckpt_dir, "trpo_state"), state)
    finally:
        if monitor is not None:
            monitor.close()
    return state
