"""Learning-curve plotting (port of ``deepmimic_mujoco_tpu/utils/
plotting.py``, the reference's ``plot_curve.py`` and ``plot_util.py``):
load monitor CSVs, smooth, and draw reward-vs-steps figures.  matplotlib
and pandas are imported inside the functions that use them (matplotlib on
its ``Agg`` backend)."""

from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np


def symmetric_ema(xolds, yolds, low=None, high=None, n=512, decay_steps=1.0):
    """Symmetric exponential-moving-average resampling: the average of a
    forward and a backward EMA on a regular grid of ``n`` points."""
    xolds = np.asarray(xolds, np.float64)
    yolds = np.asarray(yolds, np.float64)
    low = xolds[0] if low is None else low
    high = xolds[-1] if high is None else high
    xnews = np.linspace(low, high, n)
    decay_period = (high - low) / (n - 1) * decay_steps

    def one_sided(xolds, yolds, xnews):
        luoi = 0
        sum_y = 0.0
        count_y = 0.0
        ynews = np.zeros_like(xnews)
        counts = np.zeros_like(xnews)
        interstep_decay = np.exp(-1.0 / decay_steps)
        for i, xnew in enumerate(xnews):
            while luoi < len(xolds) and xolds[luoi] <= xnew:
                decay = np.exp(-(xnew - xolds[luoi]) / decay_period)
                sum_y += decay * yolds[luoi]
                count_y += decay
                luoi += 1
            ynews[i] = sum_y / count_y if count_y > 1e-9 else np.nan
            counts[i] = count_y
            sum_y *= interstep_decay
            count_y *= interstep_decay
        return ynews, counts

    y_fwd, c_fwd = one_sided(xolds, yolds, xnews)
    y_bwd, c_bwd = one_sided(-xolds[::-1], yolds[::-1], -xnews[::-1])
    y_bwd, c_bwd = y_bwd[::-1], c_bwd[::-1]
    tot = c_fwd + c_bwd
    ys = np.where(tot > 1e-9,
                  (np.nan_to_num(y_fwd) * c_fwd + np.nan_to_num(y_bwd) * c_bwd)
                  / np.maximum(tot, 1e-9),
                  np.nan)
    return xnews, ys, tot


def smooth(y, radius: int, mode: str = "two_sided"):
    """Moving-average smoothing over 2·radius + 1 points (``two_sided``) or
    the last ``radius`` points (``causal``)."""
    y = np.asarray(y, np.float64)
    if len(y) < 2 * radius + 1:
        return np.ones_like(y) * y.mean()
    if mode == "two_sided":
        conv = np.ones(2 * radius + 1)
        return np.convolve(y, conv, mode="same") / np.convolve(
            np.ones_like(y), conv, mode="same")
    conv = np.ones(radius)
    out = np.convolve(y, conv, mode="full") / np.convolve(
        np.ones_like(y), conv, mode="full")
    return out[: len(y)]


def load_monitor_results(dirname: str):
    """Every monitor CSV under a directory (sorted by path) → a list of
    DataFrames."""
    from deepmimic_mujoco_torch.utils.monitor import load_results

    files = sorted(glob.glob(os.path.join(dirname, "**", "*monitor.csv"),
                             recursive=True))
    return [load_results(f) for f in files]


def plot_results(dirs, out_path: Optional[str] = None, xy_fn=None,
                 split_fn=None, group_fn=None, average_group: bool = False,
                 shaded_std: bool = True, figsize=(8, 5)):
    """One curve per run of every directory's monitor CSVs, or, with
    ``average_group``, one mean curve per group with a ±std band.  Saves
    to ``out_path`` and returns it, or returns the figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if isinstance(dirs, str):
        dirs = [dirs]
    runs = []
    for d in dirs:
        for df in load_monitor_results(d):
            runs.append((d, df))
    group_fn = group_fn or (lambda run: run[0])
    xy_fn = xy_fn or (lambda run: (
        np.cumsum(run[1]["l"].values), smooth(run[1]["r"].values, 10)))

    groups: dict = {}
    for run in runs:
        groups.setdefault(group_fn(run), []).append(xy_fn(run))

    fig, ax = plt.subplots(figsize=figsize)
    for gname, xys in sorted(groups.items()):
        if average_group and len(xys) > 1:
            low = max(x[0] for x, _ in xys)
            high = min(x[-1] for x, _ in xys)
            grid = np.linspace(low, high, 256)
            ys = np.stack([np.interp(grid, x, y) for x, y in xys])
            mean, std = ys.mean(0), ys.std(0)
            ax.plot(grid, mean, label=str(gname))
            if shaded_std:
                ax.fill_between(grid, mean - std, mean + std, alpha=0.2)
        else:
            for x, y in xys:
                ax.plot(x, y, label=str(gname))
    ax.legend()
    ax.set_xlabel("environment steps")
    ax.set_ylabel("episode reward")
    if out_path:
        fig.savefig(out_path)
        plt.close(fig)
        return out_path
    return fig


def plot_curve(log_dir: str, out_path: Optional[str] = None,
               env_name: str = "DeepMimic", radius: int = 10):
    """Reward-vs-steps figure of the monitor CSVs under ``log_dir``
    (default path ``figures/<env_name>-reward.svg``).  Returns the path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    dfs = load_monitor_results(log_dir)
    if not dfs:
        raise FileNotFoundError(f"no monitor CSVs under {log_dir}")
    fig, ax = plt.subplots(figsize=(8, 5))
    for df in dfs:
        steps = np.cumsum(df["l"].values)
        rews = smooth(df["r"].values, radius)
        ax.plot(steps, rews)
    ax.set_xlabel("environment steps")
    ax.set_ylabel("episode reward")
    ax.set_title(f"{env_name} reward")
    if out_path is None:
        out_path = os.path.join("figures", f"{env_name}-reward.svg")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path)
    plt.close(fig)
    return out_path
