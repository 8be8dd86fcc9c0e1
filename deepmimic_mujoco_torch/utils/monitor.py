"""Episode monitor (port of ``deepmimic_mujoco_tpu/utils/monitor.py``): a
CSV of one row {r, l, t} per finished episode under a JSON header line that
starts with '#', the format of the reference's ``bench/monitor.py``.
Episodes finish inside batched rollouts, so the rows are recorded after
each iteration from its per-episode stats."""

from __future__ import annotations

import csv
import json
import os
import time

EXT = "monitor.csv"


class Monitor:
    def __init__(self, filename: str, env_id: str = "dp_env_v3"):
        self.tstart = time.time()
        if not filename.endswith(EXT):
            if os.path.isdir(filename):
                filename = os.path.join(filename, EXT)
            else:
                filename = filename + "." + EXT
        self.f = open(filename, "wt")
        self.f.write("#%s\n" % json.dumps(
            {"t_start": self.tstart, "env_id": env_id}))
        self.writer = csv.DictWriter(self.f, fieldnames=("r", "l", "t"))
        self.writer.writeheader()
        self.f.flush()
        self.episode_rewards = []
        self.episode_lengths = []

    def record(self, ep_ret: float, ep_len: int) -> None:
        epinfo = {"r": round(float(ep_ret), 6), "l": int(ep_len),
                  "t": round(time.time() - self.tstart, 6)}
        self.episode_rewards.append(epinfo["r"])
        self.episode_lengths.append(epinfo["l"])
        self.writer.writerow(epinfo)
        self.f.flush()

    def close(self) -> None:
        self.f.close()


def load_results(path: str):
    """A monitor CSV read back as a pandas DataFrame of its episode rows,
    ``t`` made absolute by the header's ``t_start``, the header in
    ``df.attrs["headers"]``."""
    import pandas

    with open(path) as f:
        first = f.readline()
        if not first.startswith("#"):
            raise ValueError(f"{path!r} is not a monitor file")
        header = json.loads(first[1:])
        df = pandas.read_csv(f, index_col=None)
    df["t"] += header["t_start"]
    df.attrs["headers"] = header
    return df
