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

    def record(self, ep_ret: float, ep_len: int) -> None:
        epinfo = {"r": round(float(ep_ret), 6), "l": int(ep_len),
                  "t": round(time.time() - self.tstart, 6)}
        self.writer.writerow(epinfo)
        self.f.flush()

    def close(self) -> None:
        self.f.close()
