"""Path-structured replay buffer (copy of ``deepmimic_mujoco_tpu/dp_policy/
replay_buffer.py``): a flat ring of per-step records with per-path
bookkeeping, host-side numpy as the original's.

A path of n steps occupies n + 1 records, one per visited state; the last
is the bootstrap or terminal state, marked ``is_end`` with the path's
terminate flag.  The record order is part of the result: the trainer scans
the ring in order and samples indices from it.  A path's lists may also be
numpy arrays (the driver hands over slices of a rollout chunk)."""

from __future__ import annotations

import numpy as np

from deepmimic_mujoco_torch.dp_policy.path import Path, Terminate


class ReplayBuffer:
    def __init__(self, buffer_size: int):
        self.buffer_size = buffer_size
        self.total_count = 0     # total *sample* (action) count ever stored
        self.buffer_head = 0
        self.buffer_tail = 0
        self.num_paths = 0
        self._store: dict[str, np.ndarray] = {}
        self._path_id = np.full(buffer_size, -1, np.int64)
        self._is_end = np.zeros(buffer_size, bool)
        self._terminate = np.zeros(buffer_size, np.int8)
        self._flags = np.zeros(buffer_size, np.int32)
        self._curr_path = -1
        self._used = 0                # records currently occupied

    def get_current_size(self) -> int:
        """Number of records currently in the ring (path ends included)."""
        return self._used

    def count_filtered(self, flag: int) -> int:
        """Records whose flags carry ``flag``."""
        return int(np.sum((self._flags[:self._used] & flag) != 0))

    def store(self, path: Path) -> int:
        """Append a path as n + 1 records; returns its id."""
        n = path.pathlength()
        if n == 0:
            return -1
        self._curr_path += 1
        idx = (self.buffer_head + np.arange(n + 1)) % self.buffer_size

        def put(key, vals):
            vals = np.asarray(vals, np.float32)
            if key not in self._store:
                shape = (self.buffer_size,) + vals.shape[1:]
                self._store[key] = np.zeros(shape, np.float32)
            self._store[key][idx[:len(vals)]] = vals
            # the end record has no action, reward or logp
            self._store[key][idx[len(vals):]] = 0.0

        put("states", np.asarray(path.states)[:n + 1])
        put("actions", path.actions)
        put("rewards", path.rewards)
        if len(path.logps):
            put("logps", path.logps)
        if len(path.goals):
            put("goals", np.asarray(path.goals)[:n + 1])
        self._path_id[idx] = self._curr_path
        self._is_end[idx] = False
        self._is_end[idx[-1]] = True
        self._terminate[idx] = Terminate.NULL
        self._terminate[idx[-1]] = path.terminate
        self._flags[idx] = 0
        if len(path.flags):
            self._flags[idx[:n]] = np.asarray(path.flags, np.int32)
        self.buffer_head = int((idx[-1] + 1) % self.buffer_size)
        self.total_count += n
        self._used = min(self._used + n + 1, self.buffer_size)
        self.num_paths += 1
        return self._curr_path

    def sample(self, n: int, filter_end: bool = True,
               rng: np.random.RandomState | None = None) -> np.ndarray:
        """Sample record indices; with ``filter_end`` only records whose
        successor belongs to the same path (non-end records)."""
        rng = rng or np.random
        size = self.get_current_size()
        if size == 0:
            raise ValueError("sample from an empty replay buffer")
        cand = np.arange(size)
        if filter_end:
            nxt = (cand + 1) % self.buffer_size
            ok = (~self._is_end[cand]) & (self._path_id[cand] >= 0)
            ok &= self._path_id[nxt] == self._path_id[cand]
            cand = cand[ok]
        return rng.choice(cand, size=n, replace=len(cand) < n)

    def get_idx_filtered(self, flag: int) -> np.ndarray:
        """All record indices whose flags carry ``flag``."""
        idx = np.arange(self._used)
        return idx[(self._flags[idx] & flag) != 0]

    def get(self, key: str, idx: np.ndarray) -> np.ndarray:
        return self._store[key][idx]

    def get_all(self, key: str) -> np.ndarray:
        return self._store[key][:self._used]

    def get_next_idx(self, idx: np.ndarray) -> np.ndarray:
        return (idx + 1) % self.buffer_size

    def is_path_end(self, idx: np.ndarray) -> np.ndarray:
        return self._is_end[idx]

    def check_terminal_flag(self, idx: np.ndarray, flag: int) -> np.ndarray:
        return self._is_end[idx] & (self._terminate[idx] == flag)

    def end_mask(self) -> np.ndarray:
        return self._is_end[:self._used].copy()

    def fail_mask(self) -> np.ndarray:
        return self.end_mask() & (self._terminate[:self._used]
                                  == Terminate.FAIL)

    def succ_mask(self) -> np.ndarray:
        return self.end_mask() & (self._terminate[:self._used]
                                  == Terminate.SUCC)

    def flag_mask(self, flag: int) -> np.ndarray:
        return (self._flags[:self._used] & flag) != 0

    def clear(self):
        """Reset the ring (the on-policy trainer clears it after every
        train step)."""
        self.buffer_head = 0
        self.buffer_tail = 0
        self.num_paths = 0
        self._used = 0
        self._path_id[:] = -1
        self._is_end[:] = False
        self._flags[:] = 0
