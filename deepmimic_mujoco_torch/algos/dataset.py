"""Minibatch iterators and the GAIL expert dataset (a numpy copy of
``deepmimic_mujoco_tpu/algos/dataset.py``; the port imports nothing of the
JAX package).

* :class:`Dataset` / :func:`iterbatches` — shuffled dict-of-arrays and
  array-tuple batchers;
* :class:`MujocoDset` — the expert dataset: loads an ``.npz`` of
  obs/acs/ep_rets (ragged object arrays of one episode each, a dense
  export with ``lens``, or dense (N, T, d) arrays), applies
  ``traj_limitation``, splits train/val and serves sequential
  ``get_next_batch`` with a reshuffle on wrap.  ``dset``, ``train_set`` and
  ``val_set`` share one ``np.random.RandomState(seed)``, as in JAX, so the
  batches are the same arrays in both stacks.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class Dset:
    """Pointer-based shuffled sampler (mujoco_dset.py:11-40)."""

    def __init__(self, inputs, labels, randomize=True, rng=None):
        self.inputs = inputs
        self.labels = labels
        if len(self.inputs) != len(self.labels):
            raise ValueError(f"{len(self.inputs)} inputs, "
                             f"{len(self.labels)} labels")
        self.randomize = randomize
        self.rng = rng or np.random.RandomState(0)
        self.init_pointer()

    def init_pointer(self):
        self.pointer = 0
        if self.randomize:
            idx = np.arange(self.inputs.shape[0])
            self.rng.shuffle(idx)
            self.inputs = self.inputs[idx]
            self.labels = self.labels[idx]

    def get_next_batch(self, batch_size):
        if batch_size < 0:
            return self.inputs, self.labels
        if self.pointer + batch_size >= self.inputs.shape[0]:
            self.init_pointer()
        end = self.pointer + batch_size
        inputs = self.inputs[self.pointer:end]
        labels = self.labels[self.pointer:end]
        self.pointer = end
        return inputs, labels


class MujocoDset:
    """Expert trajectory dataset (mujoco_dset.py:62-142)."""

    def __init__(self, expert_path: str, train_fraction: float = 0.7,
                 traj_limitation: int = -1, randomize: bool = True, seed: int = 0):
        traj_data = np.load(expert_path, allow_pickle=True)
        if traj_limitation < 0:
            traj_limitation = len(traj_data["obs"])
        obs = traj_data["obs"][:traj_limitation]
        acs = traj_data["acs"][:traj_limitation]

        # (N_traj, T, d) → (N_traj*T, d); ragged object arrays flatten per-traj
        if obs.dtype == object:
            self.obs = np.vstack([np.asarray(o).reshape(len(o), -1) for o in obs])
            self.acs = np.vstack([np.asarray(a).reshape(len(a), -1) for a in acs])
        elif "lens" in traj_data.files:
            # dense batched export (runner.evaluate): rows past each
            # episode's length are frozen-state padding — drop them, or the
            # discriminator trains on terminal-pose duplicates
            lens = np.asarray(traj_data["lens"][:traj_limitation], np.int64)
            mask = np.arange(obs.shape[1])[None, :] < lens[:, None]
            self.obs = obs[mask]
            self.acs = acs[mask]
        else:
            self.obs = obs.reshape(-1, obs.shape[-1])
            self.acs = acs.reshape(-1, acs.shape[-1])

        self.rets = traj_data["ep_rets"][:traj_limitation]
        self.avg_ret = float(np.mean(self.rets)) if len(self.rets) else 0.0
        self.std_ret = float(np.std(np.array(self.rets))) if len(self.rets) else 0.0
        if len(self.obs) != len(self.acs):
            raise ValueError(f"{expert_path!r}: {len(self.obs)} obs rows, "
                             f"{len(self.acs)} action rows")
        self.num_traj = min(traj_limitation, len(traj_data["obs"]))
        self.num_transition = len(self.obs)
        self.randomize = randomize
        rng = np.random.RandomState(seed)
        self.dset = Dset(self.obs, self.acs, self.randomize, rng)
        n_train = int(self.num_transition * train_fraction)
        self.train_set = Dset(self.obs[:n_train], self.acs[:n_train], self.randomize, rng)
        self.val_set = Dset(self.obs[n_train:], self.acs[n_train:], self.randomize, rng)

    def get_next_batch(self, batch_size: int, split: Optional[str] = None):
        if split is None:
            return self.dset.get_next_batch(batch_size)
        if split == "train":
            return self.train_set.get_next_batch(batch_size)
        if split == "val":
            return self.val_set.get_next_batch(batch_size)
        raise NotImplementedError


class Dataset:
    """Shuffled dict-of-arrays batcher (reference dataset.py:1-48)."""

    def __init__(self, data_map: dict, deterministic: bool = False, seed: int = 0):
        self.data_map = data_map
        self.deterministic = deterministic
        self.enable_shuffle = True
        self.n = next(iter(data_map.values())).shape[0]
        self._next_id = 0
        self.rng = np.random.RandomState(seed)
        self.shuffle()

    def shuffle(self):
        if self.deterministic:
            return
        perm = np.arange(self.n)
        self.rng.shuffle(perm)
        for key in self.data_map:
            self.data_map[key] = self.data_map[key][perm]
        self._next_id = 0

    def next_batch(self, batch_size):
        if self._next_id >= self.n and self.enable_shuffle:
            self.shuffle()
        cur_id = self._next_id
        cur_batch_size = min(batch_size, self.n - self._next_id)
        self._next_id += cur_batch_size
        return {k: v[cur_id:cur_id + cur_batch_size] for k, v in self.data_map.items()}

    def iterate_once(self, batch_size):
        if self.enable_shuffle:
            self.shuffle()
        while self._next_id <= self.n - batch_size:
            yield self.next_batch(batch_size)
        self._next_id = 0


def iterbatches(arrays, *, num_batches=None, batch_size=None, shuffle=True,
                include_final_partial_batch=True, rng=None):
    """reference dataset.py:50-60."""
    if (num_batches is None) == (batch_size is None):
        raise ValueError("give exactly one of num_batches and batch_size")
    arrays = tuple(map(np.asarray, arrays))
    n = arrays[0].shape[0]
    if any(a.shape[0] != n for a in arrays[1:]):
        raise ValueError("the arrays differ in length")
    inds = np.arange(n)
    if shuffle:
        (rng or np.random).shuffle(inds)
    sections = np.arange(0, n, batch_size)[1:] if num_batches is None else num_batches
    for batch_inds in np.array_split(inds, sections):
        if include_final_partial_batch or len(batch_inds) == batch_size:
            yield tuple(a[batch_inds] for a in arrays)
