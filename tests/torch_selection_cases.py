"""Depths with exact ties at and across the k-th place, for the tests of
the solver's selection (``tests/test_torch_selection.py`` against
``jax.lax.top_k``; ``tests/test_torch_cuda.py``, the card against the
CPU).  Imports no JAX."""

import numpy as np

CASES = ("all_equal", "straddle", "inactive_block", "random_integers")


def depths(case: str, n: int, k: int, seed: int) -> np.ndarray:
    """(6, n) f32 depths of one kind of tie; ``k`` is the cut."""
    rng = np.random.default_rng(seed)
    if case == "all_equal":
        rows = [np.zeros(n), np.full(n, -0.01), np.full(n, 0.25),
                np.full(n, -3.0), np.full(n, 1e-3), np.full(n, -1e-6)]
    elif case == "straddle":
        # k - 1 deeper entries, then two equal ones at the k-th and
        # (k+1)-th place, at shuffled positions
        rows = []
        for _ in range(6):
            d = rng.uniform(0.1, 1.0, n)
            order = rng.permutation(n)
            d[order[:k - 1]] = -rng.uniform(0.1, 1.0, k - 1) if k > 1 else []
            d[order[k - 1:k + 1]] = -0.05
            rows.append(d)
    elif case == "inactive_block":
        # a few active entries, the rest one block of equal positive depths
        rows = []
        for n_act in (0, 1, 3, k - 1, k, min(k + 2, n)):
            d = np.full(n, 0.04)
            act = rng.permutation(n)[:n_act]
            d[act] = -rng.uniform(0.001, 0.1, n_act)
            rows.append(d)
    elif case == "random_integers":
        rows = rng.integers(-3, 3, (6, n))
    else:
        raise ValueError(case)
    return np.asarray(rows, np.float32)
