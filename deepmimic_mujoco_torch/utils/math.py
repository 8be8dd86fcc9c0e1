"""Math utilities (port of ``deepmimic_mujoco_tpu/utils/math.py``).  Every
variance is the population variance (ddof 0, ``correction=0``), as
``jnp.var`` computes it."""

from __future__ import annotations

import torch


def explained_variance(ypred: torch.Tensor, y: torch.Tensor,
                       dim: int | None = None) -> torch.Tensor:
    """1 - Var[y - ypred]/Var[y] (over ``dim``, all axes when None); NaN
    when Var[y] == 0, like the reference."""
    vary = torch.var(y, dim=dim, correction=0)
    return 1.0 - torch.var(y - ypred, dim=dim, correction=0) / vary


def discount(x: torch.Tensor, gamma: float) -> torch.Tensor:
    """y[t] = Σ_k γ^k x[t+k] along the leading axis."""
    out = torch.empty_like(x)
    carry = torch.zeros_like(x[0])
    for t in range(x.shape[0] - 1, -1, -1):
        carry = x[t] + gamma * carry
        out[t] = carry
    return out


def discount_with_boundaries(x: torch.Tensor, new: torch.Tensor,
                             gamma: float) -> torch.Tensor:
    """Like :func:`discount`, reset at episode starts:
    y[t] = x[t] + γ·y[t+1]·(1 - new[t+1])."""
    nonterm = 1.0 - torch.cat([new[1:], torch.zeros_like(new[:1])]).to(x.dtype)
    out = torch.empty_like(x)
    carry = torch.zeros_like(x[0])
    for t in range(x.shape[0] - 1, -1, -1):
        carry = x[t] + gamma * carry * nonterm[t]
        out[t] = carry
    return out


def _tree_leaves(tree) -> list:
    """The leaves of a tree of dicts, lists, tuples and named tuples in
    ``jax.tree.leaves``' order: dict keys sorted, sequences in order, None
    an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _tree_leaves(t)]
    return [tree]


def _tree_rebuild(tree, leaves):
    """``tree`` with its leaves replaced, in :func:`_tree_leaves`' order,
    by the iterator ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        new = {k: _tree_rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: new[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        items = [_tree_rebuild(t, leaves) for t in tree]
        if hasattr(tree, "_fields"):
            return type(tree)(*items)
        return type(tree)(items)
    return next(leaves)


def flatten(tree):
    """A tree of tensors → (flat vector, unflatten), as
    ``jax.flatten_util.ravel_pytree`` does: the leaves raveled in
    ``jax.tree.leaves``' order (dict keys sorted, lists in order) into one
    vector of their promoted dtype; ``unflatten(v)`` rebuilds the tree with
    each leaf in its own shape and dtype."""
    leaves = [torch.as_tensor(x) for x in _tree_leaves(tree)]
    if not leaves:
        return torch.zeros(0), lambda flat: _tree_rebuild(tree, iter(()))
    dtype = leaves[0].dtype
    for x in leaves[1:]:
        dtype = torch.promote_types(dtype, x.dtype)
    flat = torch.cat([x.reshape(-1).to(dtype) for x in leaves])

    def unflatten(v: torch.Tensor):
        out, off = [], 0
        for x in leaves:
            out.append(v[off:off + x.numel()].reshape(x.shape).to(x.dtype))
            off += x.numel()
        return _tree_rebuild(tree, iter(out))

    return flat, unflatten
