"""Reader of the JAX package's TRPO checkpoints: the function that carries
trained weights into the port (``deepmimic_mujoco_tpu/io_utils/
checkpoint.py`` writes them).

A checkpoint is an ``.npz`` of flattened pytree leaves ``leaf_i`` plus the
tree's structure as a string, ``__treedef__``.  For a ``TRPOState`` with an
``MlpPolicy`` the policy parameters are the first 16 leaves, in the order
JAX flattens the params dict (keys sorted):

  leaf_0        logstd (ac_dim,)
  leaf_1..3     ob_rms mean (ob_dim,), var (ob_dim,), count ()
  leaf_4..9     pol: (b, w) for each of the three layers
  leaf_10..15   vf:  (b, w) for each of the three layers

Optimizer and env state follow and are not read."""

from __future__ import annotations

import numpy as np
import torch

from deepmimic_mujoco_torch.models.policy import MlpPolicy
from deepmimic_mujoco_torch.utils.running_stats import RunningMeanStd

_TREEDEF_HEAD = (
    "PyTreeDef(CustomNode(TRPOState[()], [{'logstd': *, 'ob_rms': "
    "CustomNode(namedtuple[RunningMeanStd], [*, *, *]), 'pol': [{'b': *, "
    "'w': *}, {'b': *, 'w': *}, {'b': *, 'w': *}], 'vf': [{'b': *, 'w': *}, "
    "{'b': *, 'w': *}, {'b': *, 'w': *}]}, CustomNode(namedtuple[AdamState], "
    "[*, *, *]), CustomNode(EnvState[()], [*, *, *, *, *, *, *, *, *")
# EnvState gained a trailing ``clip_id`` field (None for single-clip envs)
# after the bundled checkpoints were written; the policy leaves come first
# and sit at the same positions either way.
TRPO_STATE_TREEDEFS = (
    _TREEDEF_HEAD + "]), *, *, *, *]))",
    _TREEDEF_HEAD + ", None]), *, *, *, *]))",
)


def from_numpy_params(params: dict, device: torch.device | str) -> dict:
    """A params dict with numpy leaves, in the JAX package's structure
    (``ob_rms`` a (mean, var, count) triple), → the port's params."""
    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    mean, var, count = params["ob_rms"]
    return {
        "pol": [{"w": t(layer["w"]), "b": t(layer["b"])}
                for layer in params["pol"]],
        "vf": [{"w": t(layer["w"]), "b": t(layer["b"])}
               for layer in params["vf"]],
        "logstd": t(params["logstd"]),
        "ob_rms": RunningMeanStd(t(mean), t(var), t(count)),
    }


def load_trpo_params(path: str, policy: MlpPolicy,
                     device: torch.device | str) -> dict:
    """The policy parameters of a TRPO checkpoint written by the JAX
    package, checked against its structure string and ``policy``'s shapes."""
    with np.load(path, allow_pickle=False) as z:
        treedef = bytes(z["__treedef__"]).decode()
        leaves = [z[f"leaf_{i}"] for i in range(16)]
    if treedef not in TRPO_STATE_TREEDEFS:
        raise ValueError(
            f"{path!r} is not a TRPOState checkpoint of a 3-layer MlpPolicy:"
            f"\n  saved:    {treedef}\n  expected: {TRPO_STATE_TREEDEFS[0]}")

    def layers(flat):
        return [{"b": flat[2 * k], "w": flat[2 * k + 1]} for k in range(3)]

    params = {"logstd": leaves[0], "ob_rms": tuple(leaves[1:4]),
              "pol": layers(leaves[4:10]), "vf": layers(leaves[10:16])}
    if policy.num_hid_layers != 2:
        raise ValueError("the checkpoint holds 3-layer MLPs; policy has "
                         f"{policy.num_hid_layers} hidden layers")
    sizes = policy.sizes
    for head, out in (("pol", policy.ac_dim), ("vf", 1)):
        for k, (n_in, n_out) in enumerate(zip(sizes, sizes[1:] + [out])):
            w, b = params[head][k]["w"], params[head][k]["b"]
            if w.shape != (n_in, n_out) or b.shape != (n_out,):
                raise ValueError(
                    f"{path!r}: {head} layer {k} has w {w.shape}, b {b.shape};"
                    f" the policy expects ({n_in}, {n_out}), ({n_out},)")
    if params["logstd"].shape != (policy.ac_dim,):
        raise ValueError(f"{path!r}: logstd shape {params['logstd'].shape}")
    return from_numpy_params(params, device)
