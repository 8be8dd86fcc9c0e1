"""TRPO checkpoints in the JAX package's format (``deepmimic_mujoco_tpu/
io_utils/checkpoint.py``): the reader that carries trained weights and whole
training states into the port, and the writer of the port's states.

A checkpoint is an ``.npz`` of flattened pytree leaves ``leaf_i`` plus the
tree's structure as a string, ``__treedef__``.  A ``TRPOState`` with an
``MlpPolicy`` of L layers (3 for the default 100×2 net) flattens as JAX
flattens it (dataclass fields in order, dict keys sorted):

  leaf_0                logstd (ac_dim,)
  leaf_1..3             ob_rms mean (ob_dim,), var (ob_dim,), count ()
  then 2L leaves        pol: (b, w) for each layer
  then 2L leaves        vf:  (b, w) for each layer
  then 3 leaves         vf_adam m, v (n_vf,), t () float32
  then 9 leaves         env_state qpos, qvel, obs, reward (float32), done
                        (bool), mocap_idx, init_idx, step_count (int32),
                        key (B, 2) uint32
  then 4 leaves         new (B,) bool, key (2,) uint32, cur_ep_ret (B,)
                        float32, cur_ep_len (B,) int32

(leaf_0..15 hold the policy for L = 3.)"""

from __future__ import annotations

import os
import types

import numpy as np
import torch

from deepmimic_mujoco_torch.algos import adam
from deepmimic_mujoco_torch.algos.trpo import TRPO, Draws, TRPOState
from deepmimic_mujoco_torch.envs.types import EnvState
from deepmimic_mujoco_torch.models.policy import MlpPolicy
from deepmimic_mujoco_torch.utils.running_stats import RunningMeanStd

_ENV_FIELDS = ("qpos", "qvel", "obs", "reward", "done", "mocap_idx",
               "init_idx", "step_count")


def trpo_state_treedef(n_layers: int = 3, clip_id: bool = True) -> str:
    """The structure string of a JAX ``TRPOState`` whose MLPs have
    ``n_layers`` layers.  ``EnvState`` gained a trailing ``clip_id`` field
    (None for single-clip envs) after the bundled checkpoints were written:
    ``clip_id=False`` gives their older string."""
    mlp = "[" + ", ".join(["{'b': *, 'w': *}"] * n_layers) + "]"
    env = ", ".join(["*"] * 9) + (", None" if clip_id else "")
    return ("PyTreeDef(CustomNode(TRPOState[()], [{'logstd': *, 'ob_rms': "
            "CustomNode(namedtuple[RunningMeanStd], [*, *, *]), "
            f"'pol': {mlp}, 'vf': {mlp}}}, "
            "CustomNode(namedtuple[AdamState], [*, *, *]), "
            f"CustomNode(EnvState[()], [{env}]), *, *, *, *]))")


# the structures of a 3-layer MlpPolicy's TRPOState, before and after
# clip_id; the policy leaves come first and sit at the same positions
TRPO_STATE_TREEDEFS = (trpo_state_treedef(3, False), trpo_state_treedef(3))


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


def from_numpy_state(state, draws: Draws,
                     device: torch.device | str) -> TRPOState:
    """A TRPO state with numpy leaves in the JAX package's structure (the
    JAX ``TRPOState`` mapped to numpy, or what :func:`load_trpo_state`
    reads) → the port's ``TRPOState``; ``draws`` takes the place of the
    JAX PRNG key.  :func:`from_numpy_params` extended to the whole state."""
    def t(x, dtype):
        return torch.as_tensor(np.asarray(x), device=device).to(dtype)

    m, v, step = state.vf_adam
    es = state.env_state
    f32, i64 = torch.float32, torch.int64
    return TRPOState(
        params=from_numpy_params(state.params, device),
        vf_adam=adam.AdamState(t(m, f32), t(v, f32), t(step, f32)),
        env_state=EnvState(**{
            f: t(getattr(es, f), {"done": torch.bool}.get(
                f, i64 if f in _ENV_FIELDS[5:] else f32))
            for f in _ENV_FIELDS}),
        new=t(state.new, torch.bool), draws=draws,
        cur_ep_ret=t(state.cur_ep_ret, f32),
        cur_ep_len=t(state.cur_ep_len, torch.int32))


def _read(path: str, policy: MlpPolicy) -> tuple[list, str]:
    """All leaves of a TRPOState checkpoint of ``policy``'s depth, checked
    against its structure string and ``policy``'s shapes."""
    n_layers = len(policy.sizes)
    with np.load(path, allow_pickle=False) as z:
        treedef = bytes(z["__treedef__"]).decode()
        accepted = (trpo_state_treedef(n_layers, False),
                    trpo_state_treedef(n_layers))
        if treedef not in accepted:
            raise ValueError(
                f"{path!r} is not a TRPOState checkpoint of a "
                f"{n_layers}-layer MlpPolicy:\n  saved:    {treedef}\n"
                f"  expected: {accepted[1]}")
        leaves = [z[f"leaf_{i}"] for i in range(len(z.files) - 1)]
    sizes = policy.sizes
    pol = leaves[4:4 + 2 * n_layers]
    vf = leaves[4 + 2 * n_layers:4 + 4 * n_layers]
    for head, flat, out in (("pol", pol, policy.ac_dim), ("vf", vf, 1)):
        for k, (n_in, n_out) in enumerate(zip(sizes, sizes[1:] + [out])):
            b, w = flat[2 * k], flat[2 * k + 1]
            if w.shape != (n_in, n_out) or b.shape != (n_out,):
                raise ValueError(
                    f"{path!r}: {head} layer {k} has w {w.shape}, b {b.shape};"
                    f" the policy expects ({n_in}, {n_out}), ({n_out},)")
    if leaves[0].shape != (policy.ac_dim,):
        raise ValueError(f"{path!r}: logstd shape {leaves[0].shape}")
    return leaves, treedef


def _params(leaves: list, n_layers: int) -> dict:
    def layers(flat):
        return [{"b": flat[2 * k], "w": flat[2 * k + 1]}
                for k in range(n_layers)]

    return {"logstd": leaves[0], "ob_rms": tuple(leaves[1:4]),
            "pol": layers(leaves[4:4 + 2 * n_layers]),
            "vf": layers(leaves[4 + 2 * n_layers:4 + 4 * n_layers])}


def load_trpo_params(path: str, policy: MlpPolicy,
                     device: torch.device | str) -> dict:
    """The policy parameters of a TRPO checkpoint (written by the JAX
    package or by :func:`save`), checked against its structure string and
    ``policy``'s shapes."""
    leaves, _ = _read(path, policy)
    return from_numpy_params(_params(leaves, len(policy.sizes)), device)


def load_trpo_state(path: str, learner: TRPO, draws: Draws) -> TRPOState:
    """The whole training state of a TRPO checkpoint (written by the JAX
    package or by :func:`save`) for ``learner``: params, ``vf_adam``, env
    state, ``new`` and the episode accounting.  The checkpoint's PRNG keys
    are not read: ``draws`` gives the port's random draws."""
    leaves, _ = _read(path, learner.policy)
    n = 4 + 4 * len(learner.policy.sizes)
    env = leaves[n + 3:n + 12]
    if env[0].shape[0] != learner.cfg.num_envs:
        raise ValueError(f"{path!r} holds {env[0].shape[0]} envs; the "
                         f"learner runs {learner.cfg.num_envs}")
    state = types.SimpleNamespace(
        params=_params(leaves, len(learner.policy.sizes)),
        vf_adam=tuple(leaves[n:n + 3]),
        env_state=types.SimpleNamespace(**dict(zip(_ENV_FIELDS, env))),
        new=leaves[n + 12], cur_ep_ret=leaves[n + 14],
        cur_ep_len=leaves[n + 15])
    return from_numpy_state(state, draws, learner.device)


def save(path: str, state: TRPOState) -> str:
    """Write ``state`` to ``<path>.npz`` in the JAX layout, under the
    structure string of the current JAX ``TRPOState`` (``clip_id`` None),
    with JAX's dtypes.  The port has no JAX PRNG keys: it writes distinct
    raw threefry keys in the layout of ``jax.random.PRNGKey(k)``, ``[0, k]``
    — env e's key is ``[0, e]``, the state's ``[0, B]``.  Returns the
    file's path."""
    def np_(x, dtype=np.float32):
        return x.detach().cpu().numpy().astype(dtype)

    p, es = state.params, state.env_state
    B = es.qpos.shape[0]
    mlp = [x for head in ("pol", "vf") for layer in p[head]
           for x in (layer["b"], layer["w"])]
    leaves = ([p["logstd"], *p["ob_rms"], *mlp, *state.vf_adam]
              + [getattr(es, f) for f in _ENV_FIELDS[:4]])
    leaves = [np_(x) for x in leaves] + [
        np_(es.done, np.bool_),
        *(np_(getattr(es, f), np.int32) for f in _ENV_FIELDS[5:]),
        np.stack([np.zeros(B, np.uint32), np.arange(B, dtype=np.uint32)], 1),
        np_(state.new, np.bool_), np.array([0, B], np.uint32),
        np_(state.cur_ep_ret), np_(state.cur_ep_len, np.int32)]
    treedef = trpo_state_treedef(len(p["pol"]))
    path = path if path.endswith(".npz") else path + ".npz"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, __treedef__=np.frombuffer(treedef.encode(), np.uint8),
             **{f"leaf_{i}": x for i, x in enumerate(leaves)})
    return path
