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
  (then 1 leaf          clip_id (B,) int32, multi-clip envs only)
  then 4 leaves         new (B,) bool, key (2,) uint32, cur_ep_ret (B,)
                        float32, cur_ep_len (B,) int32

(leaf_0..15 hold the policy for L = 3.)  A file of independent learners
(the lane tool's ``imit15_state.npz``) has the same leaves with every leaf
stacked on a new leading lane axis, under the same structure string."""

from __future__ import annotations

import os
import types

import numpy as np
import torch

from deepmimic_mujoco_torch.algos import adam
from deepmimic_mujoco_torch.algos.lanes import LaneState
from deepmimic_mujoco_torch.algos.trpo import TRPO, Draws, TRPOState
from deepmimic_mujoco_torch.envs.types import EnvState
from deepmimic_mujoco_torch.models.policy import MlpPolicy
from deepmimic_mujoco_torch.utils.running_stats import RunningMeanStd

_ENV_FIELDS = ("qpos", "qvel", "obs", "reward", "done", "mocap_idx",
               "init_idx", "step_count")


def trpo_state_treedef(n_layers: int = 3, clip_id: str = "none") -> str:
    """The structure string of a JAX ``TRPOState`` whose MLPs have
    ``n_layers`` layers.  ``EnvState`` gained a trailing ``clip_id`` field
    after the bundled single-clip checkpoints were written: ``clip_id`` is
    "absent" for their older string, "none" for a single-clip env's state
    (the field is None) and "array" for a multi-clip env's."""
    mlp = "[" + ", ".join(["{'b': *, 'w': *}"] * n_layers) + "]"
    env = ", ".join(["*"] * 9) + {"absent": "", "none": ", None",
                                  "array": ", *"}[clip_id]
    return ("PyTreeDef(CustomNode(TRPOState[()], [{'logstd': *, 'ob_rms': "
            "CustomNode(namedtuple[RunningMeanStd], [*, *, *]), "
            f"'pol': {mlp}, 'vf': {mlp}}}, "
            "CustomNode(namedtuple[AdamState], [*, *, *]), "
            f"CustomNode(EnvState[()], [{env}]), *, *, *, *]))")


_CLIP_ID_FORMS = ("absent", "none", "array")


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
    f32 = torch.float32
    return TRPOState(
        params=from_numpy_params(state.params, device),
        vf_adam=adam.AdamState(t(m, f32), t(v, f32), t(step, f32)),
        env_state=_env_state(state.env_state, device),
        new=t(state.new, torch.bool), draws=draws,
        cur_ep_ret=t(state.cur_ep_ret, f32),
        cur_ep_len=t(state.cur_ep_len, torch.int32))


def _env_state(es, device: torch.device | str) -> EnvState:
    """numpy env leaves (a namespace with the ``EnvState`` fields; clip_id
    None or absent for single-clip envs) → the port's ``EnvState``."""
    def t(x, dtype):
        return torch.as_tensor(np.asarray(x), device=device).to(dtype)

    f32, i64 = torch.float32, torch.int64
    clip_id = getattr(es, "clip_id", None)
    return EnvState(
        **{f: t(getattr(es, f), {"done": torch.bool}.get(
            f, i64 if f in _ENV_FIELDS[5:] else f32)) for f in _ENV_FIELDS},
        clip_id=None if clip_id is None else t(clip_id, i64))


def _read(path: str, policy: MlpPolicy, lanes: bool = False
          ) -> tuple[list, str]:
    """All leaves of a TRPOState checkpoint of ``policy``'s depth, checked
    against its structure string and ``policy``'s shapes; ``lanes``: a file
    of independent learners, every leaf with a leading lane axis."""
    n_layers = len(policy.sizes)
    with np.load(path, allow_pickle=False) as z:
        treedef = bytes(z["__treedef__"]).decode()
        accepted = [trpo_state_treedef(n_layers, c) for c in _CLIP_ID_FORMS]
        if treedef not in accepted:
            raise ValueError(
                f"{path!r} is not a TRPOState checkpoint of a "
                f"{n_layers}-layer MlpPolicy:\n  saved:    {treedef}\n"
                f"  expected: {accepted[1]}\n  or:       {accepted[2]}")
        leaves = [z[f"leaf_{i}"] for i in range(len(z.files) - 1)]
    sizes = policy.sizes
    lead = leaves[0].shape[:1] if lanes else ()
    pol = leaves[4:4 + 2 * n_layers]
    vf = leaves[4 + 2 * n_layers:4 + 4 * n_layers]
    for head, flat, out in (("pol", pol, policy.ac_dim), ("vf", vf, 1)):
        for k, (n_in, n_out) in enumerate(zip(sizes, sizes[1:] + [out])):
            b, w = flat[2 * k], flat[2 * k + 1]
            if w.shape != lead + (n_in, n_out) or b.shape != lead + (n_out,):
                raise ValueError(
                    f"{path!r}: {head} layer {k} has w {w.shape}, b {b.shape};"
                    f" the policy expects {lead + (n_in, n_out)}, "
                    f"{lead + (n_out,)}")
    if leaves[0].shape != lead + (policy.ac_dim,):
        raise ValueError(f"{path!r}: logstd shape {leaves[0].shape}")
    return leaves, treedef


def _layout(leaves: list, n_layers: int) -> types.SimpleNamespace:
    """The leaves of a TRPOState (or of a lane file) as a namespace with
    the JAX state's fields; ``env_state.clip_id`` is None where the file
    has no clip_id leaf."""
    n = 4 + 4 * n_layers
    n_env = len(leaves) - n - 3 - 4   # 9, or 10 with clip_id
    env = dict(zip(_ENV_FIELDS, leaves[n + 3:n + 11]))
    env["key"] = leaves[n + 11]
    env["clip_id"] = leaves[n + 12] if n_env == 10 else None
    rest = n + 3 + n_env
    return types.SimpleNamespace(
        params=_params(leaves, n_layers), vf_adam=tuple(leaves[n:n + 3]),
        env_state=types.SimpleNamespace(**env), new=leaves[rest],
        key=leaves[rest + 1], cur_ep_ret=leaves[rest + 2],
        cur_ep_len=leaves[rest + 3])


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
    state = _layout(leaves, len(learner.policy.sizes))
    n_envs = state.env_state.qpos.shape[0]
    if n_envs != learner.cfg.num_envs:
        raise ValueError(f"{path!r} holds {n_envs} envs; the learner runs "
                         f"{learner.cfg.num_envs}")
    return from_numpy_state(state, draws, learner.device)


def _np(x, dtype=np.float32):
    return x.detach().cpu().numpy().astype(dtype)


def _state_leaves(params: dict, vf_adam, es: EnvState, new, cur_ep_ret,
                  cur_ep_len, lead: tuple) -> list:
    """The leaves of a TRPOState in JAX's order and dtypes, every leaf with
    the leading shape ``lead`` (() or (L,)).  The port has no JAX PRNG
    keys: it writes distinct raw threefry keys in the layout of
    ``jax.random.PRNGKey(k)``, ``[0, k]`` — env e's key is ``[0, e]``, the
    state's ``[0, B]`` (per lane)."""
    B = new.shape[-1]
    rms = params["ob_rms"]
    # lane-stacked params keep (L, 1, ·) broadcast axes: they go
    sq = (lambda x: x[:, 0]) if lead else (lambda x: x)
    leaves = [sq(params["logstd"]), sq(rms.mean), sq(rms.var),
              rms.count.reshape(lead)]
    leaves += [x for head in ("pol", "vf") for layer in params[head]
               for x in (sq(layer["b"]), layer["w"])]
    leaves = [_np(x) for x in leaves + list(vf_adam)]
    env = [_np(getattr(es, f)).reshape(lead + (B,) + tuple(
        getattr(es, f).shape[1:])) for f in _ENV_FIELDS[:4]]
    env += [_np(es.done, np.bool_).reshape(lead + (B,))]
    env += [_np(getattr(es, f), np.int32).reshape(lead + (B,))
            for f in _ENV_FIELDS[5:]]
    keys = np.stack([np.zeros(B, np.uint32), np.arange(B, dtype=np.uint32)], 1)
    env.append(np.broadcast_to(keys, lead + (B, 2)).copy())
    if es.clip_id is not None:
        env.append(_np(es.clip_id, np.int32).reshape(lead + (B,)))
    return leaves + env + [
        _np(new, np.bool_),
        np.broadcast_to(np.array([0, B], np.uint32), lead + (2,)).copy(),
        _np(cur_ep_ret), _np(cur_ep_len, np.int32)]


def _write(path: str, leaves: list, treedef: str) -> str:
    path = path if path.endswith(".npz") else path + ".npz"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, __treedef__=np.frombuffer(treedef.encode(), np.uint8),
             **{f"leaf_{i}": x for i, x in enumerate(leaves)})
    return path


def save(path: str, state) -> str:
    """Write a ``TRPOState``, or a ``LaneState`` of independent learners
    (``algos/lanes.py``), to ``<path>.npz`` in the JAX layout: a lane
    state as the lane tool writes its ``imit15_state.npz``, every leaf
    stacked over the lanes on axis 0.  The structure string is the current
    JAX ``TRPOState``'s (``clip_id`` None, or an array for a multi-clip
    env), the dtypes JAX's.  Returns the file's path."""
    es = state.env_state
    leaves = _state_leaves(state.params, state.vf_adam, es, state.new,
                           state.cur_ep_ret, state.cur_ep_len,
                           tuple(state.new.shape[:-1]))
    form = "none" if es.clip_id is None else "array"
    return _write(path, leaves, trpo_state_treedef(len(state.params["pol"]),
                                                   form))


def read_lanes(path: str, policy: MlpPolicy) -> types.SimpleNamespace:
    """The raw numpy leaves of a lane file (every leaf (L, ...)), laid out
    as the JAX state's fields, checked against ``policy``'s shapes."""
    leaves, _ = _read(path, policy, lanes=True)
    return _layout(leaves, len(policy.sizes))


def _lane_params(raw, idx, device):
    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32)[idx], device=device)

    p = raw.params
    mean, var, count = p["ob_rms"]
    params = {
        "pol": [{"w": t(x["w"]), "b": t(x["b"])[:, None]} for x in p["pol"]],
        "vf": [{"w": t(x["w"]), "b": t(x["b"])[:, None]} for x in p["vf"]],
        "logstd": t(p["logstd"])[:, None],
        "ob_rms": RunningMeanStd(t(mean)[:, None], t(var)[:, None],
                                 t(count).reshape(-1, 1, 1))}
    return params, adam.AdamState(*(t(x) for x in raw.vf_adam))


def load_lane_params(path: str, policy: MlpPolicy,
                     device: torch.device | str, lanes=None):
    """(params, vf_adam) of the lanes ``lanes`` (all when None) of a lane
    file, lane-stacked as ``algos/lanes.py`` keeps them (biases, logstd and
    obs-RMS as (L, 1, ·)).  The lane tool's ``--resume-lanes`` surgery
    moves these and not the env batches."""
    raw = read_lanes(path, policy)
    idx = list(range(raw.new.shape[0]) if lanes is None else lanes)
    return _lane_params(raw, idx, device)


def load_lane_state(path: str, learner, draws: list) -> LaneState:
    """The whole state of a lane file for a ``LaneTRPO`` of the same lane
    and env counts: params, ``vf_adam``, the (L·E) env state, ``new`` and
    the episode accounting.  ``draws`` (one per lane) give the random
    draws."""
    raw = read_lanes(path, learner.policy)
    L, E = raw.new.shape
    if (L, E) != (learner.lanes, learner.cfg.num_envs):
        raise ValueError(f"{path!r} holds {L} lanes x {E} envs; the learner "
                         f"runs {learner.lanes} x {learner.cfg.num_envs}")
    dev = learner.device
    params, vf_adam = _lane_params(raw, list(range(L)), dev)
    es = types.SimpleNamespace(**{
        f: None if x is None else np.asarray(x).reshape(
            (L * E,) + np.shape(x)[2:])
        for f, x in vars(raw.env_state).items()})

    def t(x, dtype):
        return torch.as_tensor(np.asarray(x), device=dev).to(dtype)

    return LaneState(params=params, vf_adam=vf_adam,
                     env_state=_env_state(es, dev),
                     new=t(raw.new, torch.bool), draws=list(draws),
                     cur_ep_ret=t(raw.cur_ep_ret, torch.float32),
                     cur_ep_len=t(raw.cur_ep_len, torch.int32))
