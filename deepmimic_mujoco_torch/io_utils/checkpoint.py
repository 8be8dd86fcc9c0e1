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
stacked on a new leading lane axis, under the same structure string.

A ``PPOState`` has the same leaves, with PPO's Adam over the flat
``{logstd, pol, vf}`` vector in place of ``vf_adam``, and one more at the
end: ``lr_scale`` () float32.  A ``GAILState`` is the ``TRPOState``'s
leaves followed by the discriminator's: its net (b, w) × 3 layers, its
obs-RMS mean, var, count, its Adam m, v, t and ``expert_ptr`` () int32.

The original-stack PPO agent's params (``dp_policy/ppo_agent.py``,
``ppo_params.npz`` of ``cli/train_ppo.py``) are a dict, flattened in
sorted keys: ``a_norm`` (mean, std, count, mean_sq), ``actor`` (b, w per
layer), ``actor_opt`` (the momentum of each actor leaf), ``actor_stepsize``,
``critic``, ``critic_opt``, ``s_norm``, ``sample_count`` and ``val_norm``,
all float32."""

from __future__ import annotations

import os
import re
import types

import numpy as np
import torch

from deepmimic_mujoco_torch.algos import adam
from deepmimic_mujoco_torch.algos.gail import GAIL, GAILState, disc_leaves
from deepmimic_mujoco_torch.algos.lanes import LaneState
from deepmimic_mujoco_torch.algos.ppo import PPO, PPOState
from deepmimic_mujoco_torch.algos.trpo import TRPO, Draws, TRPOState
from deepmimic_mujoco_torch.dp_policy.normalizer import NormalizerState
from deepmimic_mujoco_torch.dp_policy.ppo_agent import MomentumState, PPOAgent
from deepmimic_mujoco_torch.envs.types import EnvState
from deepmimic_mujoco_torch.models.policy import MlpPolicy
from deepmimic_mujoco_torch.utils.running_stats import RunningMeanStd

_ENV_FIELDS = ("qpos", "qvel", "obs", "reward", "done", "mocap_idx",
               "init_idx", "step_count")


_RMS = "CustomNode(namedtuple[RunningMeanStd], [*, *, *])"
_ADAM = "CustomNode(namedtuple[AdamState], [*, *, *])"


def _mlp(n_layers: int) -> str:
    return "[" + ", ".join(["{'b': *, 'w': *}"] * n_layers) + "]"


def _state_node(name: str, n_layers: int, clip_id: str, n_tail: int) -> str:
    """A JAX state node of the TRPOState layout: params, an Adam state,
    the env state and ``n_tail`` trailing leaves."""
    mlp = _mlp(n_layers)
    env = ", ".join(["*"] * 9) + {"absent": "", "none": ", None",
                                  "array": ", *"}[clip_id]
    tail = ", ".join(["*"] * n_tail)
    return (f"CustomNode({name}[()], [{{'logstd': *, 'ob_rms': {_RMS}, "
            f"'pol': {mlp}, 'vf': {mlp}}}, {_ADAM}, "
            f"CustomNode(EnvState[()], [{env}]), {tail}])")


def trpo_state_treedef(n_layers: int = 3, clip_id: str = "none") -> str:
    """The structure string of a JAX ``TRPOState`` whose MLPs have
    ``n_layers`` layers.  ``EnvState`` gained a trailing ``clip_id`` field
    after the bundled single-clip checkpoints were written: ``clip_id`` is
    "absent" for their older string, "none" for a single-clip env's state
    (the field is None) and "array" for a multi-clip env's."""
    return f"PyTreeDef({_state_node('TRPOState', n_layers, clip_id, 4)})"


def ppo_state_treedef(n_layers: int = 3, clip_id: str = "none") -> str:
    """The structure string of a JAX ``PPOState`` (``trpo_state_treedef``'s
    arguments)."""
    return f"PyTreeDef({_state_node('PPOState', n_layers, clip_id, 5)})"


def gail_state_treedef(n_layers: int = 3, clip_id: str = "none") -> str:
    """The structure string of a JAX ``GAILState`` (``trpo_state_treedef``'s
    arguments; the discriminator always has 3 layers)."""
    trpo = _state_node("TRPOState", n_layers, clip_id, 4)
    return (f"PyTreeDef(CustomNode(GAILState[()], [{trpo}, {{'net': "
            f"{_mlp(3)}, 'obs_rms': {_RMS}}}, {_ADAM}, *]))")


_CLIP_ID_FORMS = ("absent", "none", "array")

_NORM = "CustomNode(namedtuple[NormalizerState], [*, *, *, *])"
_DP_KEYS = ("a_norm", "actor", "actor_opt", "actor_stepsize", "critic",
            "critic_opt", "s_norm", "sample_count", "val_norm")


def dp_ppo_params_treedef(n_actor: int = 3, n_critic: int = 3) -> str:
    """The structure string JAX's ``jax.tree.flatten`` gives for
    ``PPOAgent.init(key)`` of the original-stack agent whose actor and
    critic have ``n_actor`` and ``n_critic`` layers."""
    a, c = _mlp(n_actor), _mlp(n_critic)

    def momentum(m):
        return f"CustomNode(namedtuple[MomentumState], [{m}])"

    node = {"a_norm": _NORM, "actor": a, "actor_opt": momentum(a),
            "actor_stepsize": "*", "critic": c, "critic_opt": momentum(c),
            "s_norm": _NORM, "sample_count": "*", "val_norm": _NORM}
    return "PyTreeDef({" + ", ".join(f"'{k}': {node[k]}"
                                      for k in _DP_KEYS) + "})"


def _dp_leaves(params: dict) -> list:
    """A dp-policy params dict's leaves in JAX's order."""
    def layers(ls):
        return [x for layer in ls for x in (layer["b"], layer["w"])]

    out = []
    for k in _DP_KEYS:
        v = params[k]
        if k in ("actor", "critic"):
            out += layers(v)
        elif k.endswith("_opt"):
            out += layers(v.m)
        elif isinstance(v, NormalizerState):
            out += list(v)
        else:
            out.append(v)
    return out


def load_dp_ppo_params(path: str, agent: PPOAgent,
                       device: torch.device | str) -> dict:
    """The params of an original-stack PPO agent from ``ppo_params.npz``
    (written by the JAX package's ``cli/train_ppo.py`` or by :func:`save`),
    checked against the structure string of ``agent``'s 3-layer nets and
    against its sizes."""
    with np.load(path, allow_pickle=False) as z:
        treedef = bytes(z["__treedef__"]).decode()
        leaves = [z[f"leaf_{i}"] for i in range(len(z.files) - 1)]
    if treedef != dp_ppo_params_treedef():
        raise ValueError(f"{path!r} is not the params of an original-stack "
                         f"PPO agent:\n  saved:    {treedef}\n  expected: "
                         f"{dp_ppo_params_treedef()}")
    it = iter(torch.as_tensor(np.asarray(x, np.float32), device=device)
              for x in leaves)

    def layers():
        return [{"b": next(it), "w": next(it)} for _ in range(3)]

    params = {}
    for k in _DP_KEYS:
        if k in ("actor", "critic"):
            params[k] = layers()
        elif k.endswith("_opt"):
            params[k] = MomentumState(layers())
        elif k.endswith("norm"):
            params[k] = NormalizerState(*(next(it) for _ in range(4)))
        else:
            params[k] = next(it)
    S, A = agent.state_size, agent.action_size
    sizes = {"actor": [S, 1024, 512, A], "critic": [S, 1024, 512, 1]}
    for head, dims in sizes.items():
        for k, layer in enumerate(params[head]):
            want = (dims[k], dims[k + 1])
            if tuple(layer["w"].shape) != want:
                raise ValueError(f"{path!r}: {head} layer {k} has w "
                                 f"{tuple(layer['w'].shape)}; the agent "
                                 f"expects {want}")
    for k, size in (("s_norm", S), ("a_norm", A), ("val_norm", 1)):
        if tuple(params[k].mean.shape) != (size,):
            raise ValueError(f"{path!r}: {k} has size "
                             f"{tuple(params[k].mean.shape)}; expected "
                             f"({size},)")
    return params


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


def _read(path: str, policy: MlpPolicy, lanes: bool = False,
          treedef_of=trpo_state_treedef) -> tuple[list, str]:
    """All leaves of a checkpoint of ``policy``'s depth, checked against
    its structure string (``treedef_of``'s, TRPOState's by default) and
    ``policy``'s shapes; ``lanes``: a file of independent learners, every
    leaf with a leading lane axis."""
    n_layers = len(policy.sizes)
    with np.load(path, allow_pickle=False) as z:
        treedef = bytes(z["__treedef__"]).decode()
        accepted = [treedef_of(n_layers, c) for c in _CLIP_ID_FORMS]
        if treedef not in accepted:
            name = re.search(r"CustomNode\((\w+)\[", accepted[0]).group(1)
            raise ValueError(
                f"{path!r} is not a {name} checkpoint of a "
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


def _check_envs(path: str, state, num_envs: int) -> None:
    n_envs = state.env_state.qpos.shape[0]
    if n_envs != num_envs:
        raise ValueError(f"{path!r} holds {n_envs} envs; the learner runs "
                         f"{num_envs}")


def _check_adam(path: str, what: str, adam_leaves, params_leaves) -> None:
    n = sum(np.size(x) for x in params_leaves)
    if np.shape(adam_leaves[0]) != (n,):
        raise ValueError(f"{path!r}: {what} Adam moments of shape "
                         f"{np.shape(adam_leaves[0])}; the learner has {n} "
                         "parameters")


def load_ppo_params(path: str, policy: MlpPolicy,
                    device: torch.device | str) -> dict:
    """The policy parameters of a PPO checkpoint, as
    :func:`load_trpo_params` reads a TRPO checkpoint's."""
    leaves, _ = _read(path, policy, treedef_of=ppo_state_treedef)
    return from_numpy_params(_params(leaves, len(policy.sizes)), device)


def load_trpo_state(path: str, learner: TRPO, draws: Draws) -> TRPOState:
    """The whole training state of a TRPO checkpoint (written by the JAX
    package or by :func:`save`) for ``learner``: params, ``vf_adam``, env
    state, ``new`` and the episode accounting.  The checkpoint's PRNG keys
    are not read: ``draws`` gives the port's random draws."""
    leaves, _ = _read(path, learner.policy)
    state = _layout(leaves, len(learner.policy.sizes))
    _check_envs(path, state, learner.cfg.num_envs)
    return from_numpy_state(state, draws, learner.device)


def load_ppo_state(path: str, learner: PPO, draws: Draws) -> PPOState:
    """The whole training state of a PPO checkpoint (written by the JAX
    package or by :func:`save`) for ``learner``: params, PPO's Adam, env
    state, ``new``, the episode accounting and ``lr_scale``; ``draws``
    gives the random draws."""
    n_layers = len(learner.policy.sizes)
    leaves, _ = _read(path, learner.policy, treedef_of=ppo_state_treedef)
    raw = _layout(leaves[:-1], n_layers)
    _check_envs(path, raw, learner.cfg.num_envs)
    _check_adam(path, "PPO's", raw.vf_adam,
                [leaves[0]] + leaves[4:4 + 4 * n_layers])
    t = from_numpy_state(raw, draws, learner.device)
    return PPOState(params=t.params, opt=t.vf_adam, env_state=t.env_state,
                    new=t.new, draws=draws, cur_ep_ret=t.cur_ep_ret,
                    cur_ep_len=t.cur_ep_len,
                    lr_scale=torch.as_tensor(np.asarray(leaves[-1],
                                                        np.float32),
                                             device=learner.device))


def load_gail_state(path: str, learner: GAIL, draws: Draws) -> GAILState:
    """The whole training state of a GAIL checkpoint (written by the JAX
    package, e.g. the bundled ``train_ckpt_gail_r4``, or by :func:`save`)
    for ``learner``: its TRPO state, the discriminator's params and Adam,
    and the expert cursor; ``draws`` gives the random draws.  The
    counterpart of JAX's ``checkpoint.load(path, gail_state)``."""
    n_layers = len(learner.policy.sizes)
    leaves, _ = _read(path, learner.policy, treedef_of=gail_state_treedef)
    raw = _layout(leaves[:-13], n_layers)
    _check_envs(path, raw, learner.trpo.cfg.num_envs)
    net, rms, d_adam = leaves[-13:-7], leaves[-7:-4], leaves[-4:-1]
    disc = learner.disc
    sizes = [disc.ob_dim + disc.ac_dim, disc.hidden_size, disc.hidden_size, 1]
    for k, (n_in, n_out) in enumerate(zip(sizes, sizes[1:])):
        b, w = net[2 * k], net[2 * k + 1]
        if w.shape != (n_in, n_out) or b.shape != (n_out,):
            raise ValueError(f"{path!r}: discriminator layer {k} has w "
                             f"{w.shape}, b {b.shape}; the learner expects "
                             f"{(n_in, n_out)}, {(n_out,)}")
    _check_adam(path, "the discriminator's", d_adam, net)
    dev = learner.device

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    return GAILState(
        trpo=from_numpy_state(raw, draws, dev),
        d_params={"net": [{"b": t(net[2 * k]), "w": t(net[2 * k + 1])}
                          for k in range(3)],
                  "obs_rms": RunningMeanStd(*(t(x) for x in rms))},
        d_adam=adam.AdamState(*(t(x) for x in d_adam)),
        expert_ptr=torch.as_tensor(np.asarray(leaves[-1]), device=dev).to(
            torch.int64))


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
    """Write a ``TRPOState``, a ``LaneState`` of independent learners
    (``algos/lanes.py``), a ``PPOState``, a ``GAILState`` or the params
    dict of an original-stack PPO agent to ``<path>.npz`` in the JAX
    layout: a lane state as the lane tool writes its ``imit15_state.npz``,
    every leaf stacked over the lanes on axis 0.  The structure string is
    the current JAX state's (``clip_id`` None, or an array for a
    multi-clip env), the dtypes JAX's.  Returns the file's path."""
    if isinstance(state, dict):
        return _write(path, [_np(x) for x in _dp_leaves(state)],
                      dp_ppo_params_treedef(len(state["actor"]),
                                            len(state["critic"])))
    treedef_of, extra = trpo_state_treedef, []
    if isinstance(state, GAILState):
        d = state.d_params
        extra = [_np(x) for x in disc_leaves(d) + list(d["obs_rms"])
                 + list(state.d_adam)] + [_np(state.expert_ptr, np.int32)]
        treedef_of, state = gail_state_treedef, state.trpo
    if isinstance(state, PPOState):
        treedef_of, extra = ppo_state_treedef, [_np(state.lr_scale)]
        opt = state.opt
    else:
        opt = state.vf_adam
    es = state.env_state
    leaves = _state_leaves(state.params, opt, es, state.new,
                           state.cur_ep_ret, state.cur_ep_len,
                           tuple(state.new.shape[:-1]))
    form = "none" if es.clip_id is None else "array"
    return _write(path, leaves + extra,
                  treedef_of(len(state.params["pol"]), form))


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
