"""The render tools' rollouts (``cli/render_policy.py``,
``cli/render_vmapped.py``) against the JAX package's ``tools/
render_policy.py`` and ``tools/render_vmapped.py`` on the CPU, and the
tools' and ``play_mocap --video``'s rendering.

The JAX side is the tools' own code rebuilt here (their ``main`` renders
and takes its arguments from ``sys.argv``): the recipe env or the 15-clip
env, the checkpoint loaded through JAX's strict reader, a jitted
``lax.scan`` of deterministic steps with the state frozen after done.  Two
jitted physics programs, 16 control steps each.  Both stacks start from
JAX's ``reset_at(PRNGKey(0), frame)``; the port's own ``reset_at`` is held
to it too.  MuJoCo cannot open a GL context here, so rendering runs with
``mujoco.Renderer`` replaced by a stub (``tests/torch_render_stub.py``)."""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmimic_mujoco_tpu.algos.trpo import TRPO as JTRPO
from deepmimic_mujoco_tpu.algos.trpo import TRPOConfig as JConfig
from deepmimic_mujoco_tpu.cli import play_mocap as jax_play_mocap
from deepmimic_mujoco_tpu.envs import DPEnvV3 as JDPEnvV3
from deepmimic_mujoco_tpu.envs.multi_clip import DPEnvV3Multi as JMulti
from deepmimic_mujoco_tpu.io_utils import checkpoint as jcheckpoint
from deepmimic_mujoco_tpu.models import MlpPolicy as JMlpPolicy
from deepmimic_mujoco_tpu.physics.humanoid import (
    mocap_hinge_range as jax_hinge_range,
)
from deepmimic_mujoco_torch.cli import (
    play_mocap,
    render_policy,
    render_vmapped,
)
from deepmimic_mujoco_torch.cli.imitation15_vmapped import CLIPS15
from deepmimic_mujoco_torch.envs.types import EnvState
from tests.torch_render_stub import StubRenderer, read_frames, stdout_of

torch.set_num_threads(1)

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
CKPT_R2 = os.path.join(ROOT, "train_ckpt_walk_r2", "DPEnvV3", "trpo-walk-0",
                       "trpo_state.npz")
CKPT_LANES = os.path.join(ROOT, "train_ckpt_imit5_r5b", "imit15_state.npz")
LANE_CLIPS = "walk,run,spinkick,backflip,getup_facedown"
STEPS = 16
START = 5
RTOL = 1e-4   # qpos, of max(1, |x|): 16 control steps of f32 physics


def _scan(env, policy, params, s, steps):
    """The JAX tools' rollout (``tools/render_policy.py:roll``)."""
    @jax.jit
    def roll(s):
        def step_fn(carry, _):
            s, alive = carry
            mean, _ = policy.mean_logstd(params, s.obs)
            nxt = env.step(s, mean)
            alive2 = alive & ~nxt.done
            s2 = jax.tree.map(lambda a, b: jnp.where(alive, a, b), nxt, s)
            return (s2, alive2), (s.qpos, alive)

        (_, _), (qpos, alive) = jax.lax.scan(
            step_fn, (s, jnp.ones((), bool)), None, length=steps)
        return qpos, alive

    qpos, alive = roll(s)
    return np.asarray(qpos), np.asarray(alive)


def _port_state(s) -> EnvState:
    """JAX's (unbatched) reset state as the port's batch of one."""
    def t(x, dtype=None):
        x = torch.as_tensor(np.array(x))[None]
        return x if dtype is None else x.to(dtype)

    return EnvState(
        qpos=t(s.qpos), qvel=t(s.qvel), obs=t(s.obs), reward=t(s.reward),
        done=t(s.done), mocap_idx=t(s.mocap_idx, torch.int64),
        init_idx=t(s.init_idx, torch.int64),
        step_count=t(s.step_count, torch.int64),
        clip_id=None if getattr(s, "clip_id", None) is None
        else t(s.clip_id, torch.int64))


def _compare(port, ref_qpos, ref_alive, own_state, jax_state):
    qpos, alive = port
    assert qpos.shape == (STEPS, 1, 35) and alive.shape == (STEPS, 1)
    q = qpos[:, 0].numpy()
    err = np.abs(q - ref_qpos) / np.maximum(1.0, np.abs(ref_qpos))
    assert float(err.max()) <= RTOL, float(err.max())
    np.testing.assert_array_equal(alive[:, 0].numpy(), ref_alive)
    np.testing.assert_allclose(own_state.qpos[0].numpy(),
                               np.asarray(jax_state.qpos), rtol=0, atol=1e-6)
    np.testing.assert_allclose(own_state.obs[0].numpy(),
                               np.asarray(jax_state.obs), rtol=0, atol=1e-5)


def test_render_policy_rollout_matches_jax_tool():
    """``render_policy``'s rollout of walk_r2 (the recipe, relu 1024-512)
    from frame 5, 16 control steps: qpos to 1e-4 of max(1, |x|) and equal
    alive flags against the JAX tool's scan."""
    args = render_policy.build_parser().parse_args([
        "--ckpt", CKPT_R2, "--device", "cpu", "--steps", str(STEPS),
        "--start-frame", str(START)])
    env = JDPEnvV3(clip="walk", reward_mode="imitation_dm",
                   control_mode="pd_residual", n_substeps=2,
                   max_episode_steps=STEPS)
    policy = JMlpPolicy(ob_dim=env.observation_size, ac_dim=env.action_size,
                        fixed_logstd=-3.0, hidden_sizes=(1024, 512),
                        activation="relu")
    learner = JTRPO(env, policy, JConfig())
    params = jcheckpoint.load(CKPT_R2,
                              learner.init(jax.random.PRNGKey(0))).params
    s = env.reset_at(jax.random.PRNGKey(0), START)
    ref_qpos, ref_alive = _scan(env, policy, params, s, STEPS)

    penv, ppolicy, pparams, own = render_policy.setup(args,
                                                      torch.device("cpu"))
    port = render_policy.rollout(penv, ppolicy, pparams, _port_state(s),
                                 STEPS)
    _compare(port, ref_qpos, ref_alive, own, s)


def test_render_vmapped_rollout_matches_jax_tool():
    """``render_vmapped``'s rollout of the spinkick lane of imit5_r5b (the
    15-clip env, mocap joint limits) from frame 5, 16 control steps,
    against the JAX tool's lane-stacked load and scan: qpos to 1e-4 of
    max(1, |x|), equal alive flags (the boolean-mask trim's input)."""
    motion = "spinkick"
    args = render_vmapped.build_parser().parse_args([
        "--ckpt", CKPT_LANES, "--clips", LANE_CLIPS, "--motion", motion,
        "--device", "cpu", "--steps", str(STEPS), "--start-frame",
        str(START)])
    clips, env_clips = LANE_CLIPS.split(","), CLIPS15
    lane, cid = clips.index(motion), env_clips.index(motion)
    env = JMulti(clips=tuple(env_clips), model=jax_hinge_range(),
                 control_mode="pd_residual", n_substeps=2,
                 max_episode_steps=STEPS, reward_mode="imitation_dm",
                 obs_mode="full", termination="fall_contact")
    policy = JMlpPolicy(ob_dim=env.observation_size, ac_dim=env.action_size,
                        hidden_sizes=(1024, 512), activation="relu",
                        fixed_logstd=-3.0)
    learner = JTRPO(env, policy, JConfig(num_envs=2, horizon=8,
                                         reset_mode="rsi_pinned"))
    sts = []
    for k in range(len(clips)):
        st = learner.init(jax.random.fold_in(jax.random.PRNGKey(0), k))
        ekeys = jax.random.split(jax.random.PRNGKey(k), 2)
        es = jax.vmap(lambda kk, k=k: env.reset_at(
            kk, env_clips.index(clips[k]), 0))(ekeys)
        sts.append(dataclasses.replace(st, env_state=es))
    states = jax.tree.map(lambda *xs: jnp.stack(xs), *sts)
    states = jcheckpoint.load(CKPT_LANES, states)
    params = jax.tree.map(lambda a: a[lane], states.params)
    s = env.reset_at(jax.random.PRNGKey(0), cid, START)
    ref_qpos, ref_alive = _scan(env, policy, params, s, STEPS)

    penv, ppolicy, pparams, own = render_vmapped.setup(args,
                                                       torch.device("cpu"))
    port = render_policy.rollout(penv, ppolicy, pparams, _port_state(s),
                                 STEPS)
    _compare(port, ref_qpos, ref_alive, own, s)
    assert int(own.clip_id[0]) == cid


def test_play_mocap_video_matches_jax(tmp_path, monkeypatch):
    """``play_mocap --motion walk --cycles 1 --video``: the same lines and
    the same frames as JAX's, through the stub renderer."""
    import mujoco

    monkeypatch.setattr(mujoco, "Renderer", StubRenderer)
    outs = {}
    for name, main, extra in (("port", play_mocap.main, ["--device", "cpu"]),
                              ("jax", jax_play_mocap.main, [])):
        path = str(tmp_path / f"{name}.avi")
        text, _ = stdout_of(main, ["--motion", "walk", "--cycles", "1",
                                 "--video", path] + extra)
        outs[name] = (text.replace(path, "OUT"), read_frames(path))
    assert outs["port"][0] == outs["jax"][0] and "wrote OUT" in outs["port"][0]
    assert len(outs["port"][1]) == 39
    for a, b in zip(outs["port"][1], outs["jax"][1]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("tool", ["render_policy", "render_vmapped"])
def test_render_tools_render_on_the_cpu(tool, tmp_path, monkeypatch):
    """Each tool's ``main`` at 3 steps on the CPU, through the stub
    renderer: the trimmed frames are written; with cv2 or MuJoCo refused it
    raises an ImportError naming it before the rollout starts."""
    import mujoco

    mod = {"render_policy": render_policy, "render_vmapped": render_vmapped
           }[tool]
    argv = {"render_policy": ["--ckpt", CKPT_R2],
            "render_vmapped": ["--ckpt", CKPT_LANES, "--clips", LANE_CLIPS,
                               "--motion", "walk"]}[tool]
    argv += ["--device", "cpu", "--steps", "3", "--out",
             str(tmp_path / "x.avi")]
    monkeypatch.setattr(mujoco, "Renderer", StubRenderer)
    text, res = stdout_of(mod.main, argv)
    assert res["frames"] == 3 and len(read_frames(res["out"])) == 3
    assert "rendered 3 frames" in text

    def no_rollout(*a, **kw):
        raise AssertionError("the rollout started")

    monkeypatch.setattr(render_policy, "rollout", no_rollout)
    monkeypatch.setattr(render_vmapped, "rollout", no_rollout)
    for name in ("cv2", "mujoco"):
        with monkeypatch.context() as m:
            m.setitem(sys.modules, name, None)
            with pytest.raises(ImportError, match=name):
                mod.main(argv)
