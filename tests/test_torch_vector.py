"""The port's batch wrappers and the gym shim (``deepmimic_mujoco_torch/
envs/vector.py``, ``vec_normalize.py``, ``gym_shim.py``) and the scalar
running statistics (``utils/running_stats.py``) against the JAX package on
the CPU.

``VectorEnv`` and ``VecNormalize`` are held against JAX's over stub envs
that both stacks step alike (no physics); the fresh starts of the port's
auto-reset cannot be JAX's draws, so where they enter, the test checks
what each stack does with its own.  The gym shim's registration runs in
subprocesses whose import system refuses JAX (and, in one, gymnasium, as
on the card's machine)."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepmimic_mujoco_tpu.envs.types import EnvState as JEnvState
from deepmimic_mujoco_tpu.envs.vec_normalize import VecNormalize as JVecNorm
from deepmimic_mujoco_tpu.envs.vector import VectorEnv as JVectorEnv
from deepmimic_mujoco_tpu.utils import running_stats as jrs
from deepmimic_mujoco_torch.envs import gym_shim
from deepmimic_mujoco_torch.envs.dp_env_v2 import DPEnvV2
from deepmimic_mujoco_torch.envs.dp_env_v3 import DPEnvV3
from deepmimic_mujoco_torch.envs.humanoid_test_env import HumanoidTestEnv
from deepmimic_mujoco_torch.envs.types import EnvState
from deepmimic_mujoco_torch.envs.vec_normalize import VecNormalize
from deepmimic_mujoco_torch.envs.vector import VectorEnv
from deepmimic_mujoco_torch.utils import running_stats

torch.set_num_threads(1)

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))


# --- stub envs: qpos += action; done once qpos[0] > 1.5 ---------------------
class _JaxStub:
    observation_size, action_size = 3, 2

    def _state(self, qpos, key):
        z = jnp.zeros((), jnp.int32)
        return JEnvState(qpos=qpos, qvel=qpos, obs=jnp.append(qpos, 0.0),
                         reward=jnp.zeros(()), done=jnp.zeros((), bool),
                         mocap_idx=z, init_idx=z, step_count=z, key=key)

    def reset(self, key):
        return self._state(jnp.zeros(2), key)

    def reset_init(self, key):
        return self._state(jnp.full(2, 100.0), key)

    def step(self, state, action):
        qpos = state.qpos + action
        return dataclasses.replace(
            state, qpos=qpos, obs=jnp.append(qpos, state.step_count + 1.0),
            reward=jnp.sum(action), done=qpos[0] > 1.5,
            step_count=state.step_count + 1)


class _TorchStub:
    observation_size, action_size = 3, 2
    device = torch.device("cpu")

    def _state(self, qpos):
        z = torch.zeros(qpos.shape[0], dtype=torch.int64)
        return EnvState(qpos=qpos, qvel=qpos,
                        obs=torch.cat([qpos, z[:, None].float()], dim=1),
                        reward=torch.zeros(qpos.shape[0]),
                        done=torch.zeros(qpos.shape[0], dtype=torch.bool),
                        mocap_idx=z, init_idx=z, step_count=z)

    def reset(self, generator, n):
        return self._state(torch.zeros(n, 2))

    def reset_init(self, generator, n):
        torch.rand(1, generator=generator)  # a draw, as real resets make
        return self._state(torch.full((n, 2), 100.0))

    def step(self, state, action):
        qpos = state.qpos + action
        return dataclasses.replace(
            state, qpos=qpos,
            obs=torch.cat([qpos, (state.step_count + 1.0)[:, None]], dim=1),
            reward=action.sum(1), done=qpos[:, 0] > 1.5,
            step_count=state.step_count + 1)


def test_auto_reset_returns_the_fresh_obs_with_the_finished_reward():
    """Both stacks: an env that finishes holds its fresh start — qpos, obs
    and step count of the noise reset (the obs is the fresh one, whatever
    JAX's docstring says) — with the finished transition's reward and
    done; the other envs go on.  The port draws only at a step where some
    env finished, and needs a generator only then."""
    acts = np.array([[[1.0, 0.5], [0.2, 0.0], [1.0, 0.0]],
                     [[1.0, 0.0], [0.2, 0.0], [0.1, 0.0]]], np.float32)
    jv = JVectorEnv(_JaxStub(), 3)
    js = jv.reset(jax.random.PRNGKey(0))
    tv = VectorEnv(_TorchStub(), 3)
    gen = torch.Generator().manual_seed(0)
    ts = tv.reset(gen)
    js = jv.step(js, jnp.asarray(acts[0]))
    g0 = gen.get_state()
    ts = tv.step(ts, torch.as_tensor(acts[0]))      # no env done: no draw
    assert torch.equal(gen.get_state(), g0)
    with pytest.raises(ValueError, match="generator"):
        tv.step(ts, torch.as_tensor(acts[1]))
    js = jv.step(js, jnp.asarray(acts[1]))
    ts = tv.step(ts, torch.as_tensor(acts[1]), gen)
    for st in (js, ts):
        done = np.asarray(st.done)
        np.testing.assert_array_equal(done, [True, False, False])
        np.testing.assert_array_equal(np.asarray(st.obs)[0], [100, 100, 0])
        np.testing.assert_allclose(np.asarray(st.obs)[1:], [[0.4, 0, 2],
                                                            [1.1, 0, 2]])
        np.testing.assert_allclose(np.asarray(st.reward), [1.0, 0.2, 0.1])
        np.testing.assert_array_equal(np.asarray(st.step_count), [0, 2, 2])
    assert not torch.equal(gen.get_state(), g0)


def test_init_falls_back_to_rsi_and_none_keeps_the_terminal_state():
    """"init" becomes "rsi" for an env without ``reset_init`` (DPEnvV1/V2);
    "none" returns the finished state; an unknown mode raises."""
    assert VectorEnv(DPEnvV2(device="cpu"), 2).autoreset == "rsi"
    assert VectorEnv(_TorchStub(), 2, autoreset="rsi").autoreset == "rsi"
    assert JVectorEnv(_JaxStub(), 2, autoreset="init").autoreset == "init"
    v = VectorEnv(_TorchStub(), 2, autoreset="rsi")
    st = v.step(v.reset(None), torch.tensor([[2.0, 0.0], [0.0, 0.0]]),
                torch.Generator())
    np.testing.assert_array_equal(st.obs[0].numpy(), [0, 0, 0])  # RSI start
    v = VectorEnv(_TorchStub(), 2, autoreset="none")
    st = v.step(v.reset(None), torch.tensor([[2.0, 0.0], [0.0, 0.0]]))
    assert bool(st.done[0]) and float(st.qpos[0, 0]) == 2.0
    with pytest.raises(ValueError):
        VectorEnv(_TorchStub(), 2, autoreset="noise")


def test_planted_fall_resets_to_the_noise_start():
    """``tests/test_envs.py::TestVectorEnv::test_done_envs_are_reset_to_
    init`` on the port: 4 DPEnvV3 walk envs with the root planted at
    z = 0.1 all finish after one step and hold noise starts within 0.011 of
    qpos0, their obs the fresh one."""
    env = DPEnvV3(device="cpu")
    venv = VectorEnv(env, 4, autoreset="init")
    gen = torch.Generator().manual_seed(0)
    st = venv.reset(gen)
    qpos = st.qpos.clone()
    qpos[:, 2] = 0.1
    nxt = venv.step(dataclasses.replace(st, qpos=qpos), torch.zeros(4, 28),
                    gen)
    assert bool(nxt.done.all())
    assert float((nxt.qpos - env.model.qpos0).abs().max()) <= 0.011
    torch.testing.assert_close(
        nxt.obs, env._obs(nxt.qpos, nxt.qvel, nxt.mocap_idx, nxt.init_idx))
    assert (nxt.step_count == 0).all()


# --- VecNormalize over a replaying venv -------------------------------------
T, B, D = 12, 4, 5
_rng = np.random.RandomState(7)
OBS = (3.0 * _rng.randn(T + 1, B, D) + 1.0).astype(np.float32)
REW = _rng.randn(T, B).astype(np.float32)
DONE = _rng.rand(T, B) < 0.2


class _JaxReplay:
    observation_size, num_envs = D, B

    def reset(self, key):
        self.t = 0
        return JEnvState(qpos=None, qvel=None, obs=jnp.asarray(OBS[0]),
                         reward=jnp.zeros(B), done=jnp.zeros(B, bool),
                         mocap_idx=None, init_idx=None, step_count=None,
                         key=None)

    def step(self, state, actions):
        self.t += 1
        return dataclasses.replace(state, obs=jnp.asarray(OBS[self.t]),
                                   reward=jnp.asarray(REW[self.t - 1]),
                                   done=jnp.asarray(DONE[self.t - 1]))


class _TorchReplay:
    observation_size, num_envs = D, B

    def reset(self, generator):
        self.t = 0
        return EnvState(qpos=None, qvel=None, obs=torch.as_tensor(OBS[0]),
                        reward=torch.zeros(B),
                        done=torch.zeros(B, dtype=torch.bool),
                        mocap_idx=None, init_idx=None, step_count=None)

    def step(self, state, actions, generator=None):
        self.t += 1
        return dataclasses.replace(state, obs=torch.as_tensor(OBS[self.t]),
                                   reward=torch.as_tensor(REW[self.t - 1]),
                                   done=torch.as_tensor(DONE[self.t - 1]))


@pytest.mark.parametrize("ob,ret", [(True, True), (True, False),
                                    (False, True)])
def test_vec_normalize_matches_jax_over_replayed_steps(ob, ret):
    """12 steps of fixed obs, rewards and dones (numpy seed 7) through
    both stacks' ``VecNormalize``: normalized obs and rewards, dones, the
    running return and both statistics within 1e-6 (of max(1, |x|)) of
    JAX's at every step, in each normalization setting."""
    jn = JVecNorm(_JaxReplay(), ob=ob, ret=ret)
    tn = VecNormalize(_TorchReplay(), ob=ob, ret=ret)
    js, ts = jn.reset(None), tn.reset(None)

    def close(out, ref):
        ref = np.asarray(ref)
        np.testing.assert_allclose(np.asarray(out), ref, rtol=0,
                                   atol=1e-6 * max(1.0, np.abs(ref).max()))

    close(tn.observe(ts), jn.observe(js))
    assert ts.ret_rms.mean.shape == () and ts.ob_rms.mean.shape == (D,)
    for _ in range(T):
        js, jo, jr, jd = jn.step(js, None)
        ts, to, tr, td = tn.step(ts, None)
        for out, ref in ((to, jo), (tr, jr), (ts.ret, js.ret),
                         *zip(ts.ob_rms, js.ob_rms), *zip(ts.ret_rms,
                                                          js.ret_rms)):
            close(out, ref)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    if ob:
        assert float(to.abs().max()) <= 10.0


def test_scalar_and_vector_running_stats_match_jax():
    """``init(())`` and ``update`` with (n,) batches — the return statistics
    of VecNormalize — and ``init(d)`` / ``init((d,))`` with (n, d) batches,
    three updates each: mean, var and count within 1e-6 of max(1, |x|) of
    JAX's.  A lane-stacked (L, 1, d) update still updates each lane from
    its own rows."""
    rng = np.random.RandomState(3)
    for shape, batches in (((), [rng.randn(n) * 4 + 2 for n in (8, 1, 33)]),
                           ((6,), [rng.randn(n, 6) for n in (8, 1, 33)])):
        inits = [running_stats.init(shape, "cpu")]
        if shape:
            inits.append(running_stats.init(shape[0], "cpu"))
        for t in inits:
            j = jrs.init(shape)
            for b in batches:
                b = b.astype(np.float32)
                j = jrs.update(j, jnp.asarray(b))
                t = running_stats.update(t, torch.as_tensor(b))
                for out, ref in zip(t, j):
                    ref = np.asarray(ref)
                    assert out.shape == ref.shape
                    np.testing.assert_allclose(
                        out.numpy(), ref, rtol=0,
                        atol=1e-6 * max(1.0, np.abs(ref).max()))
    lanes = running_stats.RunningMeanStd(
        torch.zeros(2, 1, 3), torch.ones(2, 1, 3), torch.ones(2, 1, 1))
    rows = torch.as_tensor(rng.randn(2, 4, 3).astype(np.float32))
    out = running_stats.update(lanes, rows)
    for lane in range(2):
        one = running_stats.update(running_stats.RunningMeanStd(
            torch.zeros(3), torch.ones(3), torch.tensor(1.0)), rows[lane])
        torch.testing.assert_close(out.mean[lane, 0], one.mean)
        torch.testing.assert_close(out.var[lane, 0], one.var)


# --- the gym shim -----------------------------------------------------------
def test_gym_shim_api():
    """``make`` builds each id's env on the device asked for; ``reset``
    returns the (obs, info) of one env, ``step`` gymnasium's 5-tuple of
    host values; a seed repeats the draws; ``options={"init": True}`` is
    the noise reset where the env has one and the RSI reset elsewhere."""
    env = gym_shim.make("DPEnvV2", device="cpu", seed=3)
    assert isinstance(env.fenv, DPEnvV2) and env.fenv.device.type == "cpu"
    assert env.observation_space.shape == (67,)
    assert env.action_space.shape == (28,)
    obs, info = env.reset()
    assert obs.shape == (67,) and obs.dtype == np.float32 and info == {}
    out = env.step(np.zeros(28))
    assert (type(out[1]), type(out[2]), out[3], out[4]) == (
        float, bool, False, {"mocap_idx": 1})
    assert out[0].shape == (67,)
    again, _ = gym_shim.make("DPEnvV2", device="cpu", seed=3).reset()
    np.testing.assert_array_equal(again, obs)
    np.testing.assert_array_equal(env.reset(seed=3)[0], obs)
    env.reset(options={"init": True})                  # falls back to RSI
    hte = gym_shim.make("HumanoidTest", device="cpu")
    assert isinstance(hte.fenv, HumanoidTestEnv)
    obs, _ = hte.reset(options={"init": True})
    assert obs.shape == (387,)
    assert isinstance(gym_shim.make("HumanoidDeepMimic-v0",
                                    device="cpu").fenv, DPEnvV3)


_REGISTER = """
import sys
REFUSE = {refuse!r}

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSE:
            raise ImportError(f"import of {{name}} refused")
        return None

sys.meta_path.insert(0, Refuse())
from deepmimic_mujoco_torch.envs import gym_shim
gym_shim.register_gym_envs()
if "gymnasium" in REFUSE:
    assert gym_shim.GymEnv.__bases__ == (object,)
    env = gym_shim.make("DPEnvV2", device="cpu")
else:
    import gymnasium
    from gymnasium.envs.registration import registry
    ids = ("HumanoidDeepMimic-v0", "HumanoidDeepMimicExtraHard-v0",
           "DPEnvV3-v0", "DPEnvV2-v0", "DPEnvV1-v0")
    assert all(i in registry for i in ids)
    gym_shim.register_gym_envs()  # again: the ids are skipped
    env = gymnasium.make("DPEnvV2-v0", device="cpu").unwrapped
    assert type(env) is gym_shim.GymEnv
    hard = gymnasium.make("HumanoidDeepMimicExtraHard-v0", device="cpu")
    assert hard.unwrapped.fenv.reward_mode == "imitation"
obs, _ = env.reset(seed=1)
obs, rew, done, trunc, info = env.step([0.0] * 28)
assert obs.shape == (67,) and info == {{"mocap_idx": 1}}
assert not [m for m in sys.modules if m.split(".")[0] in REFUSE]
print("registered ok")
"""


@pytest.mark.parametrize("refuse", [("jax", "jaxlib", "deepmimic_mujoco_tpu"),
                                    ("jax", "jaxlib", "deepmimic_mujoco_tpu",
                                     "gymnasium")],
                         ids=["with_gymnasium", "without_gymnasium"])
def test_gym_registration_without_jax(refuse):
    """The port's ids register with gymnasium in a process that refuses
    JAX, and ``gymnasium.make`` builds the port's shim; without gymnasium
    ``GymEnv`` derives from ``object`` and ``make`` still works."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c",
                           _REGISTER.format(refuse=refuse)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "registered ok" in proc.stdout
