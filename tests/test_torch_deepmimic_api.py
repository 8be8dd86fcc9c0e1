"""The port's DeepMimic core-API facade (``deepmimic_mujoco_torch/envs/
deepmimic_api.py``) against the JAX package's on the CPU, in the manner of
``tests/test_deepmimic_api.py``: ``record_state``, ``action2torque``,
``set_action``, ``calc_reward``, ``check_terminate`` and the builders at
fixed states, and 5 ``update`` calls under the same PD targets.

The fixed states are the standing pose, clip frames with their velocities
and a fallen pose (chest down at the floor).  The JAX side jits one physics
program (the facade's ``engine.step`` at 2 substeps).  Tolerances are
stated per test."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepmimic_mujoco_tpu.envs import deepmimic_api as japi
from deepmimic_mujoco_torch.envs import deepmimic_api as tapi
from deepmimic_mujoco_torch.envs.deepmimic_surface import targets_to_action

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def envs():
    """(JAX, port) facades of walk with the imitation reward."""
    return (japi.DeepMimicEnv(clip="walk", reward_mode="imitation"),
            tapi.DeepMimicEnv(clip="walk", reward_mode="imitation",
                              device="cpu"))


def _states(tenv):
    """(qpos, qvel, sim time) of the fixed states."""
    fallen = tenv.model.qpos0.numpy().copy()
    fallen[2] = 0.1
    fallen[3:7] = [0.7071, 0.0, 0.7071, 0.0]
    q, v = tenv.mocap.qpos_cont, tenv.mocap.qvel_fd
    return [(tenv.model.qpos0.numpy(), np.zeros(34), 0.0),
            (q[5], v[5], 5 * tenv.mocap.dt),
            (q[23], v[23], 23.4 * tenv.mocap.dt),
            (q[38], v[38], 77 * tenv.mocap.dt),
            (fallen, np.zeros(34), 0.0)]


def _put(jenv, tenv, qpos, qvel, sim_time):
    jenv.qpos = jnp.asarray(qpos, jnp.float32)
    jenv.qvel = jnp.asarray(qvel, jnp.float32)
    tenv.qpos = torch.as_tensor(np.asarray(qpos, np.float32))
    tenv.qvel = torch.as_tensor(np.asarray(qvel, np.float32))
    jenv._sim_time = tenv._sim_time = sim_time


def test_record_state_reward_and_termination_at_fixed_states(envs):
    """At each fixed state: the 197-D state within 1e-5 of JAX's (the phase
    of the sim-time cursor exactly, the lateral coordinate in slot 1), the
    imitation reward within 1e-5, the same termination flag (the fallen
    pose fails, the others do not)."""
    jenv, tenv = envs
    terms = []
    for qpos, qvel, t in _states(tenv):
        _put(jenv, tenv, qpos, qvel, t)
        assert tenv.mocap_idx == jenv.mocap_idx
        ref = jenv.record_state(0)
        out = tenv.record_state(0)
        assert out.shape == (197,) and out.dtype == np.float64
        assert np.isfinite(out).all()
        assert out[0] == ref[0]
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
        assert abs(tenv.calc_reward() - jenv.calc_reward()) <= 1e-5
        terms.append(tenv.check_terminate())
        assert terms[-1] == jenv.check_terminate()
    assert terms == [0, 0, 0, 0, 1]


def test_action2torque_and_set_action_match_jax(envs):
    """PD targets (clip poses as DP actions, with noise; identity targets
    at the standing pose, where the torque is 0; a zero axis) → torques
    within 1e-5 of max(1, |τ|) of JAX's (they reach ~3e3: p_err / dt
    multiplies the f32 rotation vectors by 60) and the controls (torque /
    gear) within 1e-5 of max(1, |c|)."""
    jenv, tenv = envs
    rng = np.random.RandomState(4)
    cases = []
    for (qpos, qvel, t), k in zip(_states(tenv), (0, 6, 24, 0, 12)):
        act = targets_to_action(tenv.mocap.qpos_cont[k, 7:])
        cases.append((qpos, qvel, t, act + 0.05 * rng.randn(36)))
    ident = targets_to_action(np.zeros(28, np.float32)).astype(np.float64)
    cases.append((tenv.model.qpos0.numpy(), np.zeros(34), 0.0, ident))
    zero_axis = ident.copy()
    zero_axis[1:4] = 0.0
    cases.append((tenv.model.qpos0.numpy(), np.zeros(34), 0.0, zero_axis))
    for qpos, qvel, t, act in cases:
        _put(jenv, tenv, qpos, qvel, t)
        ref = jenv.action2torque(act)
        out = tenv.action2torque(act)
        assert out.dtype == np.float64
        np.testing.assert_allclose(out, ref, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(ref).max()))
        jenv.set_action(0, act)
        tenv.set_action(0, act)
        ref = np.asarray(jenv.ctrl)
        np.testing.assert_allclose(tenv.ctrl.numpy(), ref, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(ref).max()))
    np.testing.assert_allclose(tenv.action2torque(ident), 0.0, atol=1e-4)


def test_five_updates_match_jax(envs):
    """From frame 0 of walk, 5 ``update(1/30)`` calls (2 substeps each)
    under the PD targets of the next frames: qpos and qvel within 1e-4,
    state within 1e-4, reward within 1e-4 and the same termination after
    each; the sim time and the cursor advance alike."""
    jenv, tenv = envs
    jenv.reset()
    tenv.reset()
    assert tenv.record_state()[0] == 0.0
    _put(jenv, tenv, tenv.mocap.qpos_cont[0], tenv.mocap.qvel_fd[0], 0.0)
    for k in range(1, 6):
        act = targets_to_action(tenv.mocap.qpos_cont[k, 7:])
        jenv.set_action(0, act)
        tenv.set_action(0, act)
        jenv.update(1.0 / 30.0)
        tenv.update(1.0 / 30.0)
        assert tenv._sim_time == jenv._sim_time
        assert tenv.mocap_idx == jenv.mocap_idx == k
        np.testing.assert_allclose(tenv.qpos.numpy(), np.asarray(jenv.qpos),
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(tenv.qvel.numpy(), np.asarray(jenv.qvel),
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(tenv.record_state(), jenv.record_state(),
                                   atol=1e-4, rtol=0)
        assert abs(tenv.calc_reward() - jenv.calc_reward()) <= 1e-4
        assert tenv.check_terminate() == jenv.check_terminate() == 0
    assert tenv.calc_reward() > 0.5


def test_stub_reward_builders_and_sizes_match_jax():
    """The 'stub' reward draws JAX's numbers exactly (the same
    ``RandomState(seed)``); sizes, the action space, the substeps per 30 Hz
    decision and every builder equal JAX's."""
    jenv = japi.DeepMimicEnv(clip="walk", seed=5)
    tenv = tapi.DeepMimicEnv(clip="walk", seed=5, device="cpu")
    assert [tenv.calc_reward() for _ in range(6)] == [
        jenv.calc_reward() for _ in range(6)]
    for k in ("get_state_size", "get_goal_size", "get_action_size",
              "get_num_update_substeps", "get_num_agents", "is_rl_scene",
              "need_new_action", "is_done", "is_episode_end",
              "check_valid_episode"):
        assert getattr(tenv, k)() == getattr(jenv, k)(), k
    assert tenv.get_action_space().value == jenv.get_action_space().value == 1
    for k in ("build_state_offset", "build_state_scale", "build_goal_offset",
              "build_goal_scale", "build_action_offset", "build_action_scale",
              "build_action_bound_min", "build_action_bound_max",
              "build_state_norm_groups", "build_goal_norm_groups",
              "record_goal"):
        np.testing.assert_array_equal(getattr(tenv, k)(), getattr(jenv, k)())
