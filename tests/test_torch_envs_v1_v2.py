"""The port's ``DPEnvV1`` and ``DPEnvV2`` (``deepmimic_mujoco_torch/envs/
dp_env_v1.py``, ``dp_env_v2.py``), the quaternion functions they and the
facade need, the training CLI's ``--env-id DPEnvV1|DPEnvV2`` and the
``torque_test`` / ``play_mocap`` CLIs, against the JAX package on the CPU.

Both stacks start from the same clip frames and take the same actions, made
from a numpy seed.  The JAX side jits two physics programs (``jax.vmap(
env.step)`` of each env at its 6 substeps) and runs the JAX CLIs (one more,
the 1-substep walk step).  Tolerances are stated per test."""

import contextlib
import dataclasses
import io
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepmimic_mujoco_tpu.cli import play_mocap as jax_play_mocap
from deepmimic_mujoco_tpu.cli import torque_test as jax_torque_test
from deepmimic_mujoco_tpu.envs import dp_env_v1 as jv1
from deepmimic_mujoco_tpu.envs import dp_env_v2 as jv2
from deepmimic_mujoco_tpu.utils import quaternion as jquat
from deepmimic_mujoco_torch.algos.trpo import TRPO, TRPOConfig
from deepmimic_mujoco_torch.cli import play_mocap, torque_test, train_trpo
from deepmimic_mujoco_torch.envs import dp_env_v1 as tv1
from deepmimic_mujoco_torch.envs import dp_env_v2 as tv2
from deepmimic_mujoco_torch.io_utils import checkpoint
from deepmimic_mujoco_torch.models.policy import MlpPolicy
from deepmimic_mujoco_torch.physics import solver
from deepmimic_mujoco_torch.utils import quaternion as quat

torch.set_num_threads(1)

FRAMES = np.array([0, 7, 20, 38])


def _t(x):
    return torch.as_tensor(np.array(x))


def _quats():
    """Random non-unit quaternions, and unit ones at angles from 0 and
    1e-10 (below the 1e-9 axis threshold) through 1e-8 ... 1e-2 to π and
    just past it (where the angle wraps)."""
    rng = np.random.RandomState(0)
    q = [rng.randn(64, 4)]
    for ang in (0.0, 1e-10, 1e-8, 1e-6, 1e-4, 1e-2, np.pi - 1e-4, np.pi,
                np.pi + 1e-3):
        ax = rng.randn(3)
        ax /= np.linalg.norm(ax)
        q.append(np.concatenate([[np.cos(ang / 2)], np.sin(ang / 2) * ax])[None])
    return np.concatenate(q).astype(np.float32)


def test_log_map_and_angular_velocity_match_jax_small_angles_included():
    """``log_map`` within 2e-6 of JAX's on every input; ``angular_velocity``
    between random pairs and between each quaternion and itself rotated by
    the small angles, within 2e-6 at dt 1 and within 2e-6 of max(1, |ω|)
    at a clip's dt of 1/30."""
    q = _quats()
    np.testing.assert_allclose(quat.log_map(_t(q)).numpy(),
                               np.asarray(jquat.log_map(jnp.asarray(q))),
                               atol=2e-6, rtol=0)
    small = np.resize(q[64:], q.shape)
    q_near = np.asarray(jquat.mul(jnp.asarray(q), jnp.asarray(small)))
    for a, b in ((q, np.roll(q, 1, axis=0)), (q, q_near)):
        for dt in (1.0, 1.0 / 30.0):
            ref = np.asarray(jquat.angular_velocity(jnp.asarray(a),
                                                    jnp.asarray(b), dt))
            out = quat.angular_velocity(_t(a), _t(b), dt).numpy()
            scale = 1.0 if dt == 1.0 else max(1.0, np.abs(ref).max())
            assert np.abs(out - ref).max() <= 2e-6 * scale, dt
    # no rotation, or one below the axis threshold: exactly zero velocity
    assert (quat.angular_velocity(_t(q), _t(q), 0.1)[64:66] == 0).all()


def _jax_start(jenv, frames, qvel_table):
    def one(i):
        st = jenv.reset(jax.random.PRNGKey(0))
        qp, qv = jenv.clip_qpos[i], qvel_table[i]
        return dataclasses.replace(st, qpos=qp, qvel=qv, obs=jenv._obs(qp, qv),
                                   init_idx=i)
    return jax.vmap(one)(jnp.asarray(frames))


def _run_both(jenv, tenv, qvel_table, steps=10):
    """Both envs from ``FRAMES`` through the same actions: the per-step
    states of each."""
    js = _jax_start(jenv, FRAMES, qvel_table)
    ts = tenv.reset_at(FRAMES)
    out = [(js, ts)]
    acts = 0.1 * np.random.RandomState(1).randn(steps, len(FRAMES), 28)
    step = jax.jit(jax.vmap(jenv.step))
    for a in acts.astype(np.float32):
        js, ts = step(js, jnp.asarray(a)), tenv.step(ts, _t(a))
        out.append((js, ts))
    return out, acts


def _assert_states_match(out):
    """qpos, qvel and obs within 1e-4, rewards within 1e-5, the integer
    fields and done exactly."""
    for js, ts in out:
        for k, atol in (("qpos", 1e-4), ("qvel", 1e-4), ("obs", 1e-4),
                        ("reward", 1e-5)):
            np.testing.assert_allclose(getattr(ts, k).numpy(),
                                       np.asarray(getattr(js, k)),
                                       atol=atol, rtol=0, err_msg=k)
        for k in ("done", "mocap_idx", "init_idx", "step_count"):
            np.testing.assert_array_equal(getattr(ts, k).numpy(),
                                          np.asarray(getattr(js, k)), k)


def test_dp_env_v2_ten_steps_match_jax():
    """4 envs × 10 control steps of DPEnvV2 at its 6 substeps (dt 0.002),
    from the same frames and actions: the bounds of
    :func:`_assert_states_match`; rewards in (−1, 1]."""
    jenv, tenv = jv2.DPEnvV2(), tv2.DPEnvV2(device="cpu")
    assert (tenv.model.dt, tenv.n_substeps) == (0.002, 6)
    assert (tenv.observation_size, tenv.action_size) == (67, 28)
    assert not hasattr(tenv, "reset_init")
    out, _ = _run_both(jenv, tenv, jenv.clip_qvel)
    _assert_states_match(out)
    rew = np.stack([ts.reward.numpy() for _, ts in out[1:]])
    assert (rew > -1).all() and (rew <= 1).all()
    np.testing.assert_array_equal(out[-1][1].mocap_idx.numpy(), 10)


def test_dp_env_v1_table_and_ten_steps_match_jax():
    """DPEnvV1: the reset velocity table within 1e-5 of JAX's (f32, the
    double-aligned angular velocities), the same gating period (2 for
    walk); 4 envs × 10 control steps at 6 substeps within the bounds of
    :func:`_assert_states_match`, the reward exactly −0.1·Σa² on the
    ungated (odd) steps."""
    jenv, tenv = jv1.DPEnvV1(), tv1.DPEnvV1(device="cpu")
    assert tenv.update_interval == jenv.update_interval == 2
    np.testing.assert_allclose(tenv._reset_qvel.numpy(),
                               np.asarray(jenv._reset_qvel), atol=1e-5,
                               rtol=0)
    out, acts = _run_both(jenv, tenv, jenv._reset_qvel)
    _assert_states_match(out)
    for t in range(1, 11, 2):
        ctrl = -0.1 * torch.sum(torch.square(_t(acts[t - 1].astype(
            np.float32))), dim=1)
        torch.testing.assert_close(out[t][1].reward, ctrl, atol=0, rtol=0)
    assert (out[2][1].reward > 0.1).all()


def test_reset_draws_frames_with_their_velocities():
    """``reset`` starts each env at a clip frame, with the clip's velocity
    (V2) or the table's (V1); the cursor starts at 0."""
    gen = torch.Generator().manual_seed(0)
    for env, table in ((tv2.DPEnvV2(device="cpu"), "clip_qvel"),
                       (tv1.DPEnvV1(device="cpu"), "_reset_qvel")):
        st = env.reset(gen, 64)
        assert len(set(st.init_idx.tolist())) > 10
        torch.testing.assert_close(st.qvel, getattr(env, table)[st.init_idx])
        torch.testing.assert_close(st.qpos, env.clip_qpos[st.init_idx])
        assert (st.mocap_idx == 0).all() and (st.step_count == 0).all()


@pytest.mark.parametrize("env_id", ["DPEnvV1", "DPEnvV2"])
def test_cli_env_id_builds_a_dt_0002_model_with_24_solves_per_step(
        env_id, tmp_path, monkeypatch):
    """``--env-id DPEnvV1|DPEnvV2``: the env's model at dt 0.002 with 6
    substeps (not the CLI's default model at 0.0166), 24 calls of
    ``ops.apgd.apgd`` per control step (counted by wrapping it: the
    kernel's own counter counts launches on the card only), the V3-only
    flags ignored; training writes ``{env_id}/trpo-walk-0`` logs and a
    checkpoint that reads back; ``--warm-iterations``, ``--joint-limits
    mocap`` and a ``--motion`` list are refused."""
    argv = ["--env-id", env_id, "--device", "cpu", "--n-substeps", "3",
            "--reward-mode", "imitation_dm", "--control-mode", "pd_residual"]
    args = train_trpo.build_parser().parse_args(argv)
    env = train_trpo.make_env(args, train_trpo.make_model(args, "cpu"))
    assert type(env).__name__ == env_id
    assert (env.model.dt, env.n_substeps) == (0.002, 6)
    calls = []
    real = solver.apgd
    monkeypatch.setattr(solver, "apgd",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    st = env.step(env.reset_at([0, 5]), torch.zeros(2, 28))
    assert len(calls) == 24 and torch.isfinite(st.qpos).all()
    monkeypatch.undo()

    monkeypatch.chdir(tmp_path)
    state = train_trpo.main(argv + ["--task", "train", "--num-envs", "2",
                                    "--timesteps-per-batch", "4",
                                    "--g-step", "1", "--num-iters", "1"])
    assert state.env_state.obs.shape == (2, 67)
    name = os.path.join(env_id, "trpo-walk-0")
    assert os.path.exists(os.path.join("log_tmp", name, "progress.csv"))
    policy = MlpPolicy(ob_dim=67, ac_dim=28)
    params = checkpoint.load_trpo_params(
        os.path.join("checkpoint_tmp", name, "trpo_state.npz"), policy, "cpu")
    torch.testing.assert_close(params["pol"], state.params["pol"])
    for bad in (["--warm-iterations", "10"], ["--joint-limits", "mocap"],
                ["--motion", "walk,run"]):
        with pytest.raises(ValueError):
            train_trpo.main(["--env-id", env_id, "--device", "cpu"] + bad)


@pytest.mark.parametrize("env_cls", [tv1.DPEnvV1, tv2.DPEnvV2])
def test_trpo_trains_v1_v2(env_cls):
    """One ``TRPO.iteration`` on each (the configuration of
    ``tests/test_envs.py::test_trpo_trains_v1_v2``): the noise reset falls
    back to the env's RSI ``reset``; the stats are finite."""
    env = env_cls(device="cpu")
    policy = MlpPolicy(ob_dim=env.observation_size, ac_dim=env.action_size)
    learner = TRPO(env, policy, TRPOConfig(
        horizon=6, num_envs=2, g_step=1, cg_iters=2, vf_iters=1,
        vf_batch_size=4, line_search_steps=2))
    state, stats = learner.iteration(learner.init(
        torch.Generator().manual_seed(0)))
    assert np.isfinite(float(stats.meankl)) and np.isfinite(
        float(stats.entropy))
    assert state.env_state.qpos.shape == (2, 35)


def _stdout(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(argv)
    return buf.getvalue(), out


def test_torque_test_and_play_mocap_print_jax_lines(monkeypatch):
    """``torque_test --steps 40`` and ``play_mocap --through-dynamics
    --cycles 2`` (spinkick's 78 frames as one batch) print JAX's lines, to
    their 3-4 printed digits; the played track chains the root.  Without
    MuJoCo, ``--video`` raises an ImportError naming it before anything
    plays (the rendering itself: ``tests/test_torch_render.py``)."""
    out, mean = _stdout(torque_test.main, ["--device", "cpu", "--steps", "40"])
    ref, _ = _stdout(jax_torque_test.main, ["--steps", "40"])
    assert out == ref
    assert f"{mean:.4f}" in out
    out, track = _stdout(play_mocap.main, ["--device", "cpu",
                                           "--through-dynamics",
                                           "--cycles", "2"])
    ref, _ = _stdout(jax_play_mocap.main, ["--through-dynamics", "--cycles",
                                           "2"])
    assert out == ref and "cycle 1: mean config reward" in out
    assert track.shape == (156, 35)
    np.testing.assert_allclose(track[78, :2], track[77, :2] + track[0, :2])
    monkeypatch.setitem(sys.modules, "mujoco", None)
    with pytest.raises(ImportError, match="mujoco") as err:
        _stdout(play_mocap.main, ["--device", "cpu", "--video", "x.avi"])
    assert err.value.name == "mujoco"
