"""The port's host-MuJoCo backend (``physics/mj_host.py``) against the JAX
package's on the CPU, the env and CLI that reach it, and the port's
statics against MuJoCo itself (as ``tests/test_physics.py::
TestStaticsVsMujoco`` holds the JAX engine).

MuJoCo's solver warm-starts from the previous call's accelerations in each
cached ``MjData``, in both stacks, so each comparison clears both caches
first and makes the same calls.  No JAX physics program is jitted."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

mujoco = pytest.importorskip("mujoco")

from deepmimic_mujoco_tpu.physics import build_humanoid as jax_build  # noqa: E402
from deepmimic_mujoco_tpu.physics import mj_host as jmj  # noqa: E402
from deepmimic_mujoco_torch.cli import train_trpo  # noqa: E402
from deepmimic_mujoco_torch.envs.dp_env_v3 import DPEnvV3  # noqa: E402
from deepmimic_mujoco_torch.mocap.loader import load_clip  # noqa: E402
from deepmimic_mujoco_torch.physics import (dynamics, engine,  # noqa: E402
                                            kinematics, mj_host)
from deepmimic_mujoco_torch.physics.humanoid import (  # noqa: E402
    build_humanoid,
    mocap_hinge_range,
    to_mjcf,
)

torch.set_num_threads(1)


def _fresh_pools():
    for fn in (jmj._mj_handles, jmj._mj_pool, mj_host._mj_model,
               mj_host._mj_pool):
        fn.cache_clear()


@pytest.fixture(scope="module")
def starts():
    """12 envs: walk frames sunk 1 cm (contacts), torques U(−0.5, 0.5)."""
    clip = load_clip("walk")
    idx = np.arange(12) * 3 % len(clip)
    qp = np.asarray(clip.qpos_cont[idx], np.float32).copy()
    qp[:, 2] -= 0.01
    qv = np.asarray(clip.qvel_fd[idx], np.float32)
    ctrl = np.random.RandomState(0).uniform(-0.5, 0.5, (3, 12, 28)).astype(
        np.float32)
    return qp, qv, ctrl


@pytest.mark.parametrize("n_envs,n_substeps", [(12, 1), (12, 2), (1, 3)])
def test_step_matches_jax_mj_host(starts, n_envs, n_substeps):
    """Three chained calls from fresh caches (8 threads at 12 envs, 1 at
    one env): qpos and qvel within 1e-6 absolute of JAX's, float32, on the
    input's device; the state moved."""
    qp, qv, ctrl = (x[..., :n_envs, :] for x in starts)
    _fresh_pools()
    jdyn = jmj.MJHostDynamics(jax_build())
    tdyn = mj_host.MJHostDynamics(build_humanoid(device="cpu"))
    assert tdyn.xml == jdyn.xml
    jq, jv = jnp.asarray(qp), jnp.asarray(qv)
    tq, tv = torch.as_tensor(qp), torch.as_tensor(qv)
    for c in ctrl:
        jq, jv = jdyn.step(jq, jv, jnp.asarray(c), n_substeps=n_substeps)
        tq, tv = tdyn.step(tq, tv, torch.as_tensor(c), n_substeps=n_substeps)
        assert tq.dtype == torch.float32 and tq.device.type == "cpu"
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-6)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)
    assert float(np.abs(tq.numpy() - qp).max()) > 1e-3


def test_a_model_mujoco_does_not_match_is_refused():
    """An explicit MJCF whose nq/nv differ from the model's raises."""
    xml = """<mujoco><worldbody><body name="b">
      <joint type="free"/><geom type="sphere" size="0.1" mass="1"/>
      </body></worldbody></mujoco>"""
    with pytest.raises(ValueError, match="mismatch"):
        mj_host.MJHostDynamics(build_humanoid(device="cpu"), xml=xml)


def _mocap_ranges():
    return mocap_hinge_range(build_humanoid(device="cpu"))


def _double_gears():
    m = build_humanoid(device="cpu")
    return dataclasses.replace(m, actuator_gear=2.0 * m.actuator_gear)


@pytest.mark.parametrize("make", [_mocap_ranges, _double_gears])
def test_a_model_the_humanoid_mjcf_does_not_describe_is_refused(make):
    """The default XML is the humanoid's, written from the tables of
    ``physics/humanoid.py``: a model with other hinge ranges or gears
    raises instead of being stepped as the stock humanoid."""
    with pytest.raises(ValueError, match="differs from the humanoid MJCF"):
        mj_host.MJHostDynamics(make())


def test_cli_refuses_mujoco_dynamics_with_mocap_joint_limits(tmp_path):
    """``--joint-limits mocap`` edits the model's ranges, which host MuJoCo
    would not see."""
    with pytest.raises(ValueError, match="hinge_range differs"):
        train_trpo.main([
            "--task", "train", "--dynamics", "mujoco", "--device", "cpu",
            "--joint-limits", "mocap", "--num-envs", "4",
            "--timesteps-per-batch", "8", "--num-iters", "1",
            "--log-dir", str(tmp_path / "logs"),
            "--checkpoint-dir", str(tmp_path / "ckpt")])


def test_env_with_mujoco_dynamics_steps_through_mj_host(starts):
    """``DPEnvV3(dynamics="mujoco")``: torque control only (JAX asserts
    it); its physics is ``MJHostDynamics.step`` of the env's model, the rest
    of the step (obs, reward, termination) the port's."""
    with pytest.raises(ValueError, match="torque control only"):
        DPEnvV3(dynamics="mujoco", control_mode="pd", device="cpu")
    qp, qv, ctrl = starts
    env = DPEnvV3(dynamics="mujoco", device="cpu")
    state = env.reset_at(np.arange(12) * 3 % env.clip_len)
    _fresh_pools()
    out = env.step(state, torch.as_tensor(ctrl[0]))
    _fresh_pools()
    ref = mj_host.MJHostDynamics(env.model).step(
        state.qpos, state.qvel, torch.as_tensor(ctrl[0]))
    assert torch.equal(out.qpos, ref[0]) and torch.equal(out.qvel, ref[1])
    assert out.obs.shape == (12, 56) and torch.equal(out.reward,
                                                     torch.ones(12))


def test_cli_trains_one_iteration_on_mujoco_dynamics(tmp_path):
    """``train_trpo --dynamics mujoco --device cpu``, 4 envs x 8 steps x 1
    iteration: the log row and the checkpoint are written."""
    state = train_trpo.main([
        "--task", "train", "--dynamics", "mujoco", "--device", "cpu",
        "--num-envs", "4", "--timesteps-per-batch", "8", "--g-step", "1",
        "--num-iters", "1", "--log-dir", str(tmp_path / "logs"),
        "--checkpoint-dir", str(tmp_path / "ckpt")])
    run = os.path.join("DPEnvV3", "trpo-walk-0")
    with open(tmp_path / "logs" / run / "progress.csv") as f:
        rows = f.read().strip().splitlines()
    assert len(rows) == 2
    assert (tmp_path / "ckpt" / run / "trpo_state.npz").exists()
    assert all(torch.isfinite(l["w"]).all() for l in state.params["pol"])


# ---------------------------------------------------------------------------
# the port's statics against MuJoCo


@pytest.fixture(scope="module")
def mj_state():
    """``TestStaticsVsMujoco``'s random state and MuJoCo's forward there."""
    m = mujoco.MjModel.from_xml_string(to_mjcf())
    rng = np.random.RandomState(0)
    qpos = np.zeros(m.nq)
    qpos[:3] = [0.1, 0.2, 1.0]
    q = rng.randn(4)
    qpos[3:7] = q / np.linalg.norm(q)
    qpos[7:] = rng.uniform(-0.5, 0.5, 28)
    qvel = rng.randn(m.nv) * 0.5
    d = mujoco.MjData(m)
    d.qpos[:] = qpos
    d.qvel[:] = qvel
    mujoco.mj_forward(m, d)
    model = build_humanoid(warm_iterations=0, solver_dtype="f32",
                           stage_reuse="none", device="cpu")
    kin = kinematics.fk(model, torch.as_tensor(qpos[None], dtype=torch.float32))
    return m, d, model, kin, qvel


def test_fk_matches_mujoco(mj_state):
    """Body positions, COMs and orientations within 1e-5."""
    _, d, _, kin, _ = mj_state
    np.testing.assert_allclose(kin.xpos[0].numpy(), d.xpos[1:], atol=1e-5)
    np.testing.assert_allclose(kin.xcom[0].numpy(), d.xipos[1:], atol=1e-5)
    xq, mq = kin.xquat[0].numpy(), d.xquat[1:]
    sign = np.sign(np.sum(xq * mq, axis=1, keepdims=True))
    np.testing.assert_allclose(xq, mq * sign, atol=1e-5)


def test_mass_matrix_matches_mujoco(mj_state):
    """The dense M within 1e-5 (entries up to 45)."""
    m, d, model, kin, _ = mj_state
    full = np.zeros((m.nv, m.nv))
    mujoco.mj_fullM(m, d, full)
    np.testing.assert_allclose(
        dynamics.mass_matrix(model, kin)[0].numpy(), full, atol=1e-5)


def test_bias_and_airborne_forward_match_mujoco(mj_state):
    """The bias force within 1e-3 and the contact-free forward's qacc
    within 5e-3 (``TestStaticsVsMujoco``'s budgets: f32 against f64)."""
    m, d, model, kin, qvel = mj_state
    bias = dynamics.bias_force(model, kin, torch.as_tensor(
        qvel[None], dtype=torch.float32))[0].numpy()
    np.testing.assert_allclose(bias, d.qfrc_bias, atol=1e-3)
    rng = np.random.RandomState(1)
    qpos = model.qpos0.numpy().astype(np.float64).copy()
    qpos[2] = 50.0
    qpos[7:] = 0.5 * (m.jnt_range[1:, 0] + m.jnt_range[1:, 1])
    qv = rng.randn(34) * 0.5
    ctrl = rng.uniform(-0.3, 0.3, 28)
    d2 = mujoco.MjData(m)
    d2.qpos[:], d2.qvel[:], d2.ctrl[:] = qpos, qv, ctrl
    mujoco.mj_forward(m, d2)
    f32 = lambda x: torch.as_tensor(x[None], dtype=torch.float32)  # noqa
    fwd = engine.forward(model, f32(qpos), f32(qv), f32(ctrl))
    np.testing.assert_allclose(fwd.qacc[0].numpy(), d2.qacc, atol=5e-3)
