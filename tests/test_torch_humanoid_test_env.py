"""The port's ``HumanoidTestEnv`` (``deepmimic_mujoco_torch/envs/
humanoid_test_env.py``) against the JAX package on the CPU: the 387-D obs
(qpos, qvel, cinert, cvel, qfrc_actuator and the floor contacts' cfrc_ext
from a cold ``engine.forward``), the Humanoid-v2 reward and the root
height termination.

Both stacks start from the same noise around the standing pose (a numpy
seed) and take the same actions.  The JAX side jits two physics programs:
the reset's obs (one forward) and ``jax.vmap(env.step)`` (5 substeps and a
forward).  Obs are compared per block, within 1e-4 of max(1, |x|) of the
block: the contact wrenches reach ~10^3."""

import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from deepmimic_mujoco_tpu.envs import humanoid_test_env as jhte
from deepmimic_mujoco_torch.envs import humanoid_test_env as thte
from deepmimic_mujoco_torch.envs.vector import VectorEnv

torch.set_num_threads(1)

B = 4
NB = 13
BLOCKS = {"qpos[2:]": (0, 33), "qvel": (33, 67), "cinert": (67, 67 + 10 * NB),
          "cvel": (67 + 10 * NB, 67 + 16 * NB),
          "qfrc_actuator": (67 + 16 * NB, 101 + 16 * NB),
          "cfrc_ext": (101 + 16 * NB, 101 + 22 * NB)}


def _blockwise(out, ref, bound):
    for name, (a, b) in BLOCKS.items():
        scale = max(1.0, float(np.abs(ref[:, a:b]).max()))
        err = float(np.abs(out[:, a:b] - ref[:, a:b]).max())
        assert err <= bound * scale, (name, err, scale)


def test_reset_and_five_steps_match_jax():
    """4 envs from qpos0 + U(−0.01, 0.01), qvel = U(−0.01, 0.01) (numpy
    seed 0), 5 steps of the same actions (0.1·N(0, 1), numpy seed 1; no
    root height comes within 1e-3 of the 0.8 threshold): obs within 1e-4
    of max(1, |x|) per block, rewards within 1e-4, done flags equal; the
    obs is 387-D."""
    jenv, tenv = jhte.HumanoidTestEnv(), thte.HumanoidTestEnv(device="cpu")
    assert tenv.observation_size == jenv.observation_size == 387
    rng = np.random.RandomState(0)
    qpos0 = tenv.model.qpos0.numpy()
    qpos = (qpos0 + rng.uniform(-0.01, 0.01, (B, 35))).astype(np.float32)
    qvel = rng.uniform(-0.01, 0.01, (B, 34)).astype(np.float32)

    def start(qp, qv):
        st = jenv.reset(jax.random.PRNGKey(0))
        return dataclasses.replace(st, qpos=qp, qvel=qv,
                                   obs=jenv._obs(qp, qv, jnp.zeros(28)))

    js = jax.jit(jax.vmap(start))(jnp.asarray(qpos), jnp.asarray(qvel))
    ts = tenv.reset_to(torch.as_tensor(qpos), torch.as_tensor(qvel))
    _blockwise(ts.obs.numpy(), np.asarray(js.obs), 1e-4)
    acts = 0.1 * np.random.RandomState(1).randn(5, B, 28).astype(np.float32)
    step = jax.jit(jax.vmap(jenv.step))
    closest = np.inf
    for a in acts:
        js, ts = step(js, jnp.asarray(a)), tenv.step(ts, torch.as_tensor(a))
        _blockwise(ts.obs.numpy(), np.asarray(js.obs), 1e-4)
        np.testing.assert_allclose(ts.reward.numpy(), np.asarray(js.reward),
                                   atol=1e-4, rtol=0)
        np.testing.assert_array_equal(ts.done.numpy(), np.asarray(js.done))
        closest = min(closest, float(np.abs(np.asarray(js.qpos)[:, 2]
                                            - 0.8).min()))
    print(f"closest approach of the root height to 0.8: {closest:.4f}")
    assert closest > 1e-3
    # the contacts carry forces: cfrc_ext is not all zero
    a, b = BLOCKS["cfrc_ext"]
    assert np.abs(ts.obs.numpy()[:, a:b]).max() > 1.0


def test_reset_is_the_noise_reset_and_vector_env_keeps_it():
    """``reset`` = ``reset_init``: qpos within ±0.01 of qpos0, qvel within
    ±0.01, from the generator; a ``VectorEnv`` over it keeps the "init"
    auto-reset."""
    env = thte.HumanoidTestEnv(device="cpu")
    assert env.reset_init == env.reset
    st = env.reset(torch.Generator().manual_seed(3), 8)
    d = (st.qpos - env.model.qpos0).abs()
    assert d.max() <= 0.01 and d.max() > 0.005
    assert st.qvel.abs().max() <= 0.01
    assert st.obs.shape == (8, 387) and torch.isfinite(st.obs).all()
    again = env.reset(torch.Generator().manual_seed(3), 8)
    torch.testing.assert_close(again.obs, st.obs, atol=0, rtol=0)
    assert VectorEnv(env, 8).autoreset == "init"
