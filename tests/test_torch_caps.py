"""Dual systems larger than the tensor-core kernel's 32 rows, on the CPU:
the port's dispatch (``ops/apgd.py:apgd``, which sends ne > 32 to
``apgd_solve_wide``; on CPU tensors its plain version) against the JAX
package's ``_apgd_scan``, and one env step of the humanoid with 16/16
contact/limit caps (ne = 64) in both stacks.

The wide kernel itself runs only on the card (``tests/test_torch_cuda.py``);
here its wrapper's shape checks and routing are exercised."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepmimic_mujoco_tpu.envs import DPEnvV3 as JaxDPEnvV3
from deepmimic_mujoco_tpu.ops import apgd as japgd
from deepmimic_mujoco_tpu.physics import build_humanoid as jax_build
from deepmimic_mujoco_torch.envs.dp_env_v3 import DPEnvV3
from deepmimic_mujoco_torch.ops import apgd as tapgd
from deepmimic_mujoco_torch.physics.humanoid import build_humanoid

torch.set_num_threads(1)

ATOL = 1e-4  # TestAPGD's: the same iterates, sums in another order


@pytest.mark.parametrize("nc,nl", [(11, 0), (16, 16), (37, 28)],
                         ids=["ne33", "ne64", "ne139"])
def test_wide_dispatch_matches_jax_scan(nc, nl):
    rng = np.random.RandomState(nc)
    B, ne = 6, 3 * nc + nl
    m = rng.randn(B, ne, ne)
    a = np.einsum("bij,bkj->bik", m, m) / ne + 0.5 * np.eye(ne)
    b = rng.randn(B, ne)
    mu = rng.uniform(0.5, 1.5, (B, nc))
    f0 = 0.1 * rng.randn(B, ne)
    a, b, mu, f0 = (np.asarray(x, np.float32) for x in (a, b, mu, f0))
    ref = jax.vmap(lambda *x: japgd._apgd_scan(
        *x, iterations=60, nc=nc, nl=nl))(a, b, mu, f0)
    n0 = tapgd.apgd_solve_wide.launches
    out = tapgd.apgd(*(torch.as_tensor(x) for x in (a, b, mu, f0)),
                     iterations=60, nc=nc, nl=nl)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)
    assert tapgd.apgd_solve_wide.launches == n0  # the CPU launches nothing


def test_caps16_env_step_matches_jax():
    """One ``DPEnvV3.step`` of 4 envs with 16/16 caps from walk frames,
    random torques: qpos within 1e-4 and qvel within 1e-3 of JAX, the
    one-step budgets of the default model (``test_torch_physics``)."""
    frames = np.array([0, 9, 21, 33])
    ac = (0.3 * np.random.RandomState(3).randn(4, 28)).astype(np.float32)
    jenv = JaxDPEnvV3(clip="walk", model=jax_build(contact_cap=16,
                                                   limit_cap=16))
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    js = jax.jit(jax.vmap(lambda k, i, a: jenv.step(jenv.reset_at(k, i), a)))(
        keys, jnp.asarray(frames), ac)
    model = build_humanoid(contact_cap=16, limit_cap=16, device="cpu")
    assert 3 * int(model.max_contacts) + int(model.max_limits) == 64
    tenv = DPEnvV3(clip="walk", model=model)
    ts = tenv.step(tenv.reset_at(frames), torch.as_tensor(ac))
    assert np.abs(ts.qpos.numpy() - np.asarray(js.qpos)).max() < 1e-4
    assert np.abs(ts.qvel.numpy() - np.asarray(js.qvel)).max() < 1e-3
    np.testing.assert_array_equal(ts.done.numpy(), np.asarray(js.done))
