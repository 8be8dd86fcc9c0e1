"""The port's APGD solve (``deepmimic_mujoco_torch/ops/apgd.py``) against
the JAX reference (``deepmimic_mujoco_tpu/ops/apgd.py``) on the CPU.

On CPU tensors the port's entry points and dispatch run the plain PyTorch
version; the JAX side runs its XLA scan and its two Pallas kernels in
interpret mode, as ``tests/test_ops.py`` does.  Inputs are made with numpy
from a seed and handed to both stacks.

Tolerance: atol 1e-4 at 60 iterations, ``TestAPGD``'s — the iterates are
the same, only the sums of the matvec and the row sums run in another
order (the observed differences are ~4e-7)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepmimic_mujoco_tpu.ops import apgd as japgd
from deepmimic_mujoco_torch.ops import apgd as tapgd

torch.set_num_threads(1)

ATOL = 1e-4
ITERS = 60


def _problem(seed, B, nc, nl):
    """SPD dual systems (interleaved layout), friction in [0.5, 1.5] and a
    warm start that the first projection has to fix."""
    rng = np.random.RandomState(seed)
    ne = nc * 3 + nl
    m = rng.randn(B, ne, ne)
    a = np.einsum("bij,bkj->bik", m, m) / ne + 0.5 * np.eye(ne)
    b = rng.randn(B, ne)
    mu = rng.uniform(0.5, 1.5, (B, nc))
    f0 = 0.1 * rng.randn(B, ne)
    return tuple(np.asarray(x, np.float32) for x in (a, b, mu, f0))


def _jax_scan(a, b, mu, f0, nc, nl, bf16, iters=ITERS):
    a = jnp.asarray(a)
    if bf16:
        a = a.astype(jnp.bfloat16)
    return np.asarray(jax.vmap(lambda a_, b_, m_, f_: japgd._apgd_scan(
        a_, b_, m_, f_, iterations=iters, nc=nc, nl=nl))(a, b, mu, f0))


def _t(x, bf16=False):
    t = torch.as_tensor(x)
    return t.to(torch.bfloat16) if bf16 else t


def _group(a, b, mu, f0, nc, nl):
    perm, _ = japgd._group_perm(nc, nl)
    return a[:, perm][:, :, perm], b[:, perm], mu, f0[:, perm]


def test_group_perm_matches_jax():
    for nc, nl in ((8, 8), (3, 2), (0, 4)):
        p_j, i_j = japgd._group_perm(nc, nl)
        p_t, i_t = tapgd._group_perm(nc, nl)
        np.testing.assert_array_equal(p_j, p_t)
        np.testing.assert_array_equal(i_j, i_t)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("B", [8, 5])
def test_scan_matches_jax_scan(B, bf16):
    nc, nl = 4, 5
    a, b, mu, f0 = _problem(B + 10 * bf16, B, nc, nl)
    ref = _jax_scan(a, b, mu, f0, nc, nl, bf16)
    out = tapgd._apgd_scan(_t(a, bf16), _t(b), _t(mu), _t(f0),
                           iterations=ITERS, nc=nc, nl=nl)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("layout", ["blocks", "lanes"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_dispatch_matches_jax_scan(layout, bf16):
    """The solver's dispatch (interleaved in and out) at the main path's
    nc = nl = 8 and a batch that is no multiple of any block."""
    nc, nl, B = 8, 8, 5
    a, b, mu, f0 = _problem(3, B, nc, nl)
    ref = _jax_scan(a, b, mu, f0, nc, nl, bf16)
    out = tapgd.apgd(_t(a, bf16), _t(b), _t(mu), _t(f0), iterations=ITERS,
                     nc=nc, nl=nl, layout=layout)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_apgd_solve_matches_pallas_interpret(bf16):
    """Entry point of the batch-major kernel vs ``apgd_solve(...,
    interpret=True)``, grouped layout."""
    nc, nl, B = 4, 5, 8
    a, b, mu, f0 = _group(*_problem(4, B, nc, nl), nc, nl)
    ja = jnp.asarray(a).astype(jnp.bfloat16) if bf16 else jnp.asarray(a)
    ref = np.asarray(japgd.apgd_solve(ja, b, mu, f0, iterations=ITERS, nc=nc,
                                      nl=nl, block=4, interpret=True))
    out = tapgd.apgd_solve(_t(a, bf16), _t(b), _t(mu), _t(f0),
                           iterations=ITERS, nc=nc, nl=nl)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_apgd_solve_lanes_matches_pallas_interpret(bf16):
    """Entry point of the env-axis-last kernel vs ``apgd_solve_lanes(...,
    interpret=True)``, grouped layout."""
    nc, nl, B = 4, 5, 8
    a, b, mu, f0 = _group(*_problem(5, B, nc, nl), nc, nl)
    a_l = np.ascontiguousarray(np.transpose(a, (1, 2, 0)))
    b_l, mu_l, f0_l = (np.ascontiguousarray(x.T) for x in (b, mu, f0))
    ja = jnp.asarray(a_l).astype(jnp.bfloat16) if bf16 else jnp.asarray(a_l)
    ref = np.asarray(japgd.apgd_solve_lanes(
        ja, b_l, mu_l, f0_l, iterations=ITERS, nc=nc, nl=nl, block=4,
        interpret=True))
    out = tapgd.apgd_solve_lanes(_t(a_l, bf16), _t(b_l), _t(mu_l), _t(f0_l),
                                 iterations=ITERS, nc=nc, nl=nl)
    assert out.shape == (nc * 3 + nl, B)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("layout", ["blocks", "lanes"])
def test_dispatch_matches_padded_pallas_dispatch(layout):
    """B = 5 against JAX's ``make_apgd`` Pallas dispatch, which pads to the
    block (4) and permutes around the kernel; the port masks instead."""
    nc, nl, B = 3, 2, 5
    a, b, mu, f0 = _problem(6, B, nc, nl)
    fn = japgd.make_apgd(40, nc, nl, use_pallas=True, block=4,
                         interpret=True, layout=layout)
    ref = np.asarray(jax.vmap(fn)(a, b, mu, f0))
    out = tapgd.apgd(_t(a), _t(b), _t(mu), _t(f0), iterations=40, nc=nc,
                     nl=nl, layout=layout)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


def test_solution_satisfies_cone():
    nc, nl, B = 4, 3, 4
    a, b, mu, f0 = _problem(7, B, nc, nl)
    out = tapgd._apgd_scan(_t(a), _t(b), _t(mu), _t(f0) * 0, iterations=100,
                           nc=nc, nl=nl).numpy()
    fc = out[:, :nc * 3].reshape(B, nc, 3)
    fn = fc[..., 0]
    ft = np.linalg.norm(fc[..., 1:], axis=-1)
    assert (fn >= -1e-6).all()
    assert (ft <= fn * mu + 1e-4).all()
    assert (out[:, nc * 3:] >= -1e-6).all()


def test_zero_iterations_is_the_projected_warm_start():
    nc, nl, B = 4, 5, 3
    a, b, mu, f0 = _problem(8, B, nc, nl)
    ref = _jax_scan(a, b, mu, f0, nc, nl, False, iters=0)
    out = tapgd.apgd(_t(a), _t(b), _t(mu), _t(f0), iterations=0, nc=nc,
                     nl=nl)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("fn", [tapgd.apgd_solve, tapgd.apgd_solve_lanes])
def test_wrappers_refuse_tensors_off_cpu_and_cuda(fn):
    """Off the CPU a wrapper launches the kernel or raises; a tensor on any
    other device than CUDA raises before anything is built."""
    nc, nl, B = 8, 8, 4
    ne = 3 * nc + nl
    lanes = fn is tapgd.apgd_solve_lanes
    shp = (lambda *s: tuple(reversed(s))) if lanes else (lambda *s: s)
    a = _meta(ne, ne, B) if lanes else _meta(B, ne, ne)
    with pytest.raises(ValueError, match="CUDA"):
        fn(a, _meta(*shp(B, ne)), _meta(*shp(B, nc)), _meta(*shp(B, ne)),
           iterations=8, nc=nc, nl=nl)
    assert fn.launches == 0


def test_wrapper_rejects_ne_over_32_and_bad_dtypes():
    B, nc, nl = 4, 10, 4  # ne = 34 > one warp
    ne = 3 * nc + nl
    with pytest.raises(ValueError, match="ne <= 32"):
        tapgd._check(_meta(B, ne, ne), _meta(B, ne), _meta(B, nc),
                     _meta(B, ne), nc, nl, 8, lanes=False)
    with pytest.raises(ValueError, match="3\\*nc"):
        tapgd._check(_meta(B, 32, 32), _meta(B, 32), _meta(B, 8),
                     _meta(B, 32), 8, 7, 8, lanes=False)
    with pytest.raises(ValueError, match="shape"):
        tapgd._check(_meta(B, 32, 32), _meta(B, 31), _meta(B, 8),
                     _meta(B, 32), 8, 8, 8, lanes=False)
    with pytest.raises(TypeError, match="dtype"):
        tapgd._check(_meta(B, 32, 32, dtype=torch.float16), _meta(B, 32),
                     _meta(B, 8), _meta(B, 32), 8, 8, 8, lanes=False)
    with pytest.raises(TypeError, match="dtype"):
        tapgd._check(_meta(32, 32, B), _meta(32, B),
                     _meta(8, B, dtype=torch.float64), _meta(32, B), 8, 8, 8,
                     lanes=True)
