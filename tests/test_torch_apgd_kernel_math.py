"""The arithmetic of the port's APGD kernel (``deepmimic_mujoco_torch/ops/
csrc/apgd.cu``), emulated in PyTorch on the CPU and held against the JAX
reference (``deepmimic_mujoco_tpu/ops/apgd.py``).

The kernel cannot run here, so these tests check its design's numbers
before the code reaches the card:

* the slot map (input row ↔ one of 32 slots of the two mma tiles) and its
  inverse, against ``_group_perm`` of both packages;
* the three-piece bf16 split of y (y = hi + mid + lo), which rebuilds y to
  within 2⁻²⁴ relative;
* the whole solve as the kernel computes it — A (bf16, or f32 split into
  three bf16 pieces) times the split y, summed in f32 column by column; the
  host's momentum table; 1/(1+μ²) once per contact; t = x·rsqrt(x) — within
  atol 1e-4 of JAX's ``_apgd_scan`` and of the Pallas kernel in interpret
  mode at 60 iterations, the tolerance of ``tests/test_torch_apgd.py``.

Inputs are made with numpy from a seed and handed to both stacks."""

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
SLOTS = 32
SHAPES = [(8, 8), (3, 2), (0, 4), (8, 0), (0, 5), (10, 2), (2, 20)]


def _slots8(nc, nl):
    return nc <= 8 and nl <= 8


def _slot_row(s, nc, nl, interleaved):
    """``slot_row`` of ``apgd.cu``: the input row of slot s, or -1."""
    ne = 3 * nc + nl
    if _slots8(nc, nl):
        if s >= 24:
            return 3 * nc + s - 24 if s - 24 < nl else -1
        comp, c = s >> 3, s & 7
        if c >= nc:
            return -1
    else:
        if s >= ne:
            return -1
        if s >= 3 * nc:
            return s
        comp, c = divmod(s, nc)
    return 3 * c + comp if interleaved else comp * nc + c


def _slot_rows(nc, nl, interleaved):
    return np.array([_slot_row(s, nc, nl, interleaved) for s in range(SLOTS)])


@pytest.mark.parametrize("nc,nl", SHAPES)
def test_slot_map_and_inverse_match_group_perm(nc, nl):
    ne = 3 * nc + nl
    grouped = _slot_rows(nc, nl, False)
    inter = _slot_rows(nc, nl, True)
    used = grouped >= 0
    np.testing.assert_array_equal(used, inter >= 0)
    # a bijection between the used slots and the ne rows, in both orders
    np.testing.assert_array_equal(np.sort(grouped[used]), np.arange(ne))
    np.testing.assert_array_equal(np.sort(inter[used]), np.arange(ne))
    for pkg in (japgd, tapgd):
        perm, inv = pkg._group_perm(nc, nl)  # x_grouped = x_interleaved[perm]
        np.testing.assert_array_equal(inter[used], perm[grouped[used]])
        np.testing.assert_array_equal(inv[inter[used]], grouped[used])
    if _slots8(nc, nl):
        # contact c's triple and limit c sit in slots c, c+8, c+16, c+24:
        # the rows that lanes 4c and 4c+1 hold in the mma accumulator
        for c in range(nc):
            np.testing.assert_array_equal(grouped[[c, 8 + c, 16 + c]],
                                          [c, nc + c, 2 * nc + c])
        for lim in range(nl):
            assert grouped[24 + lim] == 3 * nc + lim


def _bf16(x):
    """Round to nearest bf16 (``cvt.rn.bf16x2.f32``), back in f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _split3(x):
    """``split3`` of ``apgd.cu``: three bf16 pieces, residuals in f32."""
    pieces = []
    for _ in range(3):
        pieces.append(_bf16(x))
        x = x - pieces[-1]
    return pieces


def test_split3_rebuilds_y_to_2_pow_minus_24():
    rng = np.random.RandomState(0)
    mag = 10.0 ** rng.uniform(-30, 30, 20000)
    y = torch.as_tensor(np.float32(rng.choice([-1, 1], mag.size) * mag
                                   * rng.uniform(1, 2, mag.size)))
    hi, mid, lo = (p.double() for p in _split3(y))
    err = (hi + mid + lo - y.double()).abs()
    assert (err <= 2.0 ** -24 * y.double().abs()).all()
    assert (torch.stack([hi, mid, lo]) == torch.stack(
        [_bf16(p.float()).double() for p in (hi, mid, lo)])).all()
    hi0, mid0, lo0 = _split3(torch.zeros(4))
    assert not (hi0.any() or mid0.any() or lo0.any())


def _emulated_solve(a, b, mu, f0, nc, nl, iterations):
    """The kernel's arithmetic on interleaved inputs: a (B, ne, ne) f32 or
    bf16, b, f0 (B, ne), mu (B, nc) → f (B, ne) f32."""
    B = a.shape[0]
    rows = torch.as_tensor(_slot_rows(nc, nl, True))
    used = rows >= 0
    idx = rows.clamp(min=0)
    a32 = a.float()
    a_s = a32[:, idx[:, None], idx[None, :]] * (used[:, None] & used[None, :])
    a_pieces = [a_s] if a.dtype == torch.bfloat16 else _split3(a_s)
    lip = a_s.abs().sum(-1).amax(-1)
    step = (1.0 / torch.clamp(lip, min=1e-8))[:, None]
    b_s = b[:, idx] * used
    f = f0[:, idx] * used
    # the grouped row of each slot, for the projection
    g_rows = torch.as_tensor(_slot_rows(nc, nl, False))
    slot_of = torch.empty(3 * nc + nl, dtype=torch.long)
    slot_of[g_rows[used]] = torch.arange(SLOTS)[used]
    inv = 1.0 / (1.0 + mu * mu)

    def project(z):
        out = torch.zeros_like(z)
        fn, f1, f2 = (z[:, slot_of[k * nc:(k + 1) * nc]] for k in range(3))
        x = f1 * f1 + f2 * f2 + 1e-20
        t = x * torch.rsqrt(x)
        inside = t <= mu * fn
        below = mu * t <= -fn
        fn_p = torch.clamp((fn + mu * t) * inv, min=0.0)
        scale = torch.where(t > 1e-12, mu * fn_p / t, torch.zeros_like(t))
        res = (torch.where(inside, torch.clamp(fn, min=0.0), fn_p),
               torch.where(inside, f1, f1 * scale),
               torch.where(inside, f2, f2 * scale))
        for k, r in enumerate(res):
            out[:, slot_of[k * nc:(k + 1) * nc]] = torch.where(
                below, torch.zeros_like(r), r)
        lim = slot_of[3 * nc:]
        out[:, lim] = torch.clamp(z[:, lim], min=0.0)
        return out

    f = project(f)
    y = f
    for m in tapgd._momentum(iterations):
        cols = [sum(torch.bmm(ap, yp[:, :, None])[:, :, 0] for ap in a_pieces)
                for yp in _split3(y)]
        g = (cols[0] + cols[1]) + cols[2]
        z = project(y - step * (g + b_s))
        y = z + m * (z - f)
        f = z
    out = torch.zeros(B, 3 * nc + nl)
    out[:, rows[used]] = f[:, used]
    return out


def _problem(seed, B, nc, nl):
    rng = np.random.RandomState(seed)
    ne = nc * 3 + nl
    m = rng.randn(B, ne, ne)
    a = np.einsum("bij,bkj->bik", m, m) / ne + 0.5 * np.eye(ne)
    b = rng.randn(B, ne)
    mu = rng.uniform(0.5, 1.5, (B, nc))
    f0 = 0.1 * rng.randn(B, ne)
    return tuple(np.asarray(x, np.float32) for x in (a, b, mu, f0))


def _torch_in(a, b, mu, f0, bf16):
    ta = torch.as_tensor(a)
    return ((ta.to(torch.bfloat16) if bf16 else ta), torch.as_tensor(b),
            torch.as_tensor(mu), torch.as_tensor(f0))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("nc,nl", [(8, 8), (10, 2), (0, 5)])
def test_emulated_kernel_matches_jax_scan(nc, nl, bf16):
    B = 6
    a, b, mu, f0 = _problem(20 + nc + bf16, B, nc, nl)
    ja = jnp.asarray(a).astype(jnp.bfloat16) if bf16 else jnp.asarray(a)
    ref = np.asarray(jax.vmap(lambda a_, b_, m_, f_: japgd._apgd_scan(
        a_, b_, m_, f_, iterations=ITERS, nc=nc, nl=nl))(ja, b, mu, f0))
    out = _emulated_solve(*_torch_in(a, b, mu, f0, bf16), nc, nl, ITERS)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_emulated_kernel_matches_pallas_interpret(bf16):
    """Against ``apgd_solve(..., interpret=True)`` at the main path's
    nc = nl = 8 (grouped layout on the JAX side, interleaved here)."""
    nc, nl, B = 8, 8, 4
    a, b, mu, f0 = _problem(30 + bf16, B, nc, nl)
    perm, inv = japgd._group_perm(nc, nl)
    ja = jnp.asarray(a[:, perm][:, :, perm])
    ja = ja.astype(jnp.bfloat16) if bf16 else ja
    ref = np.asarray(japgd.apgd_solve(
        ja, b[:, perm], mu, f0[:, perm], iterations=ITERS, nc=nc, nl=nl,
        block=4, interpret=True))[:, inv]
    out = _emulated_solve(*_torch_in(a, b, mu, f0, bf16), nc, nl, ITERS)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


def test_momentum_table_is_the_reference_recurrence():
    """The host's table equals the (t−1)/t' of the reference's loop."""
    t = 1.0
    for m in tapgd._momentum(60):
        t_new = 0.5 * (1.0 + np.sqrt(1.0 + 4.0 * t * t))
        assert abs(m - (t - 1.0) / t_new) < 1e-6
        t = t_new
