"""The arithmetic of the port's wide APGD kernel (``deepmimic_mujoco_torch/
ops/csrc/apgd_wide.cu``, 33 <= ne <= 192), emulated in PyTorch on the CPU
and held against the JAX reference's ``_apgd_scan``
(``deepmimic_mujoco_tpu/ops/apgd.py``: the XLA route ``make_apgd`` takes
for these systems).

The kernel cannot run here, so these tests check its design's numbers and
maps before the code reaches the card:

* the maps of the tiles: A's mma fragments (row tile, column tile, lane,
  register) cover the padded system once; the accumulator rows that lanes
  4g and 4g+1 store cover every row once; the y buffer's positions put the
  rows a lane's B fragment needs side by side;
* the launch plan of every shape (``tests/torch_wide_plan.py``, a mirror
  of ``plan`` in the source that ``tests/test_torch_cuda.py`` holds against
  the compiled one): the team's
  warps cover the row tiles, its threads own every row (thread i rows
  3i..3i+2: contact i's triple or up to three limits), and the block fits
  the SM;
* the whole solve as the kernel computes it — padding to 16-row tiles, A
  in bf16 (or f32 split into three bf16 pieces), y split into three bf16
  pieces, each product summed in f32 per piece of A and column, the pieces
  of A added in order, then columns hi + mid and lo (at 4 tiles, f32 A
  takes an f32 FMA matvec instead: 16 columns a thread, then the 4 column
  groups); the host's momentum
  table; 1/(1+μ²) once per contact; t = x·rsqrt(x) — within atol 1e-4 of
  JAX's ``_apgd_scan`` at 60 iterations, the tolerance of
  ``tests/test_torch_apgd.py``, at the shapes of the capped (ne 64) and
  uncapped (ne 139) humanoid, the tile edges and the maximum, with no
  contacts and with no limits, and on systems whose projection takes each
  branch of the cone.

Inputs are made with numpy from a seed and handed to both stacks."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepmimic_mujoco_tpu.ops import apgd as japgd
from deepmimic_mujoco_torch.ops import apgd as tapgd
from tests.torch_wide_plan import MAX_SMEM, MAX_TILES, MIN_TILES, plan

torch.set_num_threads(1)

ATOL = 1e-4
ITERS = 60
def _wide_shapes():
    for ne in range(1, 193):
        for nc in sorted({0, ne // 3, ne // 6}):
            yield ne, nc


def test_plan_covers_every_shape():
    for ne, nc in _wide_shapes():
        for bf16 in (True, False):
            pl = plan(ne, nc, bf16, 4096)
            r, kt, warps = pl["row_tiles"], pl["kt"], pl["warps"]
            assert MIN_TILES <= kt <= MAX_TILES and 16 * kt >= ne
            # every row tile on a warp, and no warp without one
            assert warps * r >= kt > (warps - 1) * r
            # thread i of the team owns rows 3i..3i+2 (a contact or limits)
            assert 32 * warps >= -(-ne // 3)
            assert pl["envs"] <= 15  # named barriers 1..envs
            # 12 warps per SM: 168 registers a thread, A's fragments <= 108
            assert pl["threads"] <= 384 and pl["a_registers"] <= 108
            assert pl["smem"] <= MAX_SMEM
    # the timed shapes: B = 4096 at ne 64 and 139, both types of A
    keys = ("kt", "warps", "envs", "threads")
    assert [tuple(plan(ne, nc, bf16, 4096)[k] for k in keys)
            for ne, nc, bf16 in ((64, 16, True), (139, 37, True),
                                 (64, 16, False), (139, 37, False))] == [
        (4, 1, 4, 128), (9, 3, 1, 96), (4, 2, 2, 128), (9, 9, 1, 288)]


@pytest.mark.parametrize("kt", range(1, 13))
def test_fragment_accumulator_and_y_maps(kt):
    n = 16 * kt
    seen = np.zeros((n, n), np.int64)
    for m in range(kt):
        for k in range(kt):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for q in range(4):
                    for h in range(2):
                        row = 16 * m + g + 8 * (q & 1)
                        col = 16 * k + 2 * t + 8 * (q >> 1) + h
                        seen[row, col] += 1
    assert (seen == 1).all()
    # lane 4g stores row 16m + g, lane 4g+1 row 16m + g + 8
    rows = sorted(16 * m + g + 8 * t for m in range(kt) for g in range(8)
                  for t in range(2))
    assert rows == list(range(n))

    def pos(r):  # y_pos of the source: row r in a piece row
        w = r & 15
        return (r >> 4) * 16 + ((w & 7) >> 1) * 4 + (w >> 3) * 2 + (w & 1)

    where = {pos(r): r for r in range(n)}
    assert sorted(where) == list(range(n))
    for k in range(kt):
        for t in range(4):
            # the 8-byte load of lane t: b0 = rows 2t, 2t+1; b1 = 2t+8, 2t+9
            got = [where[16 * k + 4 * t + j] for j in range(4)]
            assert got == [16 * k + 2 * t + d for d in (0, 1, 8, 9)]


def _bf16(x):
    """Round to nearest bf16 (``cvt.rn.bf16x2.f32``, ``__float2bfloat16_rn``),
    back in f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _split3(x):
    """``split3`` / ``put_y`` of the source: three bf16 pieces, residuals in
    f32."""
    pieces = []
    for _ in range(3):
        pieces.append(_bf16(x))
        x = x - pieces[-1]
    return pieces


def _project(z, mu, inv, nc):
    """The owner threads' projection, interleaved rows: ``cone`` of the
    source for each contact triple, a clamp for each limit."""
    out = z.clone()
    fn, f1, f2 = z[:, 0:3 * nc:3], z[:, 1:3 * nc:3], z[:, 2:3 * nc:3]
    x = f1 * f1 + f2 * f2 + 1e-20
    t = x * torch.rsqrt(x)
    inside = t <= mu * fn
    below = mu * t <= -fn
    fn_p = torch.clamp((fn + mu * t) * inv, min=0.0)
    scale = torch.where(t > 1e-12, mu * fn_p * (1.0 / t), torch.zeros_like(t))
    zero = torch.zeros_like(fn)
    out[:, 0:3 * nc:3] = torch.where(
        below, zero, torch.where(inside, torch.clamp(fn, min=0.0), fn_p))
    out[:, 1:3 * nc:3] = torch.where(below, zero,
                                     torch.where(inside, f1, f1 * scale))
    out[:, 2:3 * nc:3] = torch.where(below, zero,
                                     torch.where(inside, f2, f2 * scale))
    out[:, 3 * nc:] = torch.clamp(z[:, 3 * nc:], min=0.0)
    return out


def emulated_wide_solve(a, b, mu, f0, nc, nl, iterations):
    """The wide kernel's arithmetic on interleaved inputs: a (B, ne, ne) f32
    or bf16, b, f0 (B, ne), mu (B, nc) → f (B, ne) f32."""
    B, ne = b.shape
    n = 16 * max(3, (ne + 15) // 16)  # padded to whole tiles of zeros
    a_t = torch.zeros(B, n, n)
    a_t[:, :ne, :ne] = a.float()
    # f32 A at 4 tiles: an f32 FMA matvec on f32 y, 16 columns a thread
    fma = plan(ne, nc, a.dtype == torch.bfloat16, B)["fma"]
    a_pieces = [a_t] if a.dtype == torch.bfloat16 else _split3(a_t)
    lip = a_t.abs().sum(-1).amax(-1)
    step = (1.0 / torch.clamp(lip, min=1e-8))[:, None]
    inv = 1.0 / (1.0 + mu * mu)
    f = _project(f0.clone(), mu, inv, nc)
    y = f
    for m in tapgd._momentum(iterations):
        y_t = torch.zeros(B, n)
        y_t[:, :ne] = y
        if fma:
            # per thread 16 columns in order, then the 4 column groups
            part = [torch.bmm(a_t[:, :, 16 * c:16 * c + 16],
                              y_t[:, 16 * c:16 * c + 16, None])[:, :, 0]
                    for c in range(4)]
            g = ((part[0] + part[2]) + (part[1] + part[3]))[:, :ne]
        else:
            cols = []
            for yp in _split3(y_t):  # B columns 0-2: hi, mid, lo
                col = None
                for ap in a_pieces:  # the pieces of A, added in order
                    prod = torch.bmm(ap, yp[:, :, None])[:, :, 0]
                    col = prod if col is None else col + prod
                cols.append(col)
            g = ((cols[0] + cols[1]) + cols[2])[:, :ne]
        z = _project(y - step * (g + b), mu, inv, nc)
        y = z + m * (z - f)
        f = z
    return f


def _problem(seed, B, nc, nl):
    rng = np.random.RandomState(seed)
    ne = nc * 3 + nl
    m = rng.randn(B, ne, ne)
    a = np.einsum("bij,bkj->bik", m, m) / ne + 0.5 * np.eye(ne)
    b = rng.randn(B, ne)
    mu = rng.uniform(0.5, 1.5, (B, nc))
    f0 = 0.1 * rng.randn(B, ne)
    return tuple(np.asarray(x, np.float32) for x in (a, b, mu, f0))


def branch_problem(seed, B, nc, nl):
    """Systems whose projection takes every branch of the cone: warm starts
    inside the cone, below it (the dual cone), on its surface, above it,
    and contacts with zero friction; A and b as in ``_problem``."""
    a, b, mu, f0 = _problem(seed, B, nc, nl)
    rng = np.random.RandomState(seed + 1)
    c = np.arange(nc)
    kind = (c[None, :] + np.arange(B)[:, None]) % 5
    fn = rng.uniform(0.5, 2.0, (B, nc))
    ang = rng.uniform(0, 2 * np.pi, (B, nc))
    mu = np.where(kind == 4, 0.0, mu)
    # tangential size over mu*fn: inside 0.5, on the surface 1, above 3
    ratio = np.choose(kind, [0.5, 1.0, 3.0, 0.5, 2.0])
    fn = np.where(kind == 3, -fn, fn)  # below: normal < 0, small tangent
    t = ratio * np.maximum(mu, 0.5) * np.abs(fn)
    f0 = f0.copy()
    f0[:, 0:3 * nc:3] = fn
    f0[:, 1:3 * nc:3] = t * np.cos(ang)
    f0[:, 2:3 * nc:3] = t * np.sin(ang)
    f0[:, 3 * nc:] = rng.randn(B, nl)
    return tuple(np.asarray(x, np.float32) for x in (a, b, mu, f0))


def _jax_scan(a, b, mu, f0, nc, nl, iterations, bf16):
    ja = jnp.asarray(a).astype(jnp.bfloat16) if bf16 else jnp.asarray(a)
    return np.asarray(jax.vmap(lambda a_, b_, m_, f_: japgd._apgd_scan(
        a_, b_, m_, f_, iterations=iterations, nc=nc, nl=nl))(ja, b, mu, f0))


def _torch_in(a, b, mu, f0, bf16):
    ta = torch.as_tensor(a)
    return ((ta.to(torch.bfloat16) if bf16 else ta), torch.as_tensor(b),
            torch.as_tensor(mu), torch.as_tensor(f0))


SHAPES = [(11, 0), (16, 16), (37, 28), (40, 24), (50, 42), (0, 40),
          (64, 0)]
SHAPE_IDS = ["ne33-nl0", "ne64-caps16", "ne139-uncapped", "ne144",
             "ne192", "ne40-nc0", "ne192-nl0"]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("nc,nl", SHAPES, ids=SHAPE_IDS)
def test_emulated_wide_kernel_matches_jax_scan(nc, nl, bf16, monkeypatch):
    # a rolled scan: the same iterates, a shorter compile
    monkeypatch.setenv("DMTPU_UNROLL_SOLVER", "1")
    B = 4
    a, b, mu, f0 = _problem(40 + nc + nl + bf16, B, nc, nl)
    ref = _jax_scan(a, b, mu, f0, nc, nl, ITERS, bf16)
    out = emulated_wide_solve(*_torch_in(a, b, mu, f0, bf16), nc, nl, ITERS)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_emulated_projection_branches_match_jax(bf16, monkeypatch):
    """Warm starts in every branch of the cone (and μ = 0), at 0 iterations
    (the projection alone) and at 8 and 60."""
    monkeypatch.setenv("DMTPU_UNROLL_SOLVER", "1")
    nc, nl, B = 20, 10, 5
    a, b, mu, f0 = branch_problem(7, B, nc, nl)
    for iters in (0, 8, ITERS):
        ref = _jax_scan(a, b, mu, f0, nc, nl, iters, bf16)
        out = emulated_wide_solve(*_torch_in(a, b, mu, f0, bf16), nc, nl,
                                  iters)
        np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)
    # the starts reach each branch: inside, on, above, below, zero mu
    fn, ft = f0[:, 0:3 * nc:3], np.hypot(f0[:, 1:3 * nc:3], f0[:, 2:3 * nc:3])
    assert (ft < mu * fn).any() and (mu * ft <= -fn).any()
    assert (ft > mu * fn).any() and (mu == 0).any()
    assert np.isclose(ft, mu * fn, rtol=1e-6).any()
