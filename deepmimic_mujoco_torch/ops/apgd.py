"""Batched APGD friction-cone solve: the hand-written CUDA kernel
(``csrc/apgd.cu``), its two entry points and their plain PyTorch version
(port of ``deepmimic_mujoco_tpu/ops/apgd.py``).

Per env the solve takes a dual matrix A (ne×ne, f32 or bf16 storage), b
(ne), friction μ (nc) and a warm start f0 (ne) and runs Nesterov-accelerated
projected gradient steps of size 1/L, L = maxᵢ Σⱼ|Aᵢⱼ| accumulated in f32.
Contact triples project onto the elliptic friction cone, limit rows clamp
to ≥ 0.

* :func:`apgd_solve` and :func:`apgd_solve_lanes` take the GROUPED row
  layout ``[fn(nc) | ft1(nc) | ft2(nc) | lim(nl)]``, batch-major
  ((B, ne, ne)) and env-axis-last ((ne, ne, B)) respectively — the
  contracts of the two Pallas kernels they replace.  On a CUDA tensor they
  launch the kernel (and count the launch in ``.launches``); on a CPU tensor
  they compute the plain version; on anything else they raise.
* :func:`apgd` is the solver's dispatch (it replaces ``make_apgd``'s
  ``custom_vmap`` rule): batch-first INTERLEAVED ``[n, t1, t2]`` triples in
  and out, permuted to the grouped layout around the entry point that
  ``layout`` names.
* :func:`_apgd_scan` is the plain version in the interleaved layout — the
  CPU tests' and ``chip_smoke.py``'s oracle.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from deepmimic_mujoco_torch.ops import _build

MAX_NE = 32  # one warp per env: lane i owns row i of A


def _group_perm(nc: int, nl: int) -> tuple[np.ndarray, np.ndarray]:
    """Permutation grouped→interleaved: ``x_grouped = x_interleaved[perm]``;
    ``inv`` undoes it."""
    perm = np.concatenate([
        np.arange(nc) * 3,          # normals
        np.arange(nc) * 3 + 1,      # tangent 1
        np.arange(nc) * 3 + 2,      # tangent 2
        3 * nc + np.arange(nl),     # limits
    ]).astype(np.int64)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return perm, inv


@functools.lru_cache(maxsize=None)
def _perm_tensors(nc: int, nl: int, device: torch.device):
    perm, inv = _group_perm(nc, nl)
    return (torch.as_tensor(perm, device=device),
            torch.as_tensor(inv, device=device))


def _project(f: torch.Tensor, mu: torch.Tensor, nc: int, nl: int
             ) -> torch.Tensor:
    """Cone projection in the grouped layout; f (B, ne), mu (B, nc)."""
    fn = f[:, :nc]
    f1 = f[:, nc:2 * nc]
    f2 = f[:, 2 * nc:3 * nc]
    t = torch.sqrt(f1 * f1 + f2 * f2 + 1e-20)
    inside = t <= mu * fn
    below = mu * t <= -fn
    fn_p = torch.clamp((fn + mu * t) / (1.0 + mu * mu), min=0.0)
    scale = torch.where(t > 1e-12, mu * fn_p / torch.clamp(t, min=1e-12),
                        torch.zeros_like(t))
    fn_out = torch.where(inside, torch.clamp(fn, min=0.0), fn_p)
    f1_out = torch.where(inside, f1, f1 * scale)
    f2_out = torch.where(inside, f2, f2 * scale)
    zero = torch.zeros_like(fn)
    fn_out = torch.where(below, zero, fn_out)
    f1_out = torch.where(below, zero, f1_out)
    f2_out = torch.where(below, zero, f2_out)
    fl = torch.clamp(f[:, 3 * nc:], min=0.0)
    return torch.cat([fn_out, f1_out, f2_out, fl], dim=-1)


@functools.lru_cache(maxsize=None)
def _momentum(iterations: int) -> tuple[float, ...]:
    """The data-independent Nesterov coefficients (t−1)/t', in float32."""
    t = np.float32(1.0)
    out = []
    for _ in range(iterations):
        t_new = np.float32(0.5) * (np.float32(1.0) + np.sqrt(
            np.float32(1.0) + np.float32(4.0) * t * t))
        out.append(float((t - np.float32(1.0)) / t_new))
        t = t_new
    return tuple(out)


def _apgd_grouped(a, b, mu, f0, *, iterations: int, nc: int, nl: int):
    """Plain PyTorch solve in the grouped layout, batch-major:
    a (B, ne, ne) f32/bf16, b, f0 (B, ne), mu (B, nc) → f (B, ne) f32."""
    a = a.float()
    # f32 row sums: a bf16 sum could round low and overshoot the 1/L step
    lip = torch.amax(torch.sum(torch.abs(a), dim=-1), dim=-1)
    step = (1.0 / torch.clamp(lip, min=1e-8))[:, None]
    f = _project(f0, mu, nc, nl)
    y = f
    for coef in _momentum(iterations):
        g = torch.bmm(a, y[:, :, None])[:, :, 0] + b
        f_new = _project(y - step * g, mu, nc, nl)
        y = f_new + coef * (f_new - f)
        f = f_new
    return f


def _apgd_scan(a, b, mu, f0, *, iterations: int, nc: int, nl: int):
    """Plain version in the INTERLEAVED layout, batch-first: a (B, ne, ne),
    b, f0 (B, ne), mu (B, nc) → f (B, ne).  The oracle of the kernel."""
    perm, inv = _perm_tensors(nc, nl, a.device)
    f = _apgd_grouped(a[:, perm[:, None], perm[None, :]], b[:, perm], mu,
                      f0[:, perm], iterations=iterations, nc=nc, nl=nl)
    return f[:, inv]


# ---------------------------------------------------------------------------
# the CUDA kernel

_LIB: list = []  # [ctypes.CDLL, _build.Built] once loaded


def load_kernel() -> _build.Built:
    """Build (at first use) and bind ``csrc/apgd.cu``; returns the build
    record (library path, nvcc output, compile seconds)."""
    if not _LIB:
        lib, built = _build.load("apgd")
        fn = lib.apgd_launch
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [ptr, i32, ptr, ptr, ptr, ptr, i64, i32, i32, i32,
                       i64, i64, i64, i64, i64, i64, i64, ptr]
        fn.restype = ctypes.c_int
        _LIB.extend([lib, built])
    return _LIB[1]


def _check(a, b, mu, f0, nc: int, nl: int, iterations: int, lanes: bool):
    """Validate the kernel's inputs; returns (B, ne)."""
    if a.dim() != 3:
        raise ValueError(f"a must be 3-D, got {tuple(a.shape)}")
    B, ne = (a.shape[2], a.shape[0]) if lanes else (a.shape[0], a.shape[1])
    if ne != 3 * nc + nl or nc < 0 or nl < 0:
        raise ValueError(f"ne={ne} != 3*nc + nl = {3 * nc + nl}")
    if ne > MAX_NE or ne < 1:
        raise ValueError(f"the kernel takes 1 <= ne <= {MAX_NE}, got {ne}")
    if iterations < 0:
        raise ValueError(f"iterations must be >= 0, got {iterations}")
    vec = (ne, B) if lanes else (B, ne)
    mshape = (nc, B) if lanes else (B, nc)
    a_shape = (ne, ne, B) if lanes else (B, ne, ne)
    tensors = (("a", a, a_shape), ("b", b, vec), ("mu", mu, mshape),
               ("f0", f0, vec))
    for name, x, shape in tensors:
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
        want = (torch.float32, torch.bfloat16) if name == "a" else (torch.float32,)
        if x.dtype not in want:
            raise TypeError(f"{name}: dtype {x.dtype}, expected one of {want}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, x, _ in tensors:
        if x.device != a.device or x.device.type != "cuda":
            raise ValueError(f"{name} is on {x.device}; the kernel needs "
                             f"all inputs on one CUDA device")
    return B, ne


def _launch(a, b, mu, f0, out, B: int, ne: int, nc: int, iterations: int,
            lanes: bool):
    """Launch on the current stream; inputs are contiguous (``_check``), so
    the element strides follow from the layout."""
    load_kernel()
    if lanes:   # a (ne, ne, B); b, f0, out (ne, B); mu (nc, B)
        strides = (1, ne * B, B, 1, B, 1, B)
    else:       # a (B, ne, ne); b, f0, out (B, ne); mu (B, nc)
        strides = (ne * ne, ne, 1, ne, 1, nc, 1)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _LIB[0].apgd_launch(
        a.data_ptr(), int(a.dtype == torch.bfloat16), b.data_ptr(),
        mu.data_ptr(), f0.data_ptr(), out.data_ptr(), B, ne, nc, iterations,
        *strides, stream)
    if err != 0:
        raise RuntimeError(f"apgd kernel launch failed: cudaError {err}")


def apgd_solve(a, b, mu, f0, *, iterations: int, nc: int, nl: int):
    """Batched APGD in the grouped layout, batch-major: a (B, ne, ne) f32 or
    bf16; b, f0 (B, ne) f32; mu (B, nc) f32 → f (B, ne) f32.  Replaces
    ``deepmimic_mujoco_tpu/ops/apgd.py:apgd_solve`` (``_apgd_kernel``)."""
    if a.device.type == "cpu":
        return _apgd_grouped(a, b, mu, f0, iterations=iterations, nc=nc, nl=nl)
    B, ne = _check(a, b, mu, f0, nc, nl, iterations, lanes=False)
    out = torch.empty((B, ne), dtype=torch.float32, device=a.device)
    _launch(a, b, mu, f0, out, B, ne, nc, iterations, lanes=False)
    apgd_solve.launches += 1
    return out


def apgd_solve_lanes(a, b, mu, f0, *, iterations: int, nc: int, nl: int):
    """Batched APGD in the grouped layout, env axis last: a (ne, ne, B) f32
    or bf16; b, f0 (ne, B) f32; mu (nc, B) f32 → f (ne, B) f32.  Replaces
    ``deepmimic_mujoco_tpu/ops/apgd.py:apgd_solve_lanes``
    (``_apgd_kernel_lanes``)."""
    if a.device.type == "cpu":
        return _apgd_grouped(a.permute(2, 0, 1), b.T, mu.T, f0.T,
                             iterations=iterations, nc=nc, nl=nl).T
    B, ne = _check(a, b, mu, f0, nc, nl, iterations, lanes=True)
    out = torch.empty((ne, B), dtype=torch.float32, device=a.device)
    _launch(a, b, mu, f0, out, B, ne, nc, iterations, lanes=True)
    apgd_solve_lanes.launches += 1
    return out


apgd_solve.launches = 0
apgd_solve_lanes.launches = 0


def apgd(a, b, mu, f0, *, iterations: int, nc: int, nl: int,
         layout: str = "blocks"):
    """The solver's dispatch: interleaved batch-first a (B, ne, ne), b, f0
    (B, ne), mu (B, nc) → f (B, ne).  The entry point of ``layout`` runs the
    kernel for CUDA tensors and the plain version for CPU tensors."""
    perm, inv = _perm_tensors(nc, nl, a.device)
    a_g = a[:, perm[:, None], perm[None, :]]
    b_g = b[:, perm]
    f0_g = f0[:, perm]
    mu = mu.contiguous()
    kw = dict(iterations=iterations, nc=nc, nl=nl)
    if layout == "blocks":
        f = apgd_solve(a_g.contiguous(), b_g.contiguous(), mu,
                       f0_g.contiguous(), **kw)
    elif layout == "lanes":
        f = apgd_solve_lanes(a_g.permute(1, 2, 0).contiguous(),
                             b_g.T.contiguous(), mu.T.contiguous(),
                             f0_g.T.contiguous(), **kw).T
    else:
        raise ValueError(f"unknown apgd layout {layout!r}")
    return f[:, inv]
