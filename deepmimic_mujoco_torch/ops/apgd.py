"""Batched APGD friction-cone solve: the hand-written CUDA kernels
(``csrc/apgd.cu`` for ne <= 32, ``csrc/apgd_wide.cu`` above), their entry
points and their plain PyTorch version (port of
``deepmimic_mujoco_tpu/ops/apgd.py``).

Per env the solve takes a dual matrix A (ne×ne, f32 or bf16 storage), b
(ne), friction μ (nc) and a warm start f0 (ne) and runs Nesterov-accelerated
projected gradient steps of size 1/L, L = maxᵢ Σⱼ|Aᵢⱼ| accumulated in f32.
Contact triples project onto the elliptic friction cone, limit rows clamp
to ≥ 0.

* :func:`apgd_solve` and :func:`apgd_solve_lanes` are the kernel's entry
  points, batch-major ((B, ne, ne)) and env-axis-last ((ne, ne, B)).  By
  default they take the GROUPED row layout ``[fn(nc) | ft1(nc) | ft2(nc) |
  lim(nl)]`` — the contracts of the two Pallas kernels they replace; with
  ``rows="interleaved"`` they take the solver's ``[n, t1, t2]`` triples, and
  the kernel applies the row order itself.  On a CUDA tensor they launch
  the kernel (and count the launch in ``.launches``); on a CPU tensor they
  compute the plain version; on anything else they raise.
* :func:`apgd_solve_wide` is the entry point of the kernel for larger
  dual systems, 1 <= ne <= ``MAX_NE_WIDE`` (the uncapped humanoid has
  ne = 139), batch-major and interleaved.  It replaces the XLA
  ``_apgd_scan`` route that ``make_apgd`` takes for every ne; no Pallas
  kernel computes it.
* :func:`apgd` is the solver's dispatch (it replaces ``make_apgd``'s
  ``custom_vmap`` rule): batch-first interleaved tensors in and out.  The
  shape chooses the kernel: ne <= 32 goes to the entry point that
  ``layout`` names — as the tensors are for ``blocks`` (one launch per
  solve), transposed for ``lanes`` — and ne > 32 to
  :func:`apgd_solve_wide` whatever the layout.
* :func:`_apgd_scan` is the plain version in the interleaved layout — the
  CPU tests' and ``chip_smoke.py``'s oracle.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from deepmimic_mujoco_torch.ops import _build

MAX_NE = 32  # the rows map to the 32 slots of two 16-row mma tiles
MAX_NE_WIDE = 192  # apgd_wide.cu: 12 tiles of 16 rows


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

_LIBS: dict = {}  # source name -> (ctypes.CDLL, _build.Built) once loaded
ROWS = ("grouped", "interleaved")


def _bind(name: str, lib: ctypes.CDLL) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if name == "apgd":
        lib.apgd_launch.argtypes = [ptr, i32, ptr, ptr, ptr, ptr, ptr, i64,
                                    i32, i32, i32, i32, i32, i64, i64, i64,
                                    i64, ptr]
        lib.apgd_launch.restype = ctypes.c_int
        lib.apgd_plan.argtypes = [ptr, i32, i64, i32, i32, i32, ptr]
        lib.apgd_plan.restype = None
    else:
        lib.apgd_wide_launch.argtypes = [ptr, i32, ptr, ptr, ptr, ptr, ptr,
                                         i64, i32, i32, i32, ptr]
        lib.apgd_wide_launch.restype = ctypes.c_int
        lib.apgd_wide_plan.argtypes = [i32, i32, i32, i64, ptr]
        lib.apgd_wide_plan.restype = ctypes.c_int
        lib.apgd_wide_max_ne.argtypes = []
        lib.apgd_wide_max_ne.restype = ctypes.c_int
        if lib.apgd_wide_max_ne() != MAX_NE_WIDE:
            raise RuntimeError(f"apgd_wide.cu takes ne <= "
                               f"{lib.apgd_wide_max_ne()}, MAX_NE_WIDE is "
                               f"{MAX_NE_WIDE}")


def load_kernels(names=("apgd", "apgd_wide")) -> dict:
    """Build (at first use; the sources not built yet compile in parallel)
    and bind ``csrc/<name>.cu`` for each name; returns name -> build record
    (library path, nvcc output, compile seconds)."""
    todo = [n for n in names if n not in _LIBS]
    if todo:
        for name, built in _build.build_many(todo).items():
            lib = ctypes.CDLL(built.path)
            _bind(name, lib)
            _LIBS[name] = (lib, built)
    return {n: _LIBS[n][1] for n in names}


def _lib(name: str) -> ctypes.CDLL:
    if name not in _LIBS:
        load_kernels((name,))
    return _LIBS[name][0]


def launch_plan(a, nc: int, lanes: bool) -> dict:
    """The kernel's launch configuration for ``a`` (a CUDA tensor in the
    layout of ``lanes``): envs and threads per block, dynamic shared memory
    bytes, whether the 8-slot map applies and whether A is copied with
    vector loads."""
    B, ne = (a.shape[2], a.shape[0]) if lanes else (a.shape[0], a.shape[1])
    out = (ctypes.c_int * 5)()
    _lib("apgd").apgd_plan(a.data_ptr(), int(a.dtype == torch.bfloat16), B,
                           ne, nc, int(lanes), out)
    return dict(zip(("envs", "threads", "smem", "slots8", "vec"), out))


_TABLES: dict = {}  # (iterations, device index) -> momentum table


def _momentum_table(iterations: int, a) -> torch.Tensor:
    """:func:`_momentum` on ``a``'s card, made once: the kernel reads
    coefficient k in iteration k."""
    key = (iterations, a.get_device())
    table = _TABLES.get(key)
    if table is None:
        table = _TABLES[key] = torch.tensor(
            _momentum(iterations) or (0.0,), dtype=torch.float32,
            device=a.device)
    return table


def _check(a, b, mu, f0, nc: int, nl: int, iterations: int, lanes: bool,
           rows: str = "grouped", max_ne: int = MAX_NE,
           kernel: str = "the kernel"):
    """Validate a kernel's inputs; returns (B, ne)."""
    if a.dim() != 3:
        raise ValueError(f"a must be 3-D, got {tuple(a.shape)}")
    if rows not in ROWS:
        raise ValueError(f"rows must be one of {ROWS}, got {rows!r}")
    B, ne = (a.shape[2], a.shape[0]) if lanes else (a.shape[0], a.shape[1])
    if ne != 3 * nc + nl or nc < 0 or nl < 0:
        raise ValueError(f"ne={ne} != 3*nc + nl = {3 * nc + nl}")
    if ne > max_ne or ne < 1:
        raise ValueError(f"{kernel} takes 1 <= ne <= {max_ne}, got {ne}")
    if iterations < 0:
        raise ValueError(f"iterations must be >= 0, got {iterations}")
    vec = (ne, B) if lanes else (B, ne)
    mshape = (nc, B) if lanes else (B, nc)
    a_shape = (ne, ne, B) if lanes else (B, ne, ne)
    tensors = (("a", a, a_shape), ("b", b, vec), ("mu", mu, mshape),
               ("f0", f0, vec))
    for name, x, shape in tensors:
        if x.shape != shape:
            raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
        if x.dtype is not torch.float32 and (
                name != "a" or x.dtype is not torch.bfloat16):
            want = (torch.float32, torch.bfloat16) if name == "a" else (
                torch.float32,)
            raise TypeError(f"{name}: dtype {x.dtype}, expected one of {want}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    # the cheap form of "all on one CUDA device" (this runs every call)
    if not (a.is_cuda and b.is_cuda and mu.is_cuda and f0.is_cuda
            and a.get_device() == b.get_device() == mu.get_device()
            == f0.get_device()):
        on = ", ".join(f"{n} on {x.device}" for n, x, _ in tensors)
        raise ValueError(f"{on}; the kernel needs all inputs on one CUDA "
                         "device")
    return B, ne


def _solve(a, b, mu, f0, iterations: int, nc: int, nl: int, lanes: bool,
           rows: str):
    """Check, allocate the output and launch on the current stream: one
    kernel launch and nothing else (the momentum table is made once per
    iteration count and device)."""
    B, ne = _check(a, b, mu, f0, nc, nl, iterations, lanes, rows)
    out = torch.empty((ne, B) if lanes else (B, ne), dtype=torch.float32,
                      device=a.device)
    # element strides of b, f0, out and of mu; inputs are contiguous
    strides = (1, B, 1, B) if lanes else (ne, 1, nc, 1)
    err = _lib("apgd").apgd_launch(
        a.data_ptr(), a.dtype is torch.bfloat16, b.data_ptr(),
        mu.data_ptr(), f0.data_ptr(), out.data_ptr(),
        _momentum_table(iterations, a).data_ptr(), B, ne, nc, iterations,
        lanes, rows == "interleaved", *strides,
        torch._C._cuda_getCurrentRawStream(a.get_device()))
    if err != 0:
        raise RuntimeError(f"apgd kernel launch failed: cudaError {err}")
    return out


def _plain(rows: str):
    """The plain version of the row order ``rows`` (the CPU path)."""
    if rows not in ROWS:
        raise ValueError(f"rows must be one of {ROWS}, got {rows!r}")
    return _apgd_scan if rows == "interleaved" else _apgd_grouped


def apgd_solve(a, b, mu, f0, *, iterations: int, nc: int, nl: int,
               rows: str = "grouped"):
    """Batched APGD, batch-major: a (B, ne, ne) f32 or bf16; b, f0 (B, ne)
    f32; mu (B, nc) f32 → f (B, ne) f32, rows in the grouped layout (the
    contract of ``deepmimic_mujoco_tpu/ops/apgd.py:apgd_solve``, whose
    ``_apgd_kernel`` this replaces) or, with ``rows="interleaved"``, in the
    solver's."""
    if a.is_cpu:
        return _plain(rows)(a, b, mu, f0, iterations=iterations, nc=nc, nl=nl)
    out = _solve(a, b, mu, f0, iterations, nc, nl, False, rows)
    apgd_solve.launches += 1
    return out


def apgd_solve_lanes(a, b, mu, f0, *, iterations: int, nc: int, nl: int,
                     rows: str = "grouped"):
    """Batched APGD, env axis last: a (ne, ne, B) f32 or bf16; b, f0 (ne, B)
    f32; mu (nc, B) f32 → f (ne, B) f32, rows grouped (the contract of
    ``deepmimic_mujoco_tpu/ops/apgd.py:apgd_solve_lanes``, whose
    ``_apgd_kernel_lanes`` this replaces) or interleaved."""
    if a.is_cpu:
        return _plain(rows)(a.permute(2, 0, 1), b.T, mu.T, f0.T,
                            iterations=iterations, nc=nc, nl=nl).T
    out = _solve(a, b, mu, f0, iterations, nc, nl, True, rows)
    apgd_solve_lanes.launches += 1
    return out


def apgd_solve_wide(a, b, mu, f0, *, iterations: int, nc: int, nl: int):
    """Batched APGD for dual systems of up to ``MAX_NE_WIDE`` rows,
    batch-major and interleaved: a (B, ne, ne) f32 or bf16; b, f0 (B, ne)
    f32; mu (B, nc) f32 → f (B, ne) f32.  The kernel (``csrc/
    apgd_wide.cu``) computes what ``_apgd_scan`` computes; the dispatch
    sends it the systems above ``MAX_NE``."""
    if a.is_cpu:
        return _apgd_scan(a, b, mu, f0, iterations=iterations, nc=nc, nl=nl)
    B, ne = _check(a, b, mu, f0, nc, nl, iterations, False, "interleaved",
                   MAX_NE_WIDE, "the wide kernel (MAX_NE_WIDE)")
    out = torch.empty((B, ne), dtype=torch.float32, device=a.device)
    err = _lib("apgd_wide").apgd_wide_launch(
        a.data_ptr(), a.dtype is torch.bfloat16, b.data_ptr(), mu.data_ptr(),
        f0.data_ptr(), out.data_ptr(),
        _momentum_table(iterations, a).data_ptr(), B, ne, nc, iterations,
        torch._C._cuda_getCurrentRawStream(a.get_device()))
    if err != 0:
        raise RuntimeError(f"apgd_wide kernel launch failed: cudaError {err}")
    apgd_solve_wide.launches += 1
    return out


WIDE_PLAN_KEYS = ("tiles", "row_tiles_per_warp", "warps_per_env",
                  "envs_per_block", "threads", "smem", "blocks_per_sm",
                  "grid")


def wide_launch_plan(ne: int, nc: int, bf16: bool, batch: int) -> dict:
    """The wide kernel's launch configuration for a solve of ``batch``
    systems of ``ne`` rows: its instantiation (16-row tiles), row tiles per
    warp, warps per env, envs and threads per block, dynamic shared memory
    bytes, blocks resident per SM and the persistent grid."""
    out = (ctypes.c_longlong * len(WIDE_PLAN_KEYS))()
    err = _lib("apgd_wide").apgd_wide_plan(ne, nc, int(bf16), batch, out)
    if err != 0:
        raise RuntimeError(f"apgd_wide occupancy query failed: cudaError "
                           f"{err}")
    return dict(zip(WIDE_PLAN_KEYS, out))


apgd_solve.launches = 0
apgd_solve_lanes.launches = 0
apgd_solve_wide.launches = 0


def apgd(a, b, mu, f0, *, iterations: int, nc: int, nl: int,
         layout: str = "blocks"):
    """The solver's dispatch: interleaved batch-first a (B, ne, ne), b, f0
    (B, ne), mu (B, nc) → f (B, ne).  For ne <= ``MAX_NE``, ``blocks``
    hands the tensors to :func:`apgd_solve` as they are (one kernel launch
    on contiguous inputs) and ``lanes`` transposes them for
    :func:`apgd_solve_lanes`; larger systems go to :func:`apgd_solve_wide`
    in either layout.  CPU tensors take the plain version."""
    if layout not in ("blocks", "lanes"):
        raise ValueError(f"unknown apgd layout {layout!r}")
    if a.shape[-1] > MAX_NE:
        return apgd_solve_wide(a.contiguous(), b.contiguous(),
                               mu.contiguous(), f0.contiguous(),
                               iterations=iterations, nc=nc, nl=nl)
    kw = dict(iterations=iterations, nc=nc, nl=nl, rows="interleaved")
    if layout == "blocks":
        return apgd_solve(a.contiguous(), b.contiguous(), mu.contiguous(),
                          f0.contiguous(), **kw)
    return apgd_solve_lanes(a.permute(1, 2, 0).contiguous(),
                            b.T.contiguous(), mu.T.contiguous(),
                            f0.T.contiguous(), **kw).T
