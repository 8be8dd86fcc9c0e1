"""A mirror of ``plan`` in ``deepmimic_mujoco_torch/ops/csrc/apgd_wide.cu``:
the wide kernel's launch configuration of a solve, for the CPU tests of its
design (``tests/test_torch_apgd_wide_math.py``) and the card's check that
the compiled plan is this one (``tests/test_torch_cuda.py``)."""

MAX_SMEM = 232448  # bytes a block may use on an H100
MIN_TILES, MAX_TILES = 3, 12  # the source's instantiations: kt = 3..12


def row_tiles(kt, bf16):
    """Row tiles per warp: A's fragments stay at <= 108 registers a lane."""
    if bf16:
        return 4 if kt == 4 else 3 if kt <= 6 or kt == 9 else 2
    return 2 if kt <= 4 else 1


def _round16(n):
    return (n + 15) // 16 * 16


def plan(ne, nc, bf16, batch):
    """The tiles, team and block of a solve of ``batch`` systems of ``ne``
    rows, ``nc`` contacts."""
    es = 2 if bf16 else 4
    kt = max(MIN_TILES, (ne + 15) // 16)
    r = row_tiles(kt, bf16)
    warps = (kt + r - 1) // r
    envs = 1 if warps >= 3 else 4 // warps
    threads = 32 * warps * envs
    raw = _round16(envs * ne * ne * es) + 32
    stage_a = raw + 16 * (raw // 128 + 1)
    stage_v = _round16(envs * ne * 4) + 32
    stage_mu = _round16(envs * nc * 4) + 32
    smem = stage_a + 2 * stage_v + stage_mu + 4 * (
        envs * (8 * 8 * (kt | 1) + 16 * kt) + threads // 32)
    late = not bf16 and kt >= 10  # A kept as f32, split per iteration
    fma = not bf16 and kt == 4    # f32 FMA matvec: a 4 x 16 block a thread
    per_tile = 4 if bf16 else 8 if late else 12  # registers of A a lane
    return dict(kt=kt, row_tiles=r, warps=warps, envs=envs, threads=threads,
                smem=smem, groups=-(-batch // envs), fma=fma,
                a_registers=64 if fma else per_tile * r * kt)
