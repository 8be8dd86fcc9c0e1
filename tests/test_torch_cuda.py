"""Tests of the port that need the card: the APGD kernel against its plain
PyTorch version, and the main path on CUDA against the CPU.

Imports no JAX (the card's machine has none), so it runs there without the
repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Without a card every test skips, decided inside the ``cuda`` fixture."""

import os

import pytest
import torch

from deepmimic_mujoco_torch.algos import runner
from deepmimic_mujoco_torch.envs.dp_env_v3 import DPEnvV3
from deepmimic_mujoco_torch.io_utils import checkpoint
from deepmimic_mujoco_torch.models.policy import MlpPolicy
from deepmimic_mujoco_torch.ops import apgd as ops
from deepmimic_mujoco_torch.ops import timing
from deepmimic_mujoco_torch.physics.humanoid import build_humanoid

pytestmark = pytest.mark.cuda

CKPT = os.path.join(os.path.dirname(__file__), "..", "train_ckpt", "DPEnvV3",
                    "trpo-walk-0", "trpo_state.npz")
ATOL = 1e-4  # TestAPGD's tolerance: the sums run in another order


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _problem(B, nc, nl, a_dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ne = 3 * nc + nl
    m = torch.randn((B, ne, ne), generator=gen, device="cuda")
    a = (m @ m.transpose(1, 2)) / ne + 0.5 * torch.eye(ne, device="cuda")
    b = torch.randn((B, ne), generator=gen, device="cuda")
    mu = 0.5 + torch.rand((B, nc), generator=gen, device="cuda")
    f0 = 0.1 * torch.randn((B, ne), generator=gen, device="cuda")
    return a.to(a_dtype).contiguous(), b, mu, f0


def _lanes(x):
    return x.permute(*range(1, x.dim()), 0).contiguous()


def test_dispatch_matches_plain_oracle(cuda):
    a, b, mu, f0 = _problem(300, 8, 8, torch.bfloat16, seed=1)
    ref = ops._apgd_scan(a, b, mu, f0, iterations=15, nc=8, nl=8)
    for layout in ("blocks", "lanes"):
        out = ops.apgd(a, b, mu, f0, iterations=15, nc=8, nl=8, layout=layout)
        torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("a_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,nc,nl", [
    (37, 3, 2),     # a batch that is no multiple of any block
    (4096, 8, 8),   # the main path's shape
    (37, 10, 2),    # nc > 8: the general slot map, projection in shared memory
    (64, 2, 20),    # nl > 8: the same
    (37, 0, 5),     # limits only
    (4097, 8, 0),   # contacts only; rows of A not 16-byte aligned (lanes)
], ids=["small", "full", "nc10-nl2", "nc2-nl20", "nc0-nl5", "nc8-nl0-B4097"])
@pytest.mark.parametrize("rows", ["grouped", "interleaved"])
def test_kernels_match_plain(cuda, B, nc, nl, a_dtype, rows):
    a, b, mu, f0 = _problem(B, nc, nl, a_dtype, seed=B)
    plain = ops._apgd_scan if rows == "interleaved" else ops._apgd_grouped
    for iters in (8, 15, 60):
        kw = dict(iterations=iters, nc=nc, nl=nl)
        ref = plain(a, b, mu, f0, **kw)
        out = ops.apgd_solve(a, b, mu, f0, rows=rows, **kw)
        out_l = ops.apgd_solve_lanes(_lanes(a), _lanes(b), _lanes(mu),
                                     _lanes(f0), rows=rows, **kw).T
        torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)
        torch.testing.assert_close(out_l, ref, atol=ATOL, rtol=0)


def test_dispatch_launches_one_kernel_per_solve(cuda):
    """``apgd(..., layout="blocks")`` on the solver's tensors is the kernel
    launch and nothing else: no gather of A, no copy, no scatter of f.  The
    wrapper's count is exact; a profiler window may miss a kernel's record,
    so the device side is read from the best of three windows."""
    a, b, mu, f0 = _problem(512, 8, 8, torch.bfloat16, seed=4)

    def step():
        for iters in (15, 8, 8, 8):
            ops.apgd(a, b, mu, f0, iterations=iters, nc=8, nl=8)

    step()  # build, momentum tables
    seen = []
    for _ in range(3):
        n0 = ops.apgd_solve.launches
        names = timing.device_kernels(step)
        assert ops.apgd_solve.launches - n0 == 4
        assert all("apgd_kernel" in n for n in names), names
        seen.append(len(names))
    assert max(seen) == 4, seen


def test_wrappers_count_launches_and_refuse_what_the_kernel_cannot_take(cuda):
    a, b, mu, f0 = _problem(16, 8, 8, torch.float32, seed=2)
    n0 = ops.apgd_solve.launches
    ops.apgd_solve(a, b, mu, f0, iterations=4, nc=8, nl=8)
    assert ops.apgd_solve.launches == n0 + 1
    big = _problem(4, 10, 4, torch.float32, seed=3)   # ne = 34
    with pytest.raises(ValueError, match="ne <= 32"):
        ops.apgd_solve(*big, iterations=4, nc=10, nl=4)
    with pytest.raises(ValueError, match="contiguous"):
        ops.apgd_solve(a.transpose(1, 2), b, mu, f0, iterations=4, nc=8, nl=8)
    with pytest.raises(ValueError, match="CUDA"):
        ops.apgd_solve(a, b.cpu(), mu, f0, iterations=4, nc=8, nl=8)
    assert ops.apgd_solve.launches == n0 + 1


def test_main_path_on_the_card_matches_the_cpu(cuda):
    """16 envs × 20 steps from fixed frames with the bundled checkpoint:
    the card (kernel) and the CPU (plain version) give the same episode
    lengths and qpos within 1e-3; the kernel runs 4 solves per step."""
    idx = torch.arange(16) * 2 % 39
    out = {}
    for dev in ("cuda", "cpu"):
        env = DPEnvV3(model=build_humanoid(device=dev))
        policy = MlpPolicy(ob_dim=56, ac_dim=28)
        params = checkpoint.load_trpo_params(CKPT, policy, dev)
        n0 = ops.apgd_solve.launches
        out[dev] = runner.rollout(env, policy, params, env.reset_at(idx), 20)
        if dev == "cuda":
            assert ops.apgd_solve.launches - n0 == 4 * 20
    torch.testing.assert_close(out["cuda"].ep_len.cpu(), out["cpu"].ep_len)
    torch.testing.assert_close(out["cuda"].state.qpos.cpu(),
                               out["cpu"].state.qpos, atol=1e-3, rtol=0)
