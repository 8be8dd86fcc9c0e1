"""Tests of the port that need the card: the APGD kernels against their
plain PyTorch version, and the main path on CUDA against the CPU.

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


@pytest.mark.parametrize("a_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,nc,nl", [
    (37, 11, 0),     # ne = 33, the smallest system the dispatch sends here
    (4096, 16, 16),  # ne = 64: build_humanoid(contact_cap=16, limit_cap=16)
    (300, 37, 28),   # ne = 139: the uncapped humanoid
], ids=["ne33", "ne64", "ne139"])
def test_wide_kernel_matches_plain(cuda, B, nc, nl, a_dtype):
    """``apgd_solve_wide`` against ``_apgd_scan`` (the XLA route's port) on
    the same systems, atol 1e-4 (TestAPGD's); the dispatch sends ne > 32
    to it and to no other kernel."""
    a, b, mu, f0 = _problem(B, nc, nl, a_dtype, seed=B + nc)
    for iters in (0, 8, 15, 60):
        kw = dict(iterations=iters, nc=nc, nl=nl)
        ref = ops._apgd_scan(a, b, mu, f0, **kw)
        out = ops.apgd_solve_wide(a, b, mu, f0, **kw)
        torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)
    counts = (ops.apgd_solve.launches, ops.apgd_solve_lanes.launches,
              ops.apgd_solve_wide.launches)
    for layout in ("blocks", "lanes"):
        out = ops.apgd(a, b, mu, f0, iterations=15, nc=nc, nl=nl,
                       layout=layout)
        torch.testing.assert_close(
            out, ops._apgd_scan(a, b, mu, f0, iterations=15, nc=nc, nl=nl),
            atol=ATOL, rtol=0)
    assert (ops.apgd_solve.launches, ops.apgd_solve_lanes.launches,
            ops.apgd_solve_wide.launches) == (counts[0], counts[1],
                                              counts[2] + 2)


def test_wide_kernel_refuses_systems_above_its_maximum(cuda):
    big = _problem(4, 66, 0, torch.bfloat16, seed=5)   # ne = 198
    n0 = ops.apgd_solve_wide.launches
    with pytest.raises(ValueError, match="MAX_NE_WIDE"):
        ops.apgd(*big, iterations=4, nc=66, nl=0)
    assert ops.apgd_solve_wide.launches == n0


@pytest.mark.parametrize("caps", [16, 1 << 30], ids=["caps16", "uncapped"])
def test_larger_caps_on_the_card_match_the_cpu(cuda, caps):
    """16 envs × 20 steps with 16/16 caps (ne = 64) and uncapped (ne = 139):
    the card (the wide kernel, 4 launches per step, nothing else) against
    the CPU (plain version), episode lengths equal and qpos within 1e-3 as
    on the main path."""
    idx = torch.arange(16) * 2 % 39
    out = {}
    for dev in ("cuda", "cpu"):
        env = DPEnvV3(model=build_humanoid(contact_cap=caps, limit_cap=caps,
                                           device=dev))
        policy = MlpPolicy(ob_dim=56, ac_dim=28)
        params = checkpoint.load_trpo_params(CKPT, policy, dev)
        n0 = (ops.apgd_solve.launches, ops.apgd_solve_wide.launches)
        out[dev] = runner.rollout(env, policy, params, env.reset_at(idx), 20)
        if dev == "cuda":
            assert (ops.apgd_solve.launches - n0[0],
                    ops.apgd_solve_wide.launches - n0[1]) == (0, 4 * 20)
    torch.testing.assert_close(out["cuda"].ep_len.cpu(), out["cpu"].ep_len)
    torch.testing.assert_close(out["cuda"].state.qpos.cpu(),
                               out["cpu"].state.qpos, atol=1e-3, rtol=0)


def test_segment_update_on_the_card_matches_the_cpu(cuda):
    """One TRPO ``_segment_update`` from the same 16-env × 32-step segment
    (a rollout on the card), params and vf permutations, on the card and on
    the CPU: the same accepted step size, the new policy within 1e-4 and
    the vf within 1e-3 of max(1, max|x|), the losses within 1e-4 (f32 sums
    in another order, amplified by CG; TF32 is off)."""
    from deepmimic_mujoco_torch.algos import adam
    from deepmimic_mujoco_torch.algos import trpo

    B, T = 16, 32
    gen = torch.Generator().manual_seed(0)
    policy = MlpPolicy(ob_dim=56, ac_dim=28)
    p_cpu = policy.init(gen, "cpu")
    perms = torch.stack([torch.randperm(B * T, generator=gen)
                         for _ in range(3)])

    class FixedPerms(trpo.Draws):
        def vf_permutations(self, n, epochs, device):
            return perms.to(device)

    def to(params, dev):
        return {"pol": [{k: x.to(dev) for k, x in layer.items()}
                        for layer in params["pol"]],
                "vf": [{k: x.to(dev) for k, x in layer.items()}
                       for layer in params["vf"]],
                "logstd": params["logstd"].to(dev),
                "ob_rms": type(params["ob_rms"])(
                    *(x.to(dev) for x in params["ob_rms"]))}

    out = {}
    for dev in ("cuda", "cpu"):
        learner = trpo.TRPO(DPEnvV3(model=build_humanoid(device=dev)),
                            policy, trpo.TRPOConfig(horizon=T, num_envs=B))
        params = to(p_cpu, dev)
        if dev == "cuda":
            g = torch.Generator(device="cuda").manual_seed(0)
            seg = learner._rollout(
                params, learner.env.reset(g, B),
                torch.ones(B, dtype=torch.bool, device="cuda"), trpo.Draws(g),
                torch.zeros(B, device="cuda"),
                torch.zeros(B, dtype=torch.int32, device="cuda"))[0]
        n_vf = sum(x.numel() for x in trpo.vf_leaves(params))
        res = learner._segment_update(params, adam.init(n_vf, dev),
                                      {k: v.to(dev) for k, v in seg.items()},
                                      FixedPerms(None))
        out[dev] = (to(res[0], "cpu"), res[2].cpu(), res[4])

    def rel(a, b):
        return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))

    (pc, lc, ic), (pp, lp, ip) = out["cuda"], out["cpu"]
    assert (ic.stepsize, ic.accepted) == (ip.stepsize, ip.accepted)
    assert rel(trpo.flatten(trpo.policy_leaves(pc)),
               trpo.flatten(trpo.policy_leaves(pp))) <= 1e-4
    assert rel(trpo.flatten(trpo.vf_leaves(pc)),
               trpo.flatten(trpo.vf_leaves(pp))) <= 1e-3
    assert rel(lc, lp) <= 1e-4


def test_imitation_recipe_on_the_card_matches_the_cpu(cuda):
    """16 envs × 20 steps of the imitation recipe (``imitation_dm``,
    ``pd_residual``, 2 substeps, fall-contact termination) with the bundled
    ``walk_r2`` policy: on the card 8 ``apgd_solve`` launches per control
    step and nothing else; against the CPU (plain version) equal episode
    lengths, qpos and per-step rewards within 1e-3."""
    ckpt = os.path.join(os.path.dirname(__file__), "..", "train_ckpt_walk_r2",
                        "DPEnvV3", "trpo-walk-0", "trpo_state.npz")
    idx = torch.arange(16) * 5 % 39
    out = {}
    for dev in ("cuda", "cpu"):
        env = DPEnvV3(model=build_humanoid(device=dev), clip="walk",
                      reward_mode="imitation_dm", control_mode="pd_residual",
                      n_substeps=2, max_episode_steps=300)
        policy = MlpPolicy(ob_dim=68, ac_dim=28, hidden_sizes=(1024, 512),
                           activation="relu", fixed_logstd=-3.0)
        params = checkpoint.load_trpo_params(ckpt, policy, dev)
        n0 = (ops.apgd_solve.launches, ops.apgd_solve_lanes.launches,
              ops.apgd_solve_wide.launches)
        out[dev] = runner.rollout(env, policy, params, env.reset_at(idx), 20,
                                  record=True)
        if dev == "cuda":
            assert (ops.apgd_solve.launches - n0[0],
                    ops.apgd_solve_lanes.launches - n0[1],
                    ops.apgd_solve_wide.launches - n0[2]) == (8 * 20, 0, 0)
    torch.testing.assert_close(out["cuda"].ep_len.cpu(), out["cpu"].ep_len)
    torch.testing.assert_close(out["cuda"].state.qpos.cpu(),
                               out["cpu"].state.qpos, atol=1e-3, rtol=0)
    torch.testing.assert_close(out["cuda"].traj[2].cpu(), out["cpu"].traj[2],
                               atol=1e-3, rtol=0)
