"""Tests of the port that need the card: the APGD kernels against their
plain PyTorch version, and the main path on CUDA against the CPU (the
walk, the recipe, the multi-clip env, the learners, the original
DeepMimic PPO stack's surface and train step, the other envs: DPEnvV1,
DPEnvV2, HumanoidTestEnv, VecNormalize and the facade, and the
physics-fidelity modes with the imported models, data-parallel
training: gloo ranks on the card, NCCL at world 1, the observability
and render tools: the trace's APGD count, the render rollouts, the
solver studies' configurations: f32 A at 300 iterations, ne 40 and 48,
and the solver's selection on tied depths and the one-step check).

Imports no JAX (the card's machine has none), so it runs there without the
repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Without a card every test skips, decided inside the ``cuda`` fixture."""

import math
import os

import pytest
import torch

from deepmimic_mujoco_torch.algos import runner
from deepmimic_mujoco_torch.algos.trpo import Draws
from deepmimic_mujoco_torch.envs.dp_env_v3 import DPEnvV3
from deepmimic_mujoco_torch.io_utils import checkpoint
from deepmimic_mujoco_torch.models.policy import MlpPolicy
from deepmimic_mujoco_torch.ops import apgd as ops
from deepmimic_mujoco_torch.ops import timing
from deepmimic_mujoco_torch.physics.humanoid import build_humanoid
from tests.torch_wide_plan import plan as wide_plan

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


@pytest.mark.parametrize("rows", ["grouped", "interleaved"])
def test_kernel_at_300_iterations_matches_plain(cuda, rows):
    """``apgd_solve`` with f32 A at 300 iterations, B = 4096: the cold
    stage-1 solve of warmstart_study's cold300."""
    a, b, mu, f0 = _problem(4096, 8, 8, torch.float32, seed=300)
    plain = ops._apgd_scan if rows == "interleaved" else ops._apgd_grouped
    kw = dict(iterations=300, nc=8, nl=8)
    torch.testing.assert_close(ops.apgd_solve(a, b, mu, f0, rows=rows, **kw),
                               plain(a, b, mu, f0, **kw), atol=ATOL, rtol=0)


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
    (1, 13, 8),      # ne = 47, one env: a block of four env slots
    (37, 16, 0),     # ne = 48, the edge of the third tile; no limits
    (4096, 10, 10),  # ne = 40: contactcap_study's cap10
    (4096, 12, 12),  # ne = 48: contactcap_study's cap12
    (4097, 5, 34),   # ne = 49: a fourth tile; B no multiple of any block
    (37, 0, 96),     # ne = 96, the edge of the sixth tile; no contacts
    (5, 20, 37),     # ne = 97
    (37, 40, 24),    # ne = 144, the largest of the 9-tile classes
    (37, 41, 22),    # ne = 145, the smallest of the 12-tile classes
    (3, 63, 2),      # ne = 191
    (4097, 50, 42),  # ne = 192, MAX_NE_WIDE
], ids=["ne33", "ne64", "ne139", "ne47-B1", "ne48", "ne40-cap10",
        "ne48-cap12", "ne49-B4097", "ne96",
        "ne97", "ne144", "ne145", "ne191", "ne192-B4097"])
def test_wide_kernel_matches_plain(cuda, B, nc, nl, a_dtype):
    """``apgd_solve_wide`` against ``_apgd_scan`` (the XLA route's port) on
    the same systems, atol 1e-4 (TestAPGD's), at and beside the edges of
    the kernel's 16-row tiles and classes; the dispatch sends ne > 32 to
    it and to no other kernel."""
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


def _branch_problem(B, nc, nl, a_dtype, seed):
    """Systems whose warm starts take every branch of the projection: inside
    the cone, on its surface, above it, below it (the dual cone), and zero
    friction; A and b as in ``_problem``."""
    a, b, mu, f0 = _problem(B, nc, nl, a_dtype, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    kind = (torch.arange(nc, device="cuda")[None, :]
            + torch.arange(B, device="cuda")[:, None]) % 5
    fn = 0.5 + 1.5 * torch.rand((B, nc), generator=gen, device="cuda")
    ang = 2 * math.pi * torch.rand((B, nc), generator=gen, device="cuda")
    mu = torch.where(kind == 4, 0.0, mu)
    ratio = torch.tensor([0.5, 1.0, 3.0, 0.5, 2.0], device="cuda")[kind]
    fn = torch.where(kind == 3, -fn, fn)
    t = ratio * torch.clamp(mu, min=0.5) * fn.abs()
    f0 = f0.clone()
    f0[:, 0:3 * nc:3] = fn
    f0[:, 1:3 * nc:3] = t * torch.cos(ang)
    f0[:, 2:3 * nc:3] = t * torch.sin(ang)
    return a, b, mu.contiguous(), f0


@pytest.mark.parametrize("a_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("nc,nl", [(16, 16), (37, 28)],
                         ids=["ne64", "ne139"])
def test_wide_kernel_projection_branches_match_plain(cuda, nc, nl, a_dtype):
    """Warm starts in every branch of the cone (inside, on the surface,
    above, below, μ = 0): the projection alone (0 iterations) and the solve
    (8, 60) against the plain version."""
    a, b, mu, f0 = _branch_problem(64, nc, nl, a_dtype, seed=11)
    fn = f0[:, 0:3 * nc:3]
    ft = torch.hypot(f0[:, 1:3 * nc:3], f0[:, 2:3 * nc:3])
    assert bool((ft < mu * fn).any() and (mu * ft <= -fn).any()
                and (ft > mu * fn).any() and (mu == 0).any())
    for iters in (0, 8, 60):
        kw = dict(iterations=iters, nc=nc, nl=nl)
        torch.testing.assert_close(ops.apgd_solve_wide(a, b, mu, f0, **kw),
                                   ops._apgd_scan(a, b, mu, f0, **kw),
                                   atol=ATOL, rtol=0)


def test_wide_launch_plan_is_the_designed_one(cuda):
    """The compiled plan (``apgd_wide_plan``) against its mirror
    ``tests/torch_wide_plan.py``, which the CPU tests hold to the design,
    for every ne and both types of A; each class is resident on an SM."""
    for ne in range(1, ops.MAX_NE_WIDE + 1):
        for nc in sorted({0, ne // 3}):
            for bf16 in (True, False):
                got = ops.wide_launch_plan(ne, nc, bf16, 4097)
                want = wide_plan(ne, nc, bf16, 4097)
                assert (got["tiles"], got["row_tiles_per_warp"],
                        got["warps_per_env"], got["envs_per_block"],
                        got["threads"], got["smem"]) == (
                    want["kt"], want["row_tiles"], want["warps"],
                    want["envs"], want["threads"], want["smem"]), (ne, nc)
                sms = torch.cuda.get_device_properties(0).multi_processor_count
                assert got["blocks_per_sm"] >= 1
                assert got["grid"] == min(want["groups"],
                                          got["blocks_per_sm"] * sms)


def test_wide_kernel_refuses_systems_above_its_maximum(cuda):
    big = _problem(4, 66, 0, torch.bfloat16, seed=5)   # ne = 198
    n0 = ops.apgd_solve_wide.launches
    with pytest.raises(ValueError, match="MAX_NE_WIDE"):
        ops.apgd(*big, iterations=4, nc=66, nl=0)
    assert ops.apgd_solve_wide.launches == n0


WIDE_MODELS = {
    "caps16": dict(contact_cap=16, limit_cap=16),
    "uncapped": dict(contact_cap=1 << 30, limit_cap=1 << 30),
    # README's exact-cold configuration: f32 A, cold 50-iteration stage 1
    "exact-cold": dict(warm_iterations=0, solver_dtype="f32",
                       contact_cap=16, limit_cap=16),
}


@pytest.mark.parametrize("caps", list(WIDE_MODELS))
def test_larger_caps_on_the_card_match_the_cpu(cuda, caps, monkeypatch):
    """16 envs × 20 steps with 16/16 caps (ne = 64), uncapped (ne = 139)
    and the exact-cold configuration: the card (the wide kernel, 4 launches
    per step, nothing else; the plain ``_apgd_scan`` never called) against
    the CPU (plain version), episode lengths equal and qpos within 1e-3 as
    on the main path."""
    idx = torch.arange(16) * 2 % 39
    out = {}
    for dev in ("cuda", "cpu"):
        env = DPEnvV3(model=build_humanoid(**WIDE_MODELS[caps], device=dev))
        policy = MlpPolicy(ob_dim=56, ac_dim=28)
        params = checkpoint.load_trpo_params(CKPT, policy, dev)
        state = env.reset_at(idx)
        if dev == "cpu":
            out[dev] = runner.rollout(env, policy, params, state, 20)
            continue
        scans = []
        plain = ops._apgd_scan
        monkeypatch.setattr(
            ops, "_apgd_scan",
            lambda *a, **kw: scans.append(1) or plain(*a, **kw))
        n0 = (ops.apgd_solve.launches, ops.apgd_solve_lanes.launches,
              ops.apgd_solve_wide.launches)
        out[dev] = runner.rollout(env, policy, params, state, 20)
        assert (ops.apgd_solve.launches - n0[0],
                ops.apgd_solve_lanes.launches - n0[1],
                ops.apgd_solve_wide.launches - n0[2]) == (0, 0, 4 * 20)
        assert not scans
        monkeypatch.setattr(ops, "_apgd_scan", plain)
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


MULTI_CLIPS = ("walk", "run", "spinkick", "backflip", "getup_facedown")


def test_multi_clip_env_on_the_card_matches_the_cpu(cuda):
    """16 envs of ``DPEnvV3Multi`` spread over five clips (mocap joint
    limits, the lane tool's recipe), 20 steps of the same seeded actions:
    on the card 8 ``apgd_solve`` launches per control step and nothing
    else; against the CPU (plain version) qpos, obs and rewards within
    1e-4 at every step and equal done flags."""
    from deepmimic_mujoco_torch.envs.multi_clip import DPEnvV3Multi
    from deepmimic_mujoco_torch.physics.humanoid import mocap_hinge_range

    gen = torch.Generator().manual_seed(0)
    acts = 0.1 * torch.randn((20, 16, 28), generator=gen)
    cid = torch.arange(16) % 5
    out = {}
    for dev in ("cuda", "cpu"):
        env = DPEnvV3Multi(clips=MULTI_CLIPS,
                           model=mocap_hinge_range(device=dev))
        s = env.reset_at(cid, (torch.arange(16) * 7) % env.clip_lens[
            cid.to(dev)].cpu())
        n0 = (ops.apgd_solve.launches, ops.apgd_solve_lanes.launches,
              ops.apgd_solve_wide.launches)
        rec = []
        for a in acts:
            s = env.step(s, a.to(dev))
            rec.append((s.qpos.cpu(), s.obs.cpu(), s.reward.cpu(),
                        s.done.cpu()))
        if dev == "cuda":
            assert (ops.apgd_solve.launches - n0[0],
                    ops.apgd_solve_lanes.launches - n0[1],
                    ops.apgd_solve_wide.launches - n0[2]) == (8 * 20, 0, 0)
        out[dev] = rec
    for (qc, oc, rc, dc), (qp, op, rp, dp) in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(qc, qp, atol=1e-4, rtol=0)
        torch.testing.assert_close(oc, op, atol=1e-4, rtol=0)
        torch.testing.assert_close(rc, rp, atol=1e-4, rtol=0)
        assert torch.equal(dc, dp)


def test_lane_segment_update_on_the_card_matches_the_cpu(cuda):
    """One lane-batched ``_segment_update`` of 3 lanes (relu 64-32 nets)
    from the same segment (a 16-env x 16-step rollout per lane on the
    card), params and vf permutations, on the card and on the CPU: the same
    step size and acceptance per lane, the policy within 1e-4 and the vf
    within 1e-3 of max(1, max|x|), the losses within 1e-4."""
    from deepmimic_mujoco_torch.algos import adam, lanes, trpo
    from deepmimic_mujoco_torch.envs.multi_clip import DPEnvV3Multi
    from deepmimic_mujoco_torch.physics.humanoid import mocap_hinge_range

    L, E, T = 3, 16, 16
    perms = torch.stack([torch.randperm(E * T, generator=torch.Generator()
                                        .manual_seed(k))[None]
                         for k in range(L)])

    class FixedPerms(trpo.Draws):
        def __init__(self, k):
            super().__init__(None)
            self.k = k

        def vf_permutations(self, n, epochs, device):
            return perms[self.k].to(device)

    out, seg = {}, None
    for dev in ("cuda", "cpu"):
        env = DPEnvV3Multi(clips=MULTI_CLIPS,
                           model=mocap_hinge_range(device=dev))
        policy = MlpPolicy(ob_dim=env.observation_size, ac_dim=28,
                           hidden_sizes=(64, 32), activation="relu",
                           fixed_logstd=-3.0)
        learner = lanes.LaneTRPO(env, policy, trpo.TRPOConfig(
            horizon=T, num_envs=E, vf_iters=1, reset_mode="rsi_pinned"),
            lanes=L)
        gens = [torch.Generator(device=dev).manual_seed(k) for k in range(L)]
        st = learner.init(gens, [0, 2, 3])
        if dev == "cuda":
            p_ref = st.params
            seg = learner._rollout(st.params, st.env_state, st.new,
                                   st.draws, st.cur_ep_ret,
                                   st.cur_ep_len)[0]
        params = {"pol": [{k: x.to(dev) for k, x in layer.items()}
                          for layer in p_ref["pol"]],
                  "vf": [{k: x.to(dev) for k, x in layer.items()}
                         for layer in p_ref["vf"]],
                  "logstd": p_ref["logstd"].to(dev),
                  "ob_rms": type(p_ref["ob_rms"])(
                      *(x.to(dev) for x in p_ref["ob_rms"]))}
        res = learner._segment_update(
            params, adam.AdamState(*(x.to(dev) for x in st.vf_adam)),
            {k: v.to(dev) for k, v in seg.items()},
            [FixedPerms(k) for k in range(L)])
        out[dev] = (lanes.flatten(trpo.policy_leaves(res[0])).cpu(),
                    lanes.flatten(trpo.vf_leaves(res[0])).cpu(),
                    res[2].cpu(), res[4])

    def rel(a, b):
        return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))

    (pc, vc, lc, ic), (pp, vp, lp, ip) = out["cuda"], out["cpu"]
    assert torch.equal(ic.stepsize.cpu(), ip.stepsize)
    assert torch.equal(ic.accepted.cpu(), ip.accepted)
    assert rel(pc, pp) <= 1e-4 and rel(vc, vp) <= 1e-3 and rel(lc, lp) <= 1e-4


# ---------------------------------------------------------------------------
# GAIL and PPO

EXPERT = os.path.join(os.path.dirname(__file__), "..", "assets", "expert",
                      "walk_expert.npz")
GAIL_ENV = dict(clip="walk", reward_mode="imitation_dm",
                control_mode="pd_residual", n_substeps=2,
                max_episode_steps=300, obs_mode="full")


def _to(tree, dev):
    """A params dict (lists of layers, an obs-RMS triple) on ``dev``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return type(tree)(*(_to(v, dev) for v in tree))


def _rel(a, b):
    return float((a.cpu() - b.cpu()).abs().max()) / max(
        1.0, float(b.abs().max()))


def _gail(dev, B, T, d_step=1):
    from deepmimic_mujoco_torch.algos.dataset import MujocoDset
    from deepmimic_mujoco_torch.algos.gail import GAIL, GAILConfig
    from deepmimic_mujoco_torch.algos.trpo import TRPOConfig

    d = MujocoDset(EXPERT)
    env = DPEnvV3(model=build_humanoid(device=dev), **GAIL_ENV)
    return GAIL(env, MlpPolicy(ob_dim=68, ac_dim=28), d.obs, d.acs,
                GAILConfig(trpo=TRPOConfig(horizon=T, num_envs=B,
                                           reset_mode="rsi"),
                           d_step=d_step))


def test_gail_control_steps_launch_eight_kernels(cuda):
    """A discriminator-rewarded rollout of the recipe (8 envs × 5 steps):
    8 ``apgd_solve`` launches per control step and no other APGD
    launch."""
    learner = _gail("cuda", 8, 5)
    st = learner.init(torch.Generator(device="cuda").manual_seed(0))
    n0 = (ops.apgd_solve.launches, ops.apgd_solve_lanes.launches,
          ops.apgd_solve_wide.launches)
    t = st.trpo
    seg = learner.trpo._rollout(
        t.params, t.env_state, t.new, Draws(t.draws.generator), t.cur_ep_ret,
        t.cur_ep_len, reward_fn=lambda ob, ac: learner.disc.reward(
            st.d_params, ob, ac))[0]
    torch.cuda.synchronize()
    assert (ops.apgd_solve.launches - n0[0],
            ops.apgd_solve_lanes.launches - n0[1],
            ops.apgd_solve_wide.launches - n0[2]) == (8 * 5, 0, 0)
    assert seg["ep_true"].shape == (5, 8) and bool(
        torch.isfinite(seg["rew"]).all())


def test_gail_d_step_and_segment_update_on_the_card_match_the_cpu(cuda):
    """One exact GAIL d-step (2 minibatches) and one TRPO segment update
    from the same 8-env × 16-step segment (a rewarded rollout of the recipe
    on the card), params and permutations, on the card and on the CPU: the
    discriminator's loss and accuracies and its logits on the segment, the
    policy's means and the values on the segment within 1e-4 of max(1,
    max|x|); the parameters within 1e-2 (Adam moves a parameter by about
    its step size whatever the sign of a rounding-level gradient)."""
    from deepmimic_mujoco_torch.algos import adam
    from deepmimic_mujoco_torch.algos.gail import disc_leaves
    from deepmimic_mujoco_torch.algos.trpo import (flatten, policy_leaves,
                                                   vf_leaves)

    B, T = 8, 16
    gen = torch.Generator().manual_seed(0)
    d_perm = torch.randperm(B * T, generator=gen)
    vf_perms = torch.stack([torch.randperm(B * T, generator=gen)
                            for _ in range(3)])

    class Fixed(Draws):
        def d_permutation(self, n, device):
            return d_perm.to(device)

        def vf_permutations(self, n, epochs, device):
            return vf_perms.to(device)

    ref = _gail("cuda", B, T, d_step=2)
    st = ref.init(torch.Generator(device="cuda").manual_seed(0))
    t = st.trpo
    seg = ref.trpo._rollout(
        t.params, t.env_state, t.new, t.draws, t.cur_ep_ret, t.cur_ep_len,
        reward_fn=lambda ob, ac: ref.disc.reward(st.d_params, ob, ac))[0]
    out = {}
    for dev in ("cuda", "cpu"):
        learner = _gail(dev, B, T, d_step=2)
        s = {k: v.to(dev) for k, v in seg.items()}
        ob, ac = s["ob"].reshape(-1, 68), s["ac"].reshape(-1, 28)
        d_params, d_adam, ptr, rec = learner._d_update(
            _to(st.d_params, dev), adam.AdamState(*_to(list(st.d_adam), dev)),
            st.expert_ptr.to(dev), ob, ac, Fixed(None))
        params = learner.trpo._segment_update(
            _to(t.params, dev), adam.AdamState(*_to(list(t.vf_adam), dev)),
            s, Fixed(None))[0]
        mean, _ = learner.policy.mean_logstd(params, ob)
        out[dev] = dict(
            rec=rec, logits=learner.disc.logits(d_params, ob, ac),
            mean=mean, value=learner.policy.value(params, ob),
            d_flat=flatten(disc_leaves(d_params)),
            pol=flatten(policy_leaves(params)), vf=flatten(vf_leaves(params)),
            ptr=int(ptr))
    c, p = out["cuda"], out["cpu"]
    assert c["ptr"] == p["ptr"] == B * T
    for k in ("rec", "logits", "mean", "value"):
        assert _rel(c[k], p[k]) <= 1e-4, k
    for k in ("d_flat", "pol", "vf"):
        assert _rel(c[k], p[k]) <= 1e-2, k


class _Record(Draws):
    """Draws from a CPU generator, each kept in ``log``."""

    def __init__(self, log):
        super().__init__(torch.Generator().manual_seed(0))
        self.log = log

    def _keep(self, x):
        self.log.append(x)
        return x

    def action_noise(self, mean):
        return self._keep(super().action_noise(mean))

    def fresh_states(self, reset_fn, done, state=None):
        return self._keep(super().fresh_states(reset_fn, done, state))

    def vf_permutations(self, n, epochs, device):
        return self._keep(super().vf_permutations(n, epochs, device))


class _Replay(Draws):
    """A ``_Record``'s draws, in order, moved to the run's device."""

    def __init__(self, log):
        super().__init__(None)
        self.log = log

    def action_noise(self, mean):
        return self.log.pop(0).to(mean.device)

    def fresh_states(self, reset_fn, done, state=None):
        return self.log.pop(0).map(lambda x: x.to(done.device))

    def vf_permutations(self, n, epochs, device):
        return self.log.pop(0).to(device)


def test_ppo_iteration_on_the_card_matches_the_cpu(cuda):
    """One ``PPO.iteration`` (walk, torque; 16 envs × 16 steps, 4 epochs ×
    8 minibatches) from the same state and the same draws (the CPU run's,
    replayed on the card): 4 ``apgd_solve`` launches per env step; the
    policy's means and the values on the CPU's final obs and the
    iteration's stats within 1e-4 of max(1, max|x|); the parameters within
    1e-2."""
    import dataclasses

    from deepmimic_mujoco_torch.algos import adam
    from deepmimic_mujoco_torch.algos.ppo import PPO, PPOConfig, train_leaves
    from deepmimic_mujoco_torch.algos.trpo import flatten

    B, T = 16, 16
    cpu, card = (PPO(DPEnvV3(model=build_humanoid(device=dev)),
                     MlpPolicy(ob_dim=56, ac_dim=28),
                     PPOConfig(horizon=T, num_envs=B))
                 for dev in ("cpu", "cuda"))
    log = []
    st = cpu.init(torch.Generator().manual_seed(1))
    st_card = dataclasses.replace(
        st, params=_to(st.params, "cuda"),
        opt=adam.AdamState(*_to(list(st.opt), "cuda")),
        env_state=st.env_state.map(lambda x: x.to("cuda")),
        new=st.new.cuda(), draws=_Replay(log), cur_ep_ret=st.cur_ep_ret.cuda(),
        cur_ep_len=st.cur_ep_len.cuda(), lr_scale=st.lr_scale.cuda())

    def run(learner, state, obs=None):
        st1, stats = learner.iteration(state)
        obs = st1.env_state.obs if obs is None else obs
        mean, _ = learner.policy.mean_logstd(st1.params, obs)
        return dict(
            mean=mean, value=learner.policy.value(st1.params, obs),
            stats=torch.stack([stats.meankl, stats.surrgain, stats.entropy,
                               stats.ev_tdlam_before]),
            flat=flatten(train_leaves(st1.params))), obs

    p, obs = run(cpu, dataclasses.replace(st, draws=_Record(log)))
    n0 = ops.apgd_solve.launches
    c, _ = run(card, st_card, obs.cuda())
    assert ops.apgd_solve.launches - n0 == 4 * T and not log
    for k in ("mean", "value", "stats"):
        assert _rel(c[k], p[k]) <= 1e-4, k
    assert _rel(c["flat"], p["flat"]) <= 1e-2


def test_dp_surface_on_the_card_matches_the_cpu(cuda):
    """The 197-D DeepMimic surface (walk, 2 substeps, ``imitation_dm``),
    16 envs x 20 steps on the card and on the CPU from the same frames and
    the same PD actions (the clip's pose plus noise): obs within 1e-3,
    rewards within 1e-4, equal done flags; 8 ``apgd_solve`` launches per
    control step, none of the wide kernel."""
    from deepmimic_mujoco_torch.envs.deepmimic_surface import (
        DeepMimicSurfaceEnv,
        targets_to_action,
    )

    envs = {d: DeepMimicSurfaceEnv(device=d) for d in ("cpu", "cuda")}
    frames = torch.arange(16) * 5 % 39
    gen = torch.Generator().manual_seed(2)
    states = {d: e.reset_at(frames) for d, e in envs.items()}
    n0 = (ops.apgd_solve.launches, ops.apgd_solve_wide.launches)
    for t in range(20):
        poses = envs["cpu"].clip_qpos[(frames + t + 1) % 39, 7:]
        act = torch.stack([torch.as_tensor(targets_to_action(p.numpy()))
                           for p in poses])
        act = act + 0.05 * torch.randn(act.shape, generator=gen)
        for d, e in envs.items():
            states[d] = e.step(states[d], act.to(d))
        c, p = states["cuda"], states["cpu"]
        assert (c.obs.cpu() - p.obs).abs().max() <= 1e-3, t
        assert (c.reward.cpu() - p.reward).abs().max() <= 1e-4, t
        assert torch.equal(c.done.cpu(), p.done), t
    assert (ops.apgd_solve.launches - n0[0],
            ops.apgd_solve_wide.launches - n0[1]) == (8 * 20, 0)


def test_dp_train_on_batch_on_the_card_matches_the_cpu(cuda):
    """One ``PPOAgent.train_on_batch`` of the r5 params on a padded
    buffer (paths ending FAIL, SUCC and NULL; 2 epochs x 4 minibatches of
    32 rows), the CPU's minibatch indices replayed on the card: the
    metrics within 1e-5 of max(1, max|x|), the parameters leaf by leaf
    within ``chip_smoke.DP_PARAM_BOUNDS`` (``chip_smoke.dp_param_diff``:
    the counts exactly, each leaf within 1e-3 of max(1, max|leaf|), the
    nets' and their momentum's steps within 1e-3 of the step's size)."""
    import chip_smoke
    from deepmimic_mujoco_torch.dp_policy.draws import Draws
    from deepmimic_mujoco_torch.dp_policy.ppo_agent import PPOAgent

    ckpt = os.path.join(os.path.dirname(__file__), "..",
                        "train_ckpt_dp_ppo_r5", "deepmimic", "ppo-walk-0",
                        "ppo_params.npz")
    gen = torch.Generator().manual_seed(3)
    n, pad = 200, 56
    is_end = torch.rand(n + pad, generator=gen) < 0.1
    is_end[n - 1:] = True
    kind = torch.randint(0, 3, (n + pad,), generator=gen)
    z = torch.randn((n + pad, 36), generator=gen)
    # the logp of each action's normalized noise (noise 0.05, a_norm std
    # 10: a = mean + 0.5·z), jittered as a policy that moved since
    logp = (-0.5 * (z * z).sum(1) - 18 * math.log(2 * math.pi)
            - 36 * math.log(0.05))
    batch = dict(
        states=torch.randn((n + pad, 197), generator=gen), actions=z,
        logps=logp + 0.3 * torch.randn(n + pad, generator=gen),
        rewards=torch.rand(n + pad, generator=gen), is_end=is_end,
        is_fail=is_end & (kind == 1), is_succ=is_end & (kind == 2),
        is_exp=~is_end & (torch.rand(n + pad, generator=gen) < 0.7))
    valid = torch.arange(n + pad) < n
    log = []

    class Record(Draws):
        def minibatch_indices(self, *a):
            log.append(super().minibatch_indices(*a))
            return log[-1]

    class Replay(Draws):
        def minibatch_indices(self, p_critic, *a):
            return tuple(x.to(p_critic.device) for x in log.pop(0))

    out = {}
    for dev, draws in (("cpu", Record(torch.Generator().manual_seed(4))),
                       ("cuda", Replay(None))):
        agent = PPOAgent(197, 36, spec={"MiniBatchSize": 32, "Epochs": 2})
        params = checkpoint.load_dp_ppo_params(ckpt, agent, dev)
        with torch.no_grad():
            mean = agent.actor_mean(params, batch["states"].to(dev))
        b = {**{k: v.to(dev) for k, v in batch.items()},
             "actions": mean + 0.5 * batch["actions"].to(dev)}
        p1, m = agent.train_on_batch(params, draws, b["states"], b["actions"],
                                     b["logps"], b["rewards"], b["is_end"],
                                     b["is_fail"], b["is_succ"], b["is_exp"],
                                     4, valid=valid.to(dev))
        out[dev] = (torch.stack([m[k] for k in sorted(m)]), params, p1)
    assert not log
    assert _rel(out["cuda"][0], out["cpu"][0]) <= 1e-5
    d = chip_smoke.dp_param_diff(out["cpu"][1], out["cuda"][2],
                                 out["cpu"][2])
    for k, bound in chip_smoke.DP_PARAM_BOUNDS.items():
        assert d[k] <= bound, (k, d[k], d["worst"][k])


@pytest.mark.parametrize("name", ["DPEnvV1", "DPEnvV2", "HumanoidTestEnv"])
def test_other_envs_on_the_card_match_the_cpu(cuda, name):
    """16 envs x 10 control steps of DPEnvV1, DPEnvV2 (dt 0.002, 6
    substeps) and HumanoidTestEnv (5 substeps and the obs' cold forward)
    on the card and on the CPU from the same starts and actions: qpos within
    1e-3, rewards within 1e-3 of max(1, |r|), equal done flags,
    HumanoidTestEnv's obs within 1e-3 of max(1, |x|) per block; 24, 24 and
    21 ``apgd_solve`` launches per control step and no plain solve
    (``chip_smoke.env_card_vs_cpu``, which raises otherwise)."""
    import chip_smoke

    rec = chip_smoke.env_card_vs_cpu(torch, ops, name)
    assert rec["apgd_scan_calls"] == 0 and rec["done_equal"]


def test_vec_normalize_on_the_card(cuda):
    """``VecNormalize(VectorEnv(HumanoidTestEnv(), 256, "init"))``, 12
    steps on the card: normalized obs finite and within ±10, 21 launches
    per step plus 1 at each step with fresh starts, 1 at the reset
    (``chip_smoke.vec_normalize_run``)."""
    import chip_smoke

    rec = chip_smoke.vec_normalize_run(torch, ops, n_envs=256, steps=12)
    assert rec["finite"] and rec["max_abs_obs"] <= 10.0


def test_deepmimic_facade_on_the_card_matches_the_cpu(cuda):
    """10 ``set_action`` + ``update(1/30)`` of ``DeepMimicEnv(reward_mode=
    "imitation")`` under the walk clip's PD targets, card vs CPU:
    ``record_state`` and ``calc_reward`` within 1e-3 after each, equal
    ``check_terminate``, 8 launches per update
    (``chip_smoke.facade_card_vs_cpu``)."""
    import chip_smoke

    rec = chip_smoke.facade_card_vs_cpu(torch, ops, updates=10)
    assert rec["terminate_equal"]


@pytest.mark.parametrize("case", ["import", "euler", "cholesky", "pgs"])
def test_physics_modes_on_the_card_match_the_cpu(cuda, case):
    """16 envs x 10 control steps of ``DPEnvV3`` on the imported humanoid
    (``parse_mjcf`` at 16/16 caps: exact-cold, ne 64), the euler humanoid,
    the Cholesky M⁻¹ and PGS, on the card and on the CPU from the same
    frames and actions: qpos within 1e-3, qvel and rewards within 1e-3 of
    max(1, |x|), equal done flags; 4 ``apgd_solve_wide``, 1 and 4
    ``apgd_solve`` and 0 APGD launches per control step, no plain solve
    (``chip_smoke.env_card_vs_cpu``, which raises otherwise)."""
    import chip_smoke

    rec = chip_smoke.env_card_vs_cpu(torch, ops, case)
    assert rec["apgd_scan_calls"] == 0 and rec["done_equal"]
    assert rec["launches"] == {k: 10 * v for k, v in
                               chip_smoke.MODE_LAUNCHES[case].items()}


def test_imported_models_and_calibration_on_the_card(cuda):
    """``parse_mjcf(to_mjcf(), 16, 16)`` and the shipped character on the
    card equal ``build_humanoid()`` to 1e-6 with ``minv_mode`` 'ns';
    ``calibrate_minv_mode`` on the card decides as on the CPU
    (``chip_smoke._imported_models``)."""
    import chip_smoke

    rec = chip_smoke._imported_models(torch)
    assert rec["calibrate_humanoid"] == "ns"
    assert rec["mjcf"]["max_abs_diff"] <= 1e-6


# ---------------------------------------------------------------------------
# data-parallel training across processes (slice 11)


def test_gloo_collectives_on_cuda_tensors_at_world_2(cuda):
    """Two gloo ranks on the card (the one-card machine's two-rank
    backend: NCCL refuses two ranks on one card): ``maybe_pmean``,
    ``maybe_psum``, ``all_gather``, ``share_bytes`` and ``sync_check``
    as on the CPU, the results on the card."""
    from deepmimic_mujoco_torch.parallel import mesh
    from tests import torch_dist_workers as W

    ranks = mesh.launch(W.collectives_cuda_rank, 2, "gloo", device="cuda",
                        timeout=300)
    for out in ranks:
        assert out["devices"] == ["cuda"] * 3
        assert out["mean"][0].tolist() == [1.5] * 3
        assert out["sum"] == 3.0
        assert out["gathered"].tolist() == [[0.0], [1.0]]
        assert out["blob"] == b"ckpt\x00\x01payload"
        assert out["same"] is True and out["planted"] is False


def test_nccl_at_world_1_leaves_a_trpo_iteration_alone(cuda):
    """One NCCL rank spawned, ``TRPO.iteration`` at 64 envs x 8 steps: the
    same params as the iteration in this process within 1e-6, 4
    ``apgd_solve`` launches per env step, ``sync_check`` true."""
    from deepmimic_mujoco_torch.parallel import dryrun, mesh

    [one] = mesh.launch(dryrun.trpo_rank, 1, "nccl", args=("cuda", 64, 8),
                        device="cuda", timeout=300)
    local = dryrun.run_trpo(None, 0, 1, "cuda", 64, 8)
    d = float((one["flat"] - local["flat"]).abs().max())
    assert d <= 1e-6 * max(1.0, float(local["flat"].abs().max())), d
    assert one["synced"] and one["launches"]["apgd_solve"] == 32
    assert local["launches"] == one["launches"]


def test_dryrun_on_two_gloo_ranks_on_the_card(cuda):
    """``python -m deepmimic_mujoco_torch.parallel.dryrun --nproc 2
    --device cuda --backend gloo``."""
    import subprocess
    import sys

    res = subprocess.run(
        [sys.executable, "-m", "deepmimic_mujoco_torch.parallel.dryrun",
         "--nproc", "2", "--device", "cuda", "--backend", "gloo"],
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1].startswith(
        "dryrun_multichip(2): OK")


# ---------------------------------------------------------------------------
# observability and rendering (slice 12)


def test_device_trace_counts_the_apgd_launches(cuda, tmp_path):
    """A walk window (64 envs x 2 steps) through ``utils/profiling.
    device_trace``: ``cli.trace_summary`` of its trace counts the 8 APGD
    launches the wrappers counted and the device time of
    ``key_averages()`` within 1%; ``cli.profile_trace`` at 64 envs x 4
    steps: its trace's APGD kernels are the 16 it counted, and its busy
    time the ``key_averages()`` device time of the profile it returns
    within 1%
    (``chip_smoke._profile``, ``chip_smoke._trace_check``, which raise
    otherwise)."""
    import chip_smoke
    from deepmimic_mujoco_torch.cli import profile_trace, trace_summary
    from deepmimic_mujoco_torch.utils import profiling

    env = DPEnvV3(model=build_humanoid(device="cuda"))
    policy = MlpPolicy(ob_dim=56, ac_dim=28)
    params = checkpoint.load_trpo_params(CKPT, policy, "cuda")
    state = env.reset_at(torch.arange(64) % env.clip_len)
    rec = chip_smoke._profile(torch, runner, env, policy, params, state, 2,
                              "[test]", ops=ops,
                              trace_dir=str(tmp_path / "walk"))
    assert rec["trace"]["apgd_trace"] == 8
    res = profile_trace.main(["--num-envs", "64", "--horizon", "4",
                              "--iters", "1", "--out", str(tmp_path / "pt")])
    assert res["apgd_launches"] == 16
    summary = trace_summary.summarize(
        trace_summary.find_trace(str(tmp_path / "pt")))
    assert summary["by_category_count"]["apgd"] == 16
    busy_ms = profiling.device_self_us(res["profile"]) / 1e3
    assert abs(summary["busy_ms"] - busy_ms) <= 0.01 * busy_ms


def test_render_rollouts_on_the_card_match_the_cpu(cuda):
    """The rollouts of ``cli.render_policy`` (walk_r2) and
    ``cli.render_vmapped`` (an imit5_r5b lane), 30 control steps on the
    card and on the CPU: qpos within 1e-3 of max(1, |x|), equal alive
    flags, 8 ``apgd_solve`` launches per control step
    (``chip_smoke.render_rollouts``, which raises otherwise)."""
    import chip_smoke

    rec = chip_smoke.render_rollouts(torch, ops)
    for r in rec.values():
        assert r["alive_card"] == r["alive_cpu"]


def test_solver_studies_on_the_card_match_the_cpu(cuda):
    """``cli.warmstart_study`` (cold300: f32 A at 300 iterations;
    warm25+bf16) and ``cli.contactcap_study`` (cap10 and cap12: ne 40 and
    48 through the wide kernel) at 3 steps on the card against the CPU:
    qpos within 1e-4 of max(1, |x|) for f32 A, 1e-3 for bf16; each run's
    12 solves on the wide kernel."""
    from deepmimic_mujoco_torch.cli import contactcap_study, warmstart_study

    def rel(x, ref):
        return float((abs(x - ref) / abs(ref).clip(min=1.0)).max())

    argv = ["--steps", "3", "--configs", "cold300,warm25+bf16"]
    card = warmstart_study.main(argv)
    cpu = warmstart_study.main(argv + ["--device", "cpu"])
    assert rel(card["qpos"]["cold300"], cpu["qpos"]["cold300"]) <= 1e-4
    assert rel(card["qpos"]["warm25+bf16"],
               cpu["qpos"]["warm25+bf16"]) <= 1e-3
    argv = ["--steps", "3", "--caps", "cap10,cap12"]
    n0 = (ops.apgd_solve.launches, ops.apgd_solve_wide.launches)
    card = contactcap_study.main(argv)
    assert (ops.apgd_solve.launches, ops.apgd_solve_wide.launches) == (
        n0[0], n0[1] + 2 * 2 * 4 * 3)
    cpu = contactcap_study.main(argv + ["--device", "cpu"])
    for k, q in cpu["qpos"].items():
        assert rel(card["qpos"][k], q) <= 1e-3, k


@pytest.mark.parametrize("caps", [(8, 8), (16, 16), (1000, 1000)])
def test_selection_on_the_card_equals_the_cpu_on_ties(cuda, caps):
    """``solver.select_deepest`` on the card picks the CPU's indices, in
    the CPU's order, on depths with exact ties at and across the cut
    (``tests/torch_selection_cases.py``; the CPU is held to
    ``jax.lax.top_k`` in ``tests/test_torch_selection.py``)."""
    from deepmimic_mujoco_torch.physics import solver
    from tests.torch_selection_cases import CASES, depths

    model = build_humanoid(contact_cap=caps[0], limit_cap=caps[1],
                           device="cpu")
    nc, nl, nc_full, nl_full = solver._caps(model)
    for case in CASES:
        for seed, (n, k) in enumerate(((nc_full, nc), (nl_full, nl))):
            pos = torch.from_numpy(depths(case, n, k, seed))
            cpu = solver.select_deepest(pos, k)
            card = solver.select_deepest(pos.cuda(), k).cpu()
            assert torch.equal(card, cpu), (case, n, k)


def test_one_step_check_on_a_small_batch(cuda):
    """The smoke's one-step check (``chip_smoke.one_step_phase``, which
    raises otherwise) on 32 recipe states: 16 envs at steps 0 and 10 of a
    rollout on the card under actions 0.1·N(0, 1)."""
    import chip_smoke
    from deepmimic_mujoco_torch.utils import divergence

    env = DPEnvV3(model=build_humanoid(device="cuda"), **chip_smoke.RECIPE_ENV)
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = env.reset_at(list(range(0, 32, 2)))
    states, actions = [], []
    keep = divergence.keep_every(10, states, actions)
    with torch.no_grad():
        for t in range(11):
            action = 0.1 * torch.randn((16, 28), generator=gen, device="cuda")
            keep(t, state, action)
            state = env.step(state, action)
    rec = chip_smoke.one_step_phase(torch, ops, states, actions, tag="[test]")
    assert rec["ok"] and rec["envs"] == 32
    assert rec["selections"] == 4 * 32
