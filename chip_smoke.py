#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``deepmimic_mujoco_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

``python3 chip_smoke.py --wide-vs OLD.cu`` times the wide kernel against
another version of ``ops/csrc/apgd_wide.cu`` in turns (:func:`wide_vs`).

``python3 chip_smoke.py --dp-witness`` runs only the [dp-ppo] card-vs-CPU
check, with the card's solve on the kernel and on the plain version and
the dual matrix stored in bf16 and in f32, then with planted faults
(:func:`dp_witness`).

Phases, each printing its lines before the last:

1. device — the card's name and power limit, as ``nvidia-smi`` prints them;
2. build  — compiles ``ops/csrc/apgd.cu`` and ``ops/csrc/apgd_wide.cu``
   (one instantiation per count of 16-row tiles) with nvcc, one process
   per source started together; prints the seconds and each
   instantiation's registers, spills and static shared memory (``-Xptxas
   -v``);
3. kernel — both APGD entry points (``apgd_solve``: (B, ne, ne);
   ``apgd_solve_lanes``: (ne, ne, B)) against the plain PyTorch version on
   the same inputs, at the main path's B = 4096, ne = 32, with f32 and bf16
   A at 15, 8 and 60 iterations, in the grouped and the interleaved row
   order; the solver's dispatch ``apgd()`` in both layouts, on random
   systems and on the dual systems captured from 3 walk steps of the main
   path at 4096 envs (there also against the plain version run on the CPU,
   whose distance from the card's plain version is the f32 rounding spread
   of the reference itself); then the timing of each entry point at the
   main path's shape (bf16 A, 15 iterations) and of one env step's four
   solves (15 + 8 + 8 + 8 iterations) through ``apgd()`` in each layout:
   ``ms`` is CUDA events around 200 launches made from Python (what a
   caller sees), and ``device_ms`` the same launches replayed from a CUDA
   graph (the device time alone, also at 0 and 60 iterations); then the
   wide kernel (``apgd_solve_wide``, ne > 32) against the plain version at
   B = 4096, ne = 64 (16/16 caps) and 139 (uncapped), f32 and bf16 A, and
   at README's exact-cold shape (ne 64, f32 A, 50 iterations), with its
   ``ms``, ``device_ms``, bound (at the f32 and at the tensor cores' rate)
   and launch plan (envs and threads per block, shared memory, blocks
   resident per SM), and ptxas's registers and spills of the
   instantiations those shapes run; then [caps]: 16 envs × 10 steps of the
   humanoid with 16/16 caps, uncapped and in the exact-cold configuration
   on the card, every solve through the wide kernel (counted;
   ``_apgd_scan`` not called), held against the same rollouts on the
   CPU;
4. main path — ``cli.train_trpo --task evaluate`` of the bundled walk
   checkpoint at 4096 envs × 200 steps (blocks layout) and 768 × 50 (both
   layouts),
   with the launch counts set to 0 just before each run and read just after,
   before any profiler session; then [train], also before any profiler
   session: ``TRPO.iteration`` at 768 envs × 16 steps (one warm-up, one
   timed: the process's first training) and at 4096 × 64, g_step 1
   (bench.py's configuration; one iteration), the counts set to 0 just
   before the timed one: env-steps/s, the time
   of the rollout, the policy update and the vf epochs, APGD launches per
   env step (4), meankl ≤ 1.5·max_kl and finite stats; one
   ``_segment_update`` on the card against the CPU from the same segment;
   and ``cli.train_trpo --task train --num-iters 1`` in-process at 64
   envs, whose checkpoint must read back; then
   [imitation], the README's imitation recipe (``imitation_dm`` reward,
   ``pd_residual`` control, 2 substeps, 300-step episodes, fall-contact
   termination, the 68-D obs) with the bundled ``walk_r2`` policy (relu
   1024-512), also before any profiler session: ``--task evaluate`` over
   4096 RSI episodes x 300 steps (mean and median episode length ≥ 95% of
   the cap, reward per step within 0.03 of the port's CPU figure, 8
   ``apgd_solve`` launches per control step, no wide launch, no call of
   the plain ``_apgd_scan``), ``TRPO.iteration`` with the recipe's flags
   at 4096 envs x 32 steps (one iteration) and the training CLI in-process
   at 64 envs for one iteration, whose checkpoint must read back; then
   [multi], the multi-clip path, also before any profiler session: 16
   ``DPEnvV3Multi`` envs over five clips x 20 steps on the card against the
   CPU (1e-4, equal done flags) and ``cli.eval_multiskill`` of the bundled
   multiskill_r4 policy (3 skills x 32 episodes x 300 steps); then
   [trpo-lanes], the independent TRPO lanes of ``cli.imitation15_vmapped``
   (``algos/lanes.py``): the evaluation of the bundled imit5_r5b lanes (5
   lanes x 32 episodes x 300 steps from the frames JAX's tool draws, per
   lane within 0.03 reward per step and 5% EpLen of the port's CPU figures,
   8 ``apgd_solve`` launches per control step for the whole lane batch),
   one timed ``LaneTRPO.iteration`` of its 5 lanes x 160 envs resumed from
   it and one of 15 fresh lanes x 64 envs (horizon 32, g_step 1), and one
   lane-batched segment update of 3 lanes on the card against the CPU; then
   [gail], GAIL from the bundled r4 run (``train_ckpt_gail_r4``: the recipe
   with the full obs, a tanh 100x2 policy with a learned logstd, its
   discriminator and the expert cursor, read by ``load_gail_state``): its
   policy over 64 RSI episodes x 300 steps from fixed frames (within 0.03
   reward per step and 5% EpLen of the port's CPU figure, 8 ``apgd_solve``
   launches per control step), one timed ``GAIL.iteration`` resumed from
   its whole state at 64 envs x 32 steps x g_step 3 (env-steps/s, the
   rollout, policy update, vf epochs and d-step seconds, DLoss, GenAcc,
   ExpertAcc, EpTrueRewMean, meankl ≤ 1.5·max_kl, 8 launches per control
   step), one d-step and segment update on the card against the CPU, and
   ``cli.train_gail`` in-process with the run's flags at 64 envs, 50 BC
   steps and 1 iteration (the BC loss goes down, the checkpoint reads
   back); then [ppo]: ``cli.train_trpo --algo ppo --task
   train`` in-process at 4096 envs x 64 steps for 2 iterations (env-steps/s,
   rollout and update seconds, finite losses, 4 launches per env step) and
   one ``PPO.iteration`` on the card against the CPU with the CPU run's
   draws replayed; then [dp-ppo], the original DeepMimic PPO stack on the
   197-D surface from the bundled r5 run (``train_ckpt_dp_ppo_r5``, relu
   1024-512 actor and critic, read by ``load_dp_ppo_params``):
   ``RLAgentDriver.test_episodes`` over 512 RSI episodes x horizon 300 from
   ``dp_frames()`` (the first 64 within 0.03 reward per step and 10% of
   length of the port's CPU figure, 8 ``apgd_solve`` launches per control
   step), ``cli.train_ppo`` in-process at the r5 flags (512 envs, resumed)
   for 3 iterations with a test at the third (per iteration the rollout,
   absorb and train seconds and the logged metrics; finite losses, the
   stepsize 2.5e-6, ``Samples`` grown by each iteration's non-end records,
   the checkpoint read back, 8 launches per control step), one
   ``train_iteration`` at 16 envs x chunks of 16 steps on the CPU and on the
   card with the CPU's draws replayed (the params leaf by leaf,
   :func:`dp_param_diff`), ``cli.train_ppo --surface v3`` at 512 envs x 2
   iterations (4 launches per env step) and ``cli.get_action``; then
   [envs], the other envs and what wraps them: ``TRPO.iteration`` of
   ``DPEnvV2`` (dt 0.002, 6 substeps, the CLI's tanh 100x2 policy) at 4096
   envs x 16 steps, g_step 1 (one iteration; env-steps/s, phase
   seconds, exactly 24 ``apgd_solve`` launches per control step, no call
   of the plain solve, meankl ≤ 1.5·max_kl), 16 envs x 10 control steps
   of ``DPEnvV1``, ``DPEnvV2`` and ``HumanoidTestEnv`` on the card against
   the CPU (:func:`env_card_vs_cpu`), ``VecNormalize`` over a 4096-env
   ``VectorEnv`` of ``HumanoidTestEnv`` for 16 steps
   (:func:`vec_normalize_run`), 30 updates of the ``DeepMimicEnv`` facade
   on the card against the CPU (:func:`facade_card_vs_cpu`) and, in-process,
   ``cli.train_trpo --env-id DPEnvV1``, ``cli.torque_test``,
   ``cli.play_mocap`` and ``gym_shim.make("DPEnvV2")``
   (:func:`envs_clis`); then [physics-modes], the physics-fidelity modes
   and the model importers (:func:`physics_modes_phase`): ``parse_mjcf(
   to_mjcf(), 16, 16)`` and the shipped DeepMimic character on the card
   against ``build_humanoid()`` (1e-6), ``calibrate_minv_mode`` on the card
   against the CPU, then the bundled walk policy at 4096 envs on the
   imported model (exact-cold, ne 64: 4 ``apgd_solve_wide`` launches per
   control step, 32 steps), the euler humanoid (1 ``apgd_solve``, 32
   steps), the Cholesky M⁻¹ (4, full stages, 16 steps) and PGS (0, 8
   steps), env-steps/s and seconds per step, and each of the four 16 envs x
   10 control steps on the card against the CPU (qpos, qvel and rewards
   within 1e-3 of max(1, |x|), equal done flags); all before any profiler
   session; then profiler
   windows
   of one env step's
   four solves through ``apgd()`` (blocks: four kernels and nothing else),
   and ``torch.profiler`` windows of 5 env steps at 4096 envs and of 3
   recipe steps at 4096 envs (step time, device busy share, kernel
   launches per step, the solve's device time and launches per step, top
   kernels), and of 2 steps of PGS and of the imported model (all of it
   after [dist] and [mocap-ingest], below); then
   16-env, 20-step rollouts on the card, of the walk
   evaluation and of the recipe, held against the same rollouts on the CPU
   (plain versions: qpos and rewards within 1e-3, equal done flags);
   [dist] (before the profiler windows): data-parallel TRPO across
   processes (:func:`dist_phase`: NCCL at world 1 against this process,
   two gloo ranks on the one card at 4096 envs in total against one
   process on the same segment, card vs CPU, the dry run), and
   [mocap-ingest]: every bundled clip as DeepMimic JSON through the Python
   and the native loaders, and walk_r2 on the recipe from the JSON walk
   clip against the bundled one (:func:`mocap_ingest_phase`);
5. one JSON line with every kernel's numbers (with the registers, spills
   and shared memory of the instantiation the main path runs, and ptxas's
   figures for every instantiation), then the result line.

Nothing is caught: a phase that fails ends the run with a non-zero code.
Without CUDA the run stops before any phase.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import time

CKPT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "train_ckpt",
                    "DPEnvV3", "trpo-walk-0", "trpo_state.npz")
SEED = 0
NC, NL = 8, 8
NE = 3 * NC + NL
B_MAIN = 4096
HORIZON = 200
HORIZON_768 = 50             # the 768-env evaluations: 200, cut
ATOL = 1e-4          # TestAPGD's tolerance: the sums run in another order
ROLLOUT_ATOL = 1e-3  # 20 physics steps, card (kernel) vs CPU (plain)
HBM_BYTES_PER_S = 3.35e12    # H100 SXM
F32_FLOPS_PER_S = 67e12      # H100 SXM, f32 without tensor cores
BF16_TC_FLOPS_PER_S = 989e12  # H100 SXM, bf16 on the tensor cores, dense


WIDE = ((16, 16), (37, 28))  # (nc, nl): 16/16 caps (ne 64), uncapped (139)
# README's exact-cold configuration (build_humanoid(warm_iterations=0,
# solver_dtype="f32", contact_cap=16, limit_cap=16)): its cold stage-1 solve
EXACT_COLD = dict(warm_iterations=0, solver_dtype="f32", contact_cap=16,
                  limit_cap=16)
EXACT_COLD_ITERS = 50
CAPS_STEPS = 10              # [caps] rollout steps
TRAIN_HORIZON = 64           # bench.py's TRPO configuration: g_step 1
TRAIN_HORIZON_768 = 16       # [train] at 768 envs: 64, cut
MAX_KL = 0.01                # TRPOConfig's default

# the imitation recipe (README "Quick start") and its bundled policy
CKPT_R2 = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "train_ckpt_walk_r2", "DPEnvV3", "trpo-walk-0",
                       "trpo_state.npz")
RECIPE_ENV = dict(clip="walk", reward_mode="imitation_dm",
                  control_mode="pd_residual", n_substeps=2,
                  max_episode_steps=300)
RECIPE_POLICY = dict(ob_dim=68, ac_dim=28, hidden_sizes=(1024, 512),
                     activation="relu", fixed_logstd=-3.0)
RECIPE_FLAGS = ["--reward-mode", "imitation_dm", "--control-mode",
                "pd_residual", "--n-substeps", "2", "--max-episode-steps",
                "300", "--hidden-sizes", "1024,512", "--activation", "relu",
                "--fixed-logstd", "-3.0"]
RECIPE_TRAIN_FLAGS = ["--reset-mode", "rsi", "--gamma", "0.95", "--lam",
                      "0.95"]
IMIT_HORIZON = 300           # the recipe's episode cap
IMIT_TRAIN_HORIZON = 32
# reward per step of walk_r2 on the CPU: the port's cli.eval_imitation,
# 32 deterministic episodes x 300 steps from the frames that JAX's
# tools/eval_imitation.py draws (JAX: 0.771 on the same frames)
CPU_REWARD_PER_STEP = 0.7718

# the multi-clip path: one policy over three skills (multiskill_r4: xml
# joint limits) and five independent lane learners (imit5_r5b: mocap joint
# limits, the 15-clip env, 83-D obs), all relu 1024-512
ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT_MULTI = os.path.join(ROOT, "train_ckpt_multiskill_r4", "DPEnvV3",
                          "trpo-walk+run+spinkick-0", "trpo_state.npz")
CKPT_LANES = os.path.join(ROOT, "train_ckpt_imit5_r5b", "imit15_state.npz")
MULTI_SKILLS = "walk,run,spinkick"
LANE_CLIPS = "walk,run,spinkick,backflip,getup_facedown"
CLIPS15 = ("backflip,cartwheel,crawl,dance_a,dance_b,getup_facedown,"
           "getup_faceup,jump,kick,punch,roll,run,spin,spinkick,walk")
# the evaluation start frames that JAX's tools/imitation15_vmapped.py draws
# for these lanes from PRNGKey(11): 32 per lane, lanes separated by ';'
LANE_FRAMES = (
    "4,5,34,0,13,9,32,24,32,31,4,37,14,29,10,15,21,14,0,19,25,31,9,16,7,17,"
    "4,23,27,20,18,22;6,6,1,11,20,14,10,0,10,12,7,21,18,2,23,14,8,0,11,22,2,"
    "2,16,9,2,20,7,18,15,7,0,20;8,15,7,5,51,46,9,7,44,31,21,16,25,37,31,68,"
    "13,15,13,16,25,57,49,65,35,38,62,69,61,72,16,10;19,28,15,20,14,2,11,19,"
    "19,8,4,17,8,25,0,28,22,21,18,5,4,15,26,6,9,5,0,21,17,9,4,0;37,25,139,68,"
    "172,13,165,8,126,43,105,130,161,165,45,138,6,102,26,35,70,127,104,105,"
    "26,158,159,127,172,106,16,50")
# (EpLen mean, reward per step) of the port on the CPU on the same episodes:
# cli.imitation15_vmapped --eval-only --device cpu --frames LANE_FRAMES
# (32 x 300 per lane), and cli.eval_multiskill --device cpu (32 x 300 per
# skill from np.random.RandomState(k) frames)
CPU_LANES = {"walk": (300.0, 0.817), "run": (283.3, 0.506),
             "spinkick": (300.0, 0.448), "backflip": (264.9, 0.326),
             "getup_facedown": (46.0, 0.930)}
CPU_MULTI = {"walk": (271.1, 0.765), "run": (26.9, 0.253),
             "spinkick": (22.7, 0.159)}
LANE_TRAIN_HORIZON = 32      # the tool's 256, cut

# the GAIL path: the bundled r4 run (tools/r4_chain.sh: the recipe with the
# full obs, 64 envs, the GAIL CLI's defaults, a tanh 100x2 policy with a
# learned logstd) and its expert (64 episodes x 300 steps of 68-D obs)
CKPT_GAIL = os.path.join(ROOT, "train_ckpt_gail_r4", "DPEnvV3", "gail-walk-0",
                         "gail_state.npz")
EXPERT = os.path.join(ROOT, "assets", "expert", "walk_expert.npz")
GAIL_FLAGS = ["--expert-path", EXPERT, "--motion", "walk", "--reward-mode",
              "imitation_dm", "--control-mode", "pd_residual", "--reset-mode",
              "rsi", "--n-substeps", "2", "--max-episode-steps", "300",
              "--obs-mode", "full"]
GAIL_TRAIN_HORIZON = 32      # the run's 1024, cut
GAIL_BC_ITERS = 50           # the CLI's BC steps in the smoke (of 10,000)
# the 64 start frames that JAX's runner.evaluate draws from PRNGKey(0)
GAIL_FRAMES = ("9,28,25,11,24,0,27,28,18,29,21,33,11,37,4,35,4,10,5,14,33,26,"
               "8,16,36,0,9,7,10,3,14,34,37,34,18,37,27,17,13,2,1,13,8,7,2,"
               "23,22,12,25,10,29,24,1,5,38,6,27,20,32,1,26,38,31,14")
# (EpLen mean, reward per step) of the port on the CPU on those episodes
# (tests/test_torch_gail.py::test_gail_r4_64_episodes_match_jax, which
# holds them against JAX's runner.evaluate: 299.33, 0.1562)
CPU_GAIL = (298.33, 0.1634)

# the original DeepMimic PPO stack: the bundled r5 run (tools/r5_chain.sh:
# 71-75: --surface deepmimic --motion walk --num-envs 512, resumed; the
# spec of assets/agents/ct_agent_humanoid_ppo.json; relu 1024-512 actor and
# critic on the 197-D surface)
CKPT_DP = os.path.join(ROOT, "train_ckpt_dp_ppo_r5", "deepmimic", "ppo-walk-0",
                       "ppo_params.npz")
DP_ENVS = 512                # the r5 run's --num-envs
DP_HORIZON = 300             # the surface's episode cap
DP_TRAIN_ITERS = 3           # the run's 700, cut
# (reward per step, mean episode length) of the port on the CPU over the
# first 64 of the dp_frames() episodes x 300 steps
# (tests/test_torch_dp_policy.py::test_r5_evaluation_matches_jax, which
# holds it against JAX's on the same episodes: 0.3732, 38.05)
CPU_DP = (0.3732, 38.05)

# [envs]: the other envs, their batch wrappers, the DeepMimic facade and
# the CLIs that reach them
ENV_CVC_ENVS, ENV_CVC_STEPS = 16, 10
ENV_CVC_ATOL = 1e-3   # PERF.md §2's card-vs-CPU bound for the env paths
# seeds of the card-vs-CPU actions, 0.1·N(0, 1); HumanoidTestEnv's is chosen
# so that no root height comes within 1e-3 of 0.8 (closest: 3.1e-3)
ENV_ACTION_SEED = {"DPEnvV1": 1, "DPEnvV2": 1, "HumanoidTestEnv": 3}
# apgd_solve launches per control step: 6 substeps x 4 stage solves; 5 x 4
# and the cold solve of the obs' engine.forward
ENV_LAUNCHES = {"DPEnvV1": 24, "DPEnvV2": 24, "HumanoidTestEnv": 21}
ENV_DONE_AT = {"DPEnvV1": (0.7, 2.0), "DPEnvV2": (0.7, 2.0),
               "HumanoidTestEnv": (0.8, 2.0)}
V2_TRAIN_HORIZON = 16        # at bench.py's 4096 envs; its 64, cut
VECNORM_ENVS, VECNORM_STEPS = 4096, 16
FACADE_UPDATES = 30
# the facade's record_state is held to 1e-3 over the first 12 updates: from
# then on the open-loop walk loses its balance and any two f32 runs part
# (JAX and the port, both on the CPU: 1.0e-3 at update 14, 5.2e-2 at 27)
FACADE_STATE_UPDATES = 12
# the port's CPU figures (both equal to JAX's on the CPU; tests/
# test_torch_envs_v1_v2.py holds the printed lines): cli.torque_test
# --steps 100 and cli.play_mocap --motion spinkick --through-dynamics
# [physics-modes]: the parity modes and the imported models (slice 10).
# Per case: its model, the APGD launches per control step on the card, and
# the 4096-env run's steps
MODE_CASES = ("import", "euler", "cholesky", "pgs")
MODE_LAUNCHES = {"import": {"apgd_solve": 0, "apgd_solve_lanes": 0,
                            "apgd_solve_wide": 4},
                 "euler": {"apgd_solve": 1, "apgd_solve_lanes": 0,
                           "apgd_solve_wide": 0},
                 "cholesky": {"apgd_solve": 4, "apgd_solve_lanes": 0,
                              "apgd_solve_wide": 0},
                 "pgs": {"apgd_solve": 0, "apgd_solve_lanes": 0,
                         "apgd_solve_wide": 0}}
MODE_STEPS = {"import": 32, "euler": 32, "cholesky": 16, "pgs": 8}
# the card-vs-CPU cases of [physics-modes] are those of [envs]
# (env_card_vs_cpu): DPEnvV3's done thresholds, actions from SEED
ENV_ACTION_SEED.update({case: SEED for case in MODE_CASES})
ENV_DONE_AT.update({case: (0.7, 2.0) for case in MODE_CASES})
# [dist] (slice 11): TRPO across ranks
DIST_ENVS = B_MAIN           # bench.py's width, in total over the ranks
DIST_HORIZON = 16            # bench.py's 64, cut
DIST_CVC_ENVS = 16           # per rank: the card-vs-CPU segment update
DIST_EXACT = 1e-6            # NCCL world 1 against one process; replicas
DIST_ONE_PROCESS = 1e-3      # 2 ranks against 1 process on the same segment
# [mocap-ingest] (slice 11)
INGEST_ATOL = 1e-12          # the f64 arrays of the JSON and native loaders
INGEST_STEPS = 32
CPU_TORQUE_TEST = 0.0265
CPU_PLAY_MOCAP = 0.2112


def dp_frames(n: int = DP_ENVS):
    """The RSI start frames of the [dp-ppo] evaluation: ``n`` of the walk
    clip's 39 frames from ``np.random.RandomState(SEED)``."""
    import numpy as np

    return np.random.RandomState(SEED).randint(0, 39, n)


def _problem(torch, B: int, a_dtype, gen, nc: int = NC, nl: int = NL):
    """Well-conditioned dual systems, batch-major (any row order)."""
    dev = "cuda"
    ne = 3 * nc + nl
    m = torch.randn((B, ne, ne), generator=gen, device=dev)
    a = (m @ m.transpose(1, 2)) / ne + 0.5 * torch.eye(ne, device=dev)
    b = torch.randn((B, ne), generator=gen, device=dev)
    mu = 0.5 + torch.rand((B, nc), generator=gen, device=dev)
    f0 = 0.1 * torch.randn((B, ne), generator=gen, device=dev)
    return a.to(a_dtype).contiguous(), b, mu, f0


def _ptxas(log: str) -> dict:
    """Registers, spill bytes and static shared memory of each kernel
    instantiation in nvcc's ``-Xptxas -v`` output, keyed "bf16/slots8" etc.
    (``apgd.cu``) and "wide/bf16/kt4" etc. (``apgd_wide.cu``'s 16-row tile
    counts)."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            dtype = "bf16" if "13__nv_bfloat16" in m.group(1) else "f32"
            w = re.search(r"apgd_wide_kernelI\w+?Li(\d+)ELi\d+E",
                          m.group(1))
            if w:  # one instantiation per count of 16-row tiles
                name = f"wide/{dtype}/kt{w.group(1)}"
            else:
                name = dtype + ("/slots8" if "Lb1E" in m.group(1)
                                else "/general")
            out[name] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name:
            out[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", ln)
            out[name]["static_smem"] = int(m.group(1)) if m else 0
    return out


def _bound(B: int, iters: int, nc: int = NC, nl: int = NL, es: int = 2,
           flops_per_s: float = F32_FLOPS_PER_S):
    """Least time of one solve on an H100 SXM, A of ``es`` bytes an
    element: its bytes (A, b, mu, f0, f each once) over HBM rate against
    its matvec flops over the f32 rate (or ``flops_per_s``: the tensor
    cores' bf16 rate for the wide kernel's design)."""
    ne = 3 * nc + nl
    nbytes = B * ne * ne * es + 4 * B * (3 * ne + nc)
    flops = 2 * B * ne * ne * iters
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def _capture(solver, runner, env, policy, params, state, steps):
    """The dual systems (a, b, mu, f0, iterations) that ``steps`` walk steps
    of the main path hand to the solve dispatch."""
    seen = []
    dispatch = solver.apgd

    def spy(a, b, mu, f0, **kw):
        seen.append((a.clone(), b.clone(), mu.clone(), f0.clone(),
                     kw["iterations"]))
        return dispatch(a, b, mu, f0, **kw)

    solver.apgd = spy
    try:
        runner.rollout(env, policy, params, state, steps)
    finally:
        solver.apgd = dispatch
    return seen


def _wide_shapes(torch):
    """(label, nc, nl, dtype of A, iterations timed) of the [kernel] phase's
    wide-kernel shapes: 16/16 caps (ne 64) and uncapped (ne 139) at the
    warm stage-1 budget of 15 iterations, A in f32 and bf16, then the
    exact-cold configuration's cold solve (ne 64, f32 A, 50 iterations)."""
    out = [(f"ne={3 * nc + nl}", nc, nl, dt, 15) for nc, nl in WIDE
           for dt in (torch.float32, torch.bfloat16)]
    out.append(("exact-cold ne=64", EXACT_COLD["contact_cap"],
                EXACT_COLD["limit_cap"], torch.float32, EXACT_COLD_ITERS))
    return out


def _wide_kernel(torch, ops, timing) -> dict:
    """[kernel] the wide kernel (ne > 32) against the plain version at
    B = 4096 for each shape of ``_wide_shapes`` (8/15/60 iterations and the
    timed count); then its launch plan and its time at the timed count:
    ``ms`` from Python (CUDA events around 50 launches), ``device_ms`` from
    a CUDA graph (also at 0 and 60 iterations: the fixed cost and the cost
    of an iteration); the bound at the f32 rate and at the tensor cores'."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    out = {}
    for label, nc, nl, a_dtype, iters_t in _wide_shapes(torch):
        ne = 3 * nc + nl
        es = 2 if a_dtype is torch.bfloat16 else 4
        dt = str(a_dtype)[6:]
        a, b, mu, f0 = _problem(torch, B_MAIN, a_dtype, gen, nc, nl)
        err = 0.0
        for iters in sorted({8, 15, 60, iters_t}):
            kw = dict(iterations=iters, nc=nc, nl=nl)
            ref = ops._apgd_scan(a, b, mu, f0, **kw)
            got = ops.apgd_solve_wide(a, b, mu, f0, **kw)
            torch.cuda.synchronize()
            e = float((got - ref).abs().max())
            err = max(err, e)
            print(f"[kernel] apgd_solve_wide {label} (nc {nc}, nl {nl}) "
                  f"A={dt} iters={iters}: max_abs_err {e:.3e} (|ref| max "
                  f"{float(ref.abs().max()):.3f}, atol {ATOL})")
            if not e <= ATOL:
                raise AssertionError(f"apgd_solve_wide {label} disagrees "
                                     f"with the plain version: {e}")
        kw = dict(iterations=iters_t, nc=nc, nl=nl)
        ms = timing.eager_ms(
            lambda: ops.apgd_solve_wide(a, b, mu, f0, **kw), 50)
        dev, dev0, dev60 = (timing.graph_ms(
            lambda it=it: ops.apgd_solve_wide(
                a, b, mu, f0, iterations=it, nc=nc, nl=nl), calls=20,
            replays=2) for it in (iters_t, 0, 60))
        per_it_us = 1e3 * (dev60 - dev0) / 60
        plain_ms = timing.eager_ms(
            lambda: ops._apgd_scan(a, b, mu, f0, **kw), 5)
        bound_s, bound_by = _bound(B_MAIN, iters_t, nc, nl, es)
        tc_s, tc_by = _bound(B_MAIN, iters_t, nc, nl, es,
                             BF16_TC_FLOPS_PER_S)
        plan = ops.wide_launch_plan(ne, nc, es == 2, B_MAIN)
        out[f"{label} {dt}"] = {
            "ne": ne, "a": dt, "iterations": iters_t, "max_abs_err": err,
            "ms": ms, "device_ms": dev, "device_ms_0_iterations": dev0,
            "device_ms_60_iterations": dev60, "plain_ms": plain_ms,
            "bound_ms": bound_s * 1e3, "bound_by": bound_by,
            "bound_tc_ms": tc_s * 1e3, "bound_tc_by": tc_by,
            "share_of_bound": bound_s * 1e3 / dev, "plan": plan}
        print(f"[kernel] apgd_solve_wide B={B_MAIN} {label} {dt} "
              f"iters={iters_t}: {ms:.4f} ms (CUDA events over 50 launches "
              f"from Python), device {dev:.4f} ms (CUDA graph; {dev0:.4f} ms "
              f"at 0 iterations, {dev60:.4f} at 60: {per_it_us:.3f} us per "
              f"iteration), plain "
              f"{plain_ms:.4f} ms, bound {bound_s * 1e3:.4f} ms ({bound_by}; "
              f"{tc_s * 1e3:.4f} ms ({tc_by}) at the tensor cores' bf16 "
              f"rate), {100 * bound_s * 1e3 / dev:.1f}% of the bound; plan: "
              f"{plan['tiles']} tiles, {plan['row_tiles_per_warp']} row "
              f"tiles per warp, {plan['warps_per_env']} warps per env, "
              f"{plan['envs_per_block']} envs and {plan['threads']} threads "
              f"per block, {plan['smem']} B shared memory, "
              f"{plan['blocks_per_sm']} blocks resident per SM, grid "
              f"{plan['grid']}; library call: none")
    return out


def _zero_counts(ops) -> None:
    for fn in (ops.apgd_solve, ops.apgd_solve_lanes, ops.apgd_solve_wide):
        fn.launches = 0


def _counts(ops) -> dict:
    return {fn.__name__: fn.launches for fn in (
        ops.apgd_solve, ops.apgd_solve_lanes, ops.apgd_solve_wide)}


@contextlib.contextmanager
def _watch(torch, ops):
    """A counted run of the main path on the card: every kernel's launch
    count set to 0 on entry and read on exit, the plain ``_apgd_scan`` spied
    on (a run on the card must never call it), and the wall time between
    two synchronizations.  Yields a dict holding ``scans`` (one entry per
    plain call) and, after the block, ``launches`` and ``seconds``."""
    plain, rec = ops._apgd_scan, {"scans": []}
    ops._apgd_scan = lambda *a, **kw: rec["scans"].append(1) or plain(*a,
                                                                      **kw)
    try:
        _zero_counts(ops)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield rec
        torch.cuda.synchronize()
        rec["seconds"] = time.perf_counter() - t0
        rec["launches"] = _counts(ops)
    finally:
        ops._apgd_scan = plain


def _larger_caps(torch, ops, steps: int = CAPS_STEPS) -> int:
    """[caps] 16 envs x ``steps`` steps of the humanoid with 16/16 caps
    (ne = 64), uncapped (ne = 139) and in README's exact-cold configuration
    (ne = 64, f32 A), bundled checkpoint: on the card every
    solve goes to the wide kernel (4 per step; ``_apgd_scan`` is not
    called), held against the same rollout on the CPU (plain versions).
    Returns the wide kernel's launches."""
    from deepmimic_mujoco_torch.algos import runner
    from deepmimic_mujoco_torch.envs.dp_env_v3 import DPEnvV3
    from deepmimic_mujoco_torch.io_utils import checkpoint
    from deepmimic_mujoco_torch.models.policy import MlpPolicy
    from deepmimic_mujoco_torch.physics.humanoid import build_humanoid

    idx = torch.arange(16) * 2 % 39
    launches = 0
    for kw, label in ((dict(contact_cap=16, limit_cap=16),
                       "caps 16/16, ne 64"),
                      (dict(contact_cap=1 << 30, limit_cap=1 << 30),
                       "uncapped, ne 139"),
                      (EXACT_COLD, "exact-cold (f32 A, cold 50-iteration "
                                   "stage 1), ne 64")):
        out = {}
        for dev in ("cuda", "cpu"):
            env = DPEnvV3(model=build_humanoid(**kw, device=dev))
            policy = MlpPolicy(ob_dim=56, ac_dim=28)
            params = checkpoint.load_trpo_params(CKPT, policy, dev)
            state = env.reset_at(idx)
            if dev == "cpu":
                out[dev] = runner.rollout(env, policy, params, state, steps)
                continue
            with _watch(torch, ops) as w:
                out[dev] = runner.rollout(env, policy, params, state, steps)
            n, scans = w["launches"], w["scans"]
            want = {"apgd_solve": 0, "apgd_solve_lanes": 0,
                    "apgd_solve_wide": 4 * steps}
            if n != want or scans:
                raise AssertionError(f"{label}: launches {n}, expected "
                                     f"{want}; _apgd_scan called "
                                     f"{len(scans)} times")
            launches += n["apgd_solve_wide"]
        d_q = float((out["cuda"].state.qpos.cpu()
                     - out["cpu"].state.qpos).abs().max())
        same_len = bool((out["cuda"].ep_len.cpu() == out["cpu"].ep_len).all())
        print(f"[caps] {label}: 16 envs x {steps} steps, card vs CPU: qpos "
              f"max_abs_diff {d_q:.3e} (atol {ROLLOUT_ATOL}), ep_len equal "
              f"{same_len}; on the card {4 * steps} apgd_solve_wide launches, "
              "no other APGD launch, _apgd_scan not called")
        if not (d_q <= ROLLOUT_ATOL and same_len):
            raise AssertionError(f"{label}: the card's rollout disagrees "
                                 "with the CPU's")
    return launches


def _timed(fn, acc: dict, key: str):
    """``fn`` with its wall time (between two synchronizations) added to
    ``acc[key]``."""
    import torch

    def run(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        acc[key] += time.perf_counter() - t0
        return out
    return run


def _train(torch, ops, n_envs: int, kind: str = "walk",
           horizon: int | None = None, warm_up: bool = False) -> dict:
    """[train] ``TRPO.iteration`` at ``n_envs`` envs x ``horizon`` steps
    (64 by default: bench.py's configuration), g_step 1, from random
    params: one timed iteration (after a warm-up one with ``warm_up``: the
    first training run of the process), with the launch counts set to 0
    just before it and read just after; the plain ``_apgd_scan`` must not
    be called.  Phase times are wall time between synchronizations
    around the rollout, the policy update (gradient, CG, line search) and
    the vf epochs.  ``kind`` "recipe": [imitation], the same on the
    imitation recipe's env, policy and flags at 32 steps (8 APGD launches
    per control step: 2 substeps of 4 stage solves); "v2": [envs],
    ``DPEnvV2`` (dt 0.002, 6 substeps: 24 launches per control step) with
    the CLI's default 100x2 tanh policy at 16 steps."""
    from collections import deque

    from deepmimic_mujoco_torch.algos.trpo import TRPO, TRPOConfig
    from deepmimic_mujoco_torch.envs.dp_env_v2 import DPEnvV2
    from deepmimic_mujoco_torch.envs.dp_env_v3 import DPEnvV3
    from deepmimic_mujoco_torch.models.policy import MlpPolicy
    from deepmimic_mujoco_torch.physics.humanoid import build_humanoid

    if kind == "recipe":
        tag, horizon, per_step = "[imitation]", IMIT_TRAIN_HORIZON, 8
        learner = TRPO(DPEnvV3(model=build_humanoid(device="cuda"),
                               **RECIPE_ENV),
                       MlpPolicy(**RECIPE_POLICY),
                       TRPOConfig(horizon=horizon, num_envs=n_envs, g_step=1,
                                  gamma=0.95, lam=0.95, reset_mode="rsi"))
    elif kind == "v2":
        tag, horizon, per_step = "[envs] DPEnvV2", V2_TRAIN_HORIZON, 24
        learner = TRPO(DPEnvV2(device="cuda"), MlpPolicy(ob_dim=67, ac_dim=28),
                       TRPOConfig(horizon=horizon, num_envs=n_envs, g_step=1))
    else:
        tag, horizon, per_step = "[train]", horizon or TRAIN_HORIZON, 4
        learner = TRPO(DPEnvV3(model=build_humanoid(device="cuda")),
                       MlpPolicy(ob_dim=56, ac_dim=28),
                       TRPOConfig(horizon=horizon, num_envs=n_envs,
                                  g_step=1))
    phase = {"rollout": 0.0, "policy update": 0.0, "vf epochs": 0.0}
    learner._rollout = _timed(learner._rollout, phase, "rollout")
    learner._policy_update = _timed(learner._policy_update, phase,
                                    "policy update")
    learner._vf_update = _timed(learner._vf_update, phase, "vf epochs")
    state = learner.init(torch.Generator(device="cuda").manual_seed(SEED))
    lens: deque = deque(maxlen=40)

    def iterate(state):
        state, stats = learner.iteration(state)
        ended = stats.ep_lens.reshape(-1)
        lens.extend(int(x) for x in ended[ended > 0].cpu())
        return state, stats

    if warm_up:
        state, _ = iterate(state)
        for k in phase:
            phase[k] = 0.0
    with _watch(torch, ops) as w:
        state, stats = iterate(state)
    dt, n, scans = w["seconds"], w["launches"], w["scans"]
    rec = {k: float(getattr(stats, k)) for k in (
        "meankl", "surrgain", "ev_tdlam_before", "optimgain", "entropy")}
    rec["EpLenMean"] = sum(lens) / len(lens) if lens else float("nan")
    rec.update(env_steps_per_s=n_envs * horizon / dt, iteration_s=dt,
               phase_s=dict(phase),
               apgd_launches_per_env_step=n["apgd_solve"] / horizon,
               launches=n)
    env = learner.env
    rec["env"] = {k: getattr(env, k, None) for k in (
        "reward_mode", "control_mode", "n_substeps", "pd_target_interp",
        "obs_mode", "include_phase", "termination", "max_episode_steps",
        "observation_size")}
    rec["env"]["dt"] = env.model.dt
    rec["apgd_scan_calls"] = len(scans)
    print(f"{tag} TRPO.iteration {n_envs} envs x {horizon} steps, "
          f"g_step 1, " + ("1 timed after 1 warm-up" if warm_up else
                           "1 iteration") + ": "
          f"{rec['env_steps_per_s']:.1f} env-steps/s, "
          f"{rec['iteration_s']:.3f} s per iteration ("
          + ", ".join(f"{k} {v:.3f} s" for k, v in rec["phase_s"].items())
          + f"); APGD launches per env step "
          f"{rec['apgd_launches_per_env_step']:.2f} ({n}), _apgd_scan "
          f"called {len(scans)} times; meankl "
          f"{rec['meankl']:.5f}, surrgain {rec['surrgain']:.5f}, "
          f"ev_tdlam_before {rec['ev_tdlam_before']:.4f}, EpLenMean "
          f"{rec['EpLenMean']:.2f}")
    # EpLenMean is NaN only when no episode ended in the iterations run
    finite = all(v == v and abs(v) != float("inf") for k, v in rec.items()
                 if k in ("meankl", "surrgain", "ev_tdlam_before",
                          "optimgain", "entropy")
                 or (k == "EpLenMean" and lens))
    if not (finite and rec["meankl"] <= 1.5 * MAX_KL):
        raise AssertionError(f"{tag} {n_envs} envs: stats {rec}")
    if n != {"apgd_solve": per_step * horizon, "apgd_solve_lanes": 0,
             "apgd_solve_wide": 0} or scans:
        raise AssertionError(f"{tag} {n_envs} envs: APGD launches {n}, "
                             f"expected {per_step} per env step "
                             f"({per_step * horizon}); _apgd_scan "
                             f"{len(scans)}")
    return rec


def _segment_card_vs_cpu(torch) -> dict:
    """[train] one ``_segment_update`` on the card against the CPU, from the
    same 16-env x 32-step segment (a rollout on the card), permutations and
    params; TF32 is off (PyTorch's default for matmul)."""
    from deepmimic_mujoco_torch.algos import adam
    from deepmimic_mujoco_torch.algos.trpo import (TRPO, Draws, TRPOConfig,
                                                   flatten, policy_leaves,
                                                   vf_leaves)
    from deepmimic_mujoco_torch.envs.dp_env_v3 import DPEnvV3
    from deepmimic_mujoco_torch.models.policy import MlpPolicy
    from deepmimic_mujoco_torch.physics.humanoid import build_humanoid

    B, T = 16, 32
    gen = torch.Generator().manual_seed(SEED)
    policy = MlpPolicy(ob_dim=56, ac_dim=28)
    params_cpu = policy.init(gen, "cpu")
    perms = torch.stack([torch.randperm(B * T, generator=gen)
                         for _ in range(3)])

    class FixedPerms(Draws):
        def vf_permutations(self, n, epochs, device):
            return perms.to(device)

    res = {}
    for dev in ("cuda", "cpu"):
        learner = TRPO(DPEnvV3(model=build_humanoid(device=dev)), policy,
                       TRPOConfig(horizon=T, num_envs=B))
        params = {
            "pol": [{k: x.to(dev) for k, x in layer.items()}
                    for layer in params_cpu["pol"]],
            "vf": [{k: x.to(dev) for k, x in layer.items()}
                   for layer in params_cpu["vf"]],
            "logstd": params_cpu["logstd"].to(dev),
            "ob_rms": type(params_cpu["ob_rms"])(
                *(x.to(dev) for x in params_cpu["ob_rms"]))}
        if dev == "cuda":
            g = torch.Generator(device="cuda").manual_seed(SEED)
            seg = learner._rollout(
                params, learner.env.reset(g, B),
                torch.ones(B, dtype=torch.bool, device="cuda"), Draws(g),
                torch.zeros(B, device="cuda"),
                torch.zeros(B, dtype=torch.int32, device="cuda"))[0]
        n_vf = sum(x.numel() for x in vf_leaves(params))
        out = learner._segment_update(
            params, adam.init(n_vf, dev),
            {k: v.to(dev) for k, v in seg.items()}, FixedPerms(None))
        res[dev] = tuple(x.cpu() if isinstance(x, torch.Tensor) else x
                         for x in out[:4]) + (out[4],)

    def rel(a, b):
        return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))

    (pc, ac, lc, ec, ic), (pp, ap, lp, ep, ip) = res["cuda"], res["cpu"]
    d = {"pol": rel(flatten(policy_leaves(pc)).cpu(),
                    flatten(policy_leaves(pp))),
         "vf": rel(flatten(vf_leaves(pc)).cpu(), flatten(vf_leaves(pp))),
         "ob_rms": max(rel(x.cpu(), y) for x, y in zip(pc["ob_rms"],
                                                       pp["ob_rms"])),
         "adam_m": rel(ac.m.cpu(), ap.m), "losses": rel(lc, lp),
         "ev": rel(ec, ep)}
    bounds = {"pol": 1e-4, "vf": 1e-3, "ob_rms": 1e-5, "adam_m": 1e-3,
              "losses": 1e-4, "ev": 1e-4}
    print(f"[train] one _segment_update from a {B}-env x {T}-step segment, "
          f"card vs CPU: max diff / max(1, max|x|): " + ", ".join(
              f"{k} {v:.3e} (bound {bounds[k]:.0e})" for k, v in d.items())
          + f"; step size {ic.stepsize} / {ip.stepsize}, accepted "
          f"{ic.accepted} / {ip.accepted}")
    if not (all(d[k] <= bounds[k] for k in d)
            and (ic.stepsize, ic.accepted) == (ip.stepsize, ip.accepted)):
        raise AssertionError("[train] the card's segment update disagrees "
                             "with the CPU's")
    return d


def _train_cli(recipe: bool = False) -> None:
    """[train] ``cli.train_trpo --task train --num-iters 1`` in-process at
    64 envs (64 steps, g_step 1) into a temporary directory; the checkpoint
    it writes reads back through ``load_trpo_params``.  ``recipe``:
    [imitation], the imitation recipe's flags at 32 steps."""
    import tempfile

    import torch

    from deepmimic_mujoco_torch.cli import train_trpo
    from deepmimic_mujoco_torch.io_utils import checkpoint
    from deepmimic_mujoco_torch.models.policy import MlpPolicy

    if recipe:
        tag, horizon = "[imitation]", IMIT_TRAIN_HORIZON
        flags, policy = RECIPE_FLAGS + RECIPE_TRAIN_FLAGS, MlpPolicy(
            **RECIPE_POLICY)
    else:
        tag, horizon = "[train]", TRAIN_HORIZON
        flags, policy = [], MlpPolicy(56, 28)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        _quiet(train_trpo.main, [
            "--task", "train", "--num-iters", "1", "--num-envs", "64",
            "--timesteps-per-batch", str(horizon), "--g-step", "1",
            "--seed", str(SEED), *flags, "--log-dir",
            os.path.join(tmp, "logs"), "--checkpoint-dir",
            os.path.join(tmp, "ckpt")])
        dt = time.perf_counter() - t0
        run = os.path.join("DPEnvV3", "trpo-walk-0")
        with open(os.path.join(tmp, "logs", run, "progress.csv")) as fh:
            rows = fh.read().strip().splitlines()
        path = os.path.join(tmp, "ckpt", run, "trpo_state.npz")
        params = checkpoint.load_trpo_params(path, policy, "cuda")
        finite = all(bool(torch.isfinite(x).all()) for x in
                     [params["logstd"]] + [layer["w"] for layer in
                                           params["pol"] + params["vf"]])
        last = dict(zip(rows[0].split(","), rows[-1].split(",")))
        print(f"{tag} CLI --task train --num-iters 1 at 64 envs x {horizon} "
              f"steps, in-process: {dt:.1f} s, {len(rows) - 1} progress "
              f"rows, last meankl {last['meankl']} EpLenMean "
              f"{last['EpLenMean']}; its checkpoint reads back through "
              f"load_trpo_params, finite {finite}")
        if len(rows) != 2 or not finite:
            raise AssertionError(f"{tag} the CLI's log or checkpoint is off")


def _imitation_eval(torch, ops, train_trpo) -> dict:
    """[imitation] ``cli.train_trpo --task evaluate`` of walk_r2 with the
    recipe's flags: 4096 RSI episodes x 300 steps, deterministic, the
    launch counts set to 0 just before and read just after; the plain
    ``_apgd_scan`` must not be called on the card."""
    with _watch(torch, ops) as w:
        res = train_trpo.main([
            "--task", "evaluate", "--load-model-path", CKPT_R2,
            "--eval-episodes", str(B_MAIN), "--eval-horizon",
            str(IMIT_HORIZON), *RECIPE_FLAGS, "--device", "cuda",
            "--seed", str(SEED)])
    dt, n, scans = w["seconds"], w["launches"], w["scans"]
    lens = res.rollout.ep_len.double()
    rec = {"ep_len_mean": float(lens.mean()),
           "ep_len_median": float(lens.quantile(0.5)),
           "reward_per_step": res.avg_ret / res.avg_len,
           "env_steps_per_s": B_MAIN * IMIT_HORIZON / dt, "seconds": dt,
           "apgd_launches_per_control_step": {
               "blocks": n["apgd_solve"] / IMIT_HORIZON,
               "wide": n["apgd_solve_wide"] / IMIT_HORIZON},
           "apgd_scan_calls": len(scans), "launches": n}
    st = res.rollout.state
    finite = all(bool(torch.isfinite(x).all())
                 for x in (st.qpos, st.qvel, st.obs))
    print(f"[imitation] evaluate walk_r2, {B_MAIN} RSI episodes x "
          f"{IMIT_HORIZON} steps, deterministic: EpLen mean "
          f"{rec['ep_len_mean']:.2f} median {rec['ep_len_median']:.0f}, "
          f"reward per step {rec['reward_per_step']:.4f} (the port on the "
          f"CPU: {CPU_REWARD_PER_STEP}), {dt:.2f} s, "
          f"{rec['env_steps_per_s']:.1f} env-steps/s; APGD launches per "
          f"control step: blocks "
          f"{rec['apgd_launches_per_control_step']['blocks']:.2f}, wide "
          f"{rec['apgd_launches_per_control_step']['wide']:.2f}; "
          f"_apgd_scan called {len(scans)} times; finite {finite}")
    if not (finite and rec["ep_len_mean"] >= 0.95 * IMIT_HORIZON
            and abs(rec["reward_per_step"] - CPU_REWARD_PER_STEP) <= 0.03):
        raise AssertionError(f"[imitation] evaluation off: {rec}")
    if n != {"apgd_solve": 8 * IMIT_HORIZON, "apgd_solve_lanes": 0,
             "apgd_solve_wide": 0} or scans:
        raise AssertionError(f"[imitation] APGD launches {n}, expected 8 "
                             f"per control step; _apgd_scan {len(scans)}")
    return rec


def _imitation_card_vs_cpu(torch) -> dict:
    """[imitation] 16 envs x 20 steps of the recipe env from fixed mocap
    frames through walk_r2, on the card (kernel) and on the CPU (plain)."""
    from deepmimic_mujoco_torch.algos import runner
    from deepmimic_mujoco_torch.envs.dp_env_v3 import DPEnvV3
    from deepmimic_mujoco_torch.io_utils import checkpoint
    from deepmimic_mujoco_torch.models.policy import MlpPolicy
    from deepmimic_mujoco_torch.physics.humanoid import build_humanoid

    idx = torch.arange(16) * 5 % 39
    out = {}
    for dev in ("cuda", "cpu"):
        env = DPEnvV3(model=build_humanoid(device=dev), **RECIPE_ENV)
        policy = MlpPolicy(**RECIPE_POLICY)
        params = checkpoint.load_trpo_params(CKPT_R2, policy, dev)
        out[dev] = runner.rollout(env, policy, params, env.reset_at(idx), 20,
                                  record=True)
    c, p = out["cuda"], out["cpu"]
    d = {"qpos": float((c.state.qpos.cpu() - p.state.qpos).abs().max()),
         "obs": float((c.traj[0].cpu() - p.traj[0]).abs().max()),
         "reward": float((c.traj[2].cpu() - p.traj[2]).abs().max())}
    same_done = bool((c.ep_len.cpu() == p.ep_len).all()
                     and (c.state.done.cpu() == p.state.done).all())
    print(f"[imitation] 16 envs x 20 steps of the recipe, card vs CPU: qpos "
          f"max_abs_diff {d['qpos']:.3e} (atol {ROLLOUT_ATOL}), obs "
          f"{d['obs']:.3e}, reward {d['reward']:.3e} (atol {ROLLOUT_ATOL}); "
          f"done flags and episode lengths equal {same_done}")
    if not (d["qpos"] <= ROLLOUT_ATOL and d["reward"] <= ROLLOUT_ATOL
            and same_done):
        raise AssertionError("[imitation] the card's recipe rollout "
                             "disagrees with the CPU's")
    d["done_equal"] = same_done
    return d


# ---------------------------------------------------------------------------
# the multi-clip path: DPEnvV3Multi, eval_multiskill, the TRPO lanes


def _multi_card_vs_cpu(torch, ops) -> dict:
    """[multi] 16 envs of ``DPEnvV3Multi`` spread over the five headline
    clips (the 15-clip env of the lane tool, mocap joint limits), 20 steps
    of the same seeded actions on the card (kernel) and on the CPU (plain
    version): qpos, obs and rewards within 1e-4 at every step, equal done
    flags; 8 ``apgd_solve`` launches per control step on the card."""
    from deepmimic_mujoco_torch.envs.multi_clip import DPEnvV3Multi
    from deepmimic_mujoco_torch.physics.humanoid import mocap_hinge_range

    names = CLIPS15.split(",")
    lane_ids = torch.tensor([names.index(c) for c in LANE_CLIPS.split(",")])
    cid = lane_ids[torch.arange(16) % 5]
    acts = 0.1 * torch.randn((20, 16, 28),
                             generator=torch.Generator().manual_seed(SEED))
    out, n = {}, None
    for dev in ("cuda", "cpu"):
        env = DPEnvV3Multi(clips=names, model=mocap_hinge_range(device=dev),
                           control_mode="pd_residual", n_substeps=2,
                           max_episode_steps=300, reward_mode="imitation_dm",
                           obs_mode="full", termination="fall_contact")
        frames = (torch.arange(16) * 7) % env.clip_lens.cpu()[cid]
        s = env.reset_at(cid, frames)
        if dev == "cuda":
            _zero_counts(ops)
        rec = []
        for a in acts:
            s = env.step(s, a.to(dev))
            rec.append([x.cpu() for x in (s.qpos, s.obs, s.reward, s.done)])
        if dev == "cuda":
            torch.cuda.synchronize()
            n = _counts(ops)
        out[dev] = rec
    d = {k: max(float((c[i] - p[i]).abs().max())
                for c, p in zip(out["cuda"], out["cpu"]))
         for i, k in enumerate(("qpos", "obs", "reward"))}
    same_done = all(bool(torch.equal(c[3], p[3]))
                    for c, p in zip(out["cuda"], out["cpu"]))
    print(f"[multi] DPEnvV3Multi, 16 envs over {LANE_CLIPS} x 20 steps "
          f"(mocap joint limits), card vs CPU: max_abs_diff qpos "
          f"{d['qpos']:.3e}, obs {d['obs']:.3e}, reward {d['reward']:.3e} "
          f"(atol 1e-4); done flags equal at every step {same_done}; "
          f"launches on the card {n}")
    if not (max(d.values()) <= 1e-4 and same_done):
        raise AssertionError("[multi] the card's DPEnvV3Multi disagrees with "
                             "the CPU's")
    if n != {"apgd_solve": 8 * 20, "apgd_solve_lanes": 0,
             "apgd_solve_wide": 0}:
        raise AssertionError(f"[multi] APGD launches {n}")
    d.update(done_equal=same_done, launches=n)
    return d


def _multi_eval(torch, ops) -> dict:
    """[multi] ``cli.eval_multiskill`` of multiskill_r4 on the card:
    walk, run, spinkick (xml joint limits), 32 deterministic episodes x 300
    steps per skill in one batch; per skill EpLen and reward per step,
    within 5% / 0.03 of the port's CPU figures; 8 ``apgd_solve`` launches
    per control step."""
    from deepmimic_mujoco_torch.cli import eval_multiskill

    _zero_counts(ops)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = eval_multiskill.main(["--ckpt", CKPT_MULTI, "--motions",
                              MULTI_SKILLS, "--episodes", "32", "--horizon",
                              str(IMIT_HORIZON), "--device", "cuda"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = _counts(ops)
    skills = {}
    for k, name in enumerate(MULTI_SKILLS.split(",")):
        skills[name] = (float(r["len_mean"][k]),
                        float(r["reward_per_step"][k]))
    rec = {"skills": skills, "seconds": dt,
           "env_steps_per_s": 96 * IMIT_HORIZON / dt,
           "apgd_launches_per_control_step": n["apgd_solve"] / IMIT_HORIZON,
           "launches": n}
    print(f"[multi] eval_multiskill multiskill_r4, 3 skills x 32 episodes x "
          f"{IMIT_HORIZON} steps in one batch: " + "; ".join(
              f"{k} EpLen {v[0]:.1f} reward per step {v[1]:.4f} (CPU "
              f"{CPU_MULTI[k][0]} / {CPU_MULTI[k][1]})"
              for k, v in skills.items())
          + f"; {dt:.2f} s, {rec['env_steps_per_s']:.1f} env-steps/s; APGD "
          f"launches per control step {rec['apgd_launches_per_control_step']:.2f}"
          f" ({n})")
    for k, (eplen, rps) in skills.items():
        c_len, c_rps = CPU_MULTI[k]
        if not (abs(rps - c_rps) <= 0.03 and abs(eplen - c_len)
                <= 0.05 * c_len):
            raise AssertionError(f"[multi] {k}: EpLen {eplen}, reward per "
                                 f"step {rps}; CPU {c_len}, {c_rps}")
    if n != {"apgd_solve": 8 * IMIT_HORIZON, "apgd_solve_lanes": 0,
             "apgd_solve_wide": 0}:
        raise AssertionError(f"[multi] APGD launches {n}")
    return rec


def _lane_args(extra: list):
    from deepmimic_mujoco_torch.cli import imitation15_vmapped

    return imitation15_vmapped.build_parser().parse_args(
        ["--device", "cuda", "--seed", str(SEED)] + extra)


def _lane_eval(torch, ops, tmp: str) -> dict:
    """[trpo-lanes] ``cli.imitation15_vmapped --eval-only`` of imit5_r5b on
    the card, the tool's configuration: 5 lanes x 32 episodes x 300 steps
    from the frames JAX's tool draws, all lanes in one batch; per lane
    EpLen, reward per step (within 0.03 of the port's CPU figure, EpLen
    within 5%) and pose error; 8.00 ``apgd_solve`` launches per control
    step for the whole lane batch and no wide launch."""
    from deepmimic_mujoco_torch.cli import imitation15_vmapped

    _zero_counts(ops)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = imitation15_vmapped.main([
        "--eval-only", "--device", "cuda", "--clips", LANE_CLIPS,
        "--env-clips", CLIPS15, "--envs", "160", "--resume", CKPT_LANES,
        "--eval-episodes", "32", "--eval-horizon", str(IMIT_HORIZON),
        "--frames", LANE_FRAMES, "--out", os.path.join(tmp, "lanes.json"),
        "--ckpt-root", os.path.join(tmp, "ckpt"), "--log-root",
        os.path.join(tmp, "logs")])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = _counts(ops)
    ev = res["eval"]
    lens = ev.ep_len.double().cpu()
    rps = (ev.rew_sum.double().cpu().mean(1)
           / torch.clamp(lens.mean(1), min=1.0))
    lanes_ = {c: {"ep_len_mean": float(lens[k].mean()),
                  "reward_per_step": float(rps[k]),
                  "pose_err_rad": float(ev.pose_err[k])}
              for k, c in enumerate(LANE_CLIPS.split(","))}
    per_step = n["apgd_solve"] / IMIT_HORIZON
    rec = {"lanes": lanes_, "seconds": dt,
           "env_steps_per_s": 160 * IMIT_HORIZON / dt,
           "apgd_launches_per_control_step": per_step,
           "wide_launches": n["apgd_solve_wide"], "launches": n}
    print(f"[trpo-lanes] evaluate imit5_r5b, 5 lanes x 32 episodes x "
          f"{IMIT_HORIZON} steps (frames of JAX's tool, PRNGKey(11)), one "
          f"batch of 160 envs: " + "; ".join(
              f"{c} EpLen {v['ep_len_mean']:.1f} reward per step "
              f"{v['reward_per_step']:.4f} pose err {v['pose_err_rad']:.3f} "
              f"rad (CPU {CPU_LANES[c][0]} / {CPU_LANES[c][1]})"
              for c, v in lanes_.items())
          + f"; {dt:.2f} s, {rec['env_steps_per_s']:.1f} env-steps/s; "
          f"apgd_solve launches per control step {per_step:.2f} for the "
          f"whole lane batch, wide {n['apgd_solve_wide']}")
    for c, v in lanes_.items():
        c_len, c_rps = CPU_LANES[c]
        if not (abs(v["reward_per_step"] - c_rps) <= 0.03
                and abs(v["ep_len_mean"] - c_len) <= 0.05 * c_len):
            raise AssertionError(f"[trpo-lanes] lane {c}: {v}; CPU "
                                 f"{CPU_LANES[c]}")
    if n != {"apgd_solve": 8 * IMIT_HORIZON, "apgd_solve_lanes": 0,
             "apgd_solve_wide": 0}:
        raise AssertionError(f"[trpo-lanes] APGD launches {n}, expected "
                             f"8 per control step for the lane batch")
    return rec


def _lane_train(torch, ops, resumed: bool) -> dict:
    """[trpo-lanes] ``LaneTRPO.iteration`` of the lane tool's learner on
    the card.  ``resumed``: the run's own 5 lanes x 160 envs resumed from
    imit5_r5b, one warm-up and one timed iteration; else 15 fresh lanes x
    64 envs (the tool's default width), one iteration.  Horizon cut to 32
    (the tool's 256) and g_step to 1 (3).  env-steps/s summed over lanes,
    the phase times, per-lane meankl (finite, ≤ 1.5·max_kl), every
    parameter finite, 8 ``apgd_solve`` launches per control step."""
    from deepmimic_mujoco_torch.algos import lanes
    from deepmimic_mujoco_torch.cli import imitation15_vmapped as tool

    cut = ["--horizon", str(LANE_TRAIN_HORIZON), "--g-step", "1"]
    if resumed:
        tag, args = "resumed imit5_r5b", _lane_args(cut + [
            "--clips", LANE_CLIPS, "--env-clips", CLIPS15, "--envs", "160",
            "--resume", CKPT_LANES])
    else:
        tag, args = "fresh", _lane_args(cut)
    env, policy, learner, lane_ids = tool.build(args, "cuda")
    state = tool.initial_state(args, learner, lane_ids, "cuda")
    phase = {"rollout": 0.0, "policy update": 0.0, "vf epochs": 0.0}
    learner._rollout = _timed(learner._rollout, phase, "rollout")
    learner._policy_update = _timed(learner._policy_update, phase,
                                    "policy update")
    learner._vf_update = _timed(learner._vf_update, phase, "vf epochs")
    if resumed:
        state, _ = learner.iteration(state)  # warm-up
        for k in phase:
            phase[k] = 0.0
    _zero_counts(ops)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, stats = learner.iteration(state)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = _counts(ops)
    L, E, T = learner.lanes, args.envs, LANE_TRAIN_HORIZON
    kl = [float(x) for x in stats.meankl.cpu()]
    flat = lanes.flatten(
        [x for head in ("pol", "vf") for layer in state.params[head]
         for x in layer.values()] + [state.params["logstd"]])
    finite = bool(torch.isfinite(flat).all()) and not lanes.nonfinite_lanes(
        stats)
    rec = {"lanes": L, "envs_per_lane": E, "horizon": T,
           "env_steps_per_s": L * E * T / dt, "iteration_s": dt,
           "phase_s": dict(phase), "meankl": kl, "finite": finite,
           "apgd_launches_per_control_step": n["apgd_solve"] / T,
           "launches": n}
    print(f"[trpo-lanes] LaneTRPO.iteration {tag}: {L} lanes x {E} envs x "
          f"{T} steps (horizon cut from 256), g_step 1 (cut from 3)"
          + (", 1 timed after 1 warm-up" if resumed else ", 1 iteration")
          + f": {rec['env_steps_per_s']:.1f} env-steps/s summed over lanes, "
          f"{dt:.3f} s (" + ", ".join(f"{k} {v:.3f} s"
                                      for k, v in phase.items())
          + f"); meankl per lane {[round(x, 5) for x in kl]}; every "
          f"parameter finite {finite}; APGD launches per control step "
          f"{rec['apgd_launches_per_control_step']:.2f} ({n})")
    if not (finite and all(0 <= x <= 1.5 * MAX_KL for x in kl)):
        raise AssertionError(f"[trpo-lanes] {tag}: meankl {kl}, finite "
                             f"{finite}")
    if n != {"apgd_solve": 8 * T, "apgd_solve_lanes": 0,
             "apgd_solve_wide": 0}:
        raise AssertionError(f"[trpo-lanes] {tag}: APGD launches {n}")
    return rec


def _lane_segment_card_vs_cpu(torch) -> dict:
    """[trpo-lanes] one lane-batched ``_segment_update`` of 3 lanes of the
    tool's learner (relu 1024-512, the 15-clip env) on the card and on the
    CPU, from the same 16-env x 32-step segment per lane (a rollout on the
    card), params and vf permutations: the same step sizes and acceptance
    per lane; within max(1, max|x|) times: the policy 1e-4, the losses and
    the explained variance 1e-4, the value function's predictions on the
    segment 1e-3, and its parameters 1e-2.  The last is looser: Adam moves
    a parameter by about its step size (1e-3) whatever the gradient's
    size, so a gradient at rounding level whose sign differs between the
    devices moves that parameter apart by up to 2e-3 per minibatch step (12
    of them here)."""
    from deepmimic_mujoco_torch.algos import adam, lanes, trpo
    from deepmimic_mujoco_torch.cli import imitation15_vmapped as tool

    args = _lane_args(["--clips", "walk,spinkick,backflip", "--env-clips",
                       CLIPS15, "--envs", "16", "--horizon", "32"])
    L, n = 3, 16 * 32
    perms = torch.stack([torch.stack([torch.randperm(
        n, generator=torch.Generator().manual_seed(10 * k + e))
        for e in range(3)]) for k in range(L)])

    class FixedPerms(trpo.Draws):
        def __init__(self, k):
            super().__init__(None)
            self.k = k

        def vf_permutations(self, n, epochs, device):
            return perms[self.k].to(device)

    out, seg, p_ref = {}, None, None
    for dev in ("cuda", "cpu"):
        env, policy, learner, lane_ids = tool.build(args, dev)
        st = tool.initial_state(args, learner, lane_ids, dev)
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
        vpred = policy.value(res[0], lanes.lane_rows(seg["ob"].to(dev), L))
        out[dev] = (lanes.flatten(trpo.policy_leaves(res[0])).cpu(),
                    lanes.flatten(trpo.vf_leaves(res[0])).cpu(),
                    res[2].cpu(), res[3].cpu(), res[4], vpred.cpu())

    def rel(a, b):
        return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))

    (pc, vc, lc, ec, ic, vpc), (pp, vp, lp, ep, ip, vpp) = (out["cuda"],
                                                           out["cpu"])
    d = {"pol": rel(pc, pp), "losses": rel(lc, lp), "ev": rel(ec, ep),
         "vf_pred": rel(vpc, vpp), "vf": rel(vc, vp)}
    bounds = {"pol": 1e-4, "losses": 1e-4, "ev": 1e-4, "vf_pred": 1e-3,
              "vf": 1e-2}
    same = (torch.equal(ic.stepsize.cpu(), ip.stepsize)
            and torch.equal(ic.accepted.cpu(), ip.accepted))
    print(f"[trpo-lanes] one lane-batched _segment_update, 3 lanes x 16 envs "
          f"x 32 steps, relu 1024-512, card vs CPU: max diff / max(1, "
          f"max|x|): " + ", ".join(f"{k} {v:.3e} (bound {bounds[k]:.0e})"
                                   for k, v in d.items())
          + f"; step sizes {ic.stepsize.tolist()} / {ip.stepsize.tolist()}, "
          f"accepted {ic.accepted.tolist()} / {ip.accepted.tolist()}")
    if not (same and all(d[k] <= bounds[k] for k in d)):
        raise AssertionError("[trpo-lanes] the card's lane segment update "
                             "disagrees with the CPU's")
    return d


# ---------------------------------------------------------------------------
# GAIL (the bundled r4 run) and vectorized PPO


def _gail_learner(n_envs: int, horizon: int, device: str = "cuda",
                  d_step: int = 1):
    """The r4 run's learner (``tools/r4_chain.sh``: the recipe env with the
    full obs, a tanh 100x2 policy with a learned logstd, the GAIL CLI's
    defaults of g_step 3 and d_step 1, RSI resets) at ``n_envs`` envs and
    ``horizon`` steps, with the bundled expert."""
    from deepmimic_mujoco_torch.algos.dataset import MujocoDset
    from deepmimic_mujoco_torch.algos.gail import GAIL, GAILConfig
    from deepmimic_mujoco_torch.algos.trpo import TRPOConfig
    from deepmimic_mujoco_torch.envs.dp_env_v3 import DPEnvV3
    from deepmimic_mujoco_torch.models.policy import MlpPolicy
    from deepmimic_mujoco_torch.physics.humanoid import build_humanoid

    dset = MujocoDset(EXPERT)
    env = DPEnvV3(model=build_humanoid(device=device), **RECIPE_ENV)
    return GAIL(env, MlpPolicy(ob_dim=68, ac_dim=28), dset.obs, dset.acs,
                GAILConfig(trpo=TRPOConfig(horizon=horizon, num_envs=n_envs,
                                           reset_mode="rsi"),
                           d_step=d_step))


def _gail_eval(torch, ops) -> dict:
    """[gail] gail_r4's policy read by ``load_gail_state``: 64 RSI
    episodes x 300 steps from ``GAIL_FRAMES``, deterministic, through the
    runner; the launch counts set to 0 just before and read just after."""
    from deepmimic_mujoco_torch.algos import runner
    from deepmimic_mujoco_torch.algos.trpo import Draws
    from deepmimic_mujoco_torch.io_utils import checkpoint

    learner = _gail_learner(64, GAIL_TRAIN_HORIZON)
    state = checkpoint.load_gail_state(CKPT_GAIL, learner, Draws(
        torch.Generator(device="cuda").manual_seed(SEED)))
    env = learner.env
    start = env.reset_at([int(f) for f in GAIL_FRAMES.split(",")])
    _zero_counts(ops)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = runner.rollout(env, learner.policy, state.trpo.params, start,
                         IMIT_HORIZON)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = _counts(ops)
    lens = out.ep_len.double()
    rec = {"ep_len_mean": float(lens.mean()),
           "reward_per_step": float(out.ep_ret.double().mean())
           / float(lens.mean()),
           "env_steps_per_s": 64 * IMIT_HORIZON / dt, "seconds": dt,
           "apgd_launches_per_control_step": n["apgd_solve"] / IMIT_HORIZON,
           "launches": n}
    finite = all(bool(torch.isfinite(x).all())
                 for x in (out.state.qpos, out.state.qvel, out.state.obs))
    print(f"[gail] evaluate gail_r4 (tanh 100x2, learned logstd), 64 RSI "
          f"episodes x {IMIT_HORIZON} steps from fixed frames, "
          f"deterministic: EpLen mean {rec['ep_len_mean']:.2f}, reward per "
          f"step {rec['reward_per_step']:.4f} (the port on the CPU: EpLen "
          f"{CPU_GAIL[0]}, {CPU_GAIL[1]}), {dt:.2f} s, "
          f"{rec['env_steps_per_s']:.1f} env-steps/s; APGD launches per "
          f"control step {rec['apgd_launches_per_control_step']:.2f} ({n}); "
          f"finite {finite}")
    if not (finite
            and abs(rec["reward_per_step"] - CPU_GAIL[1]) <= 0.03
            and abs(rec["ep_len_mean"] - CPU_GAIL[0]) <= 0.05 * CPU_GAIL[0]):
        raise AssertionError(f"[gail] evaluation off: {rec}")
    if n != {"apgd_solve": 8 * IMIT_HORIZON, "apgd_solve_lanes": 0,
             "apgd_solve_wide": 0}:
        raise AssertionError(f"[gail] evaluation: APGD launches {n}")
    return rec


def _gail_train(torch, ops) -> dict:
    """[gail] ``GAIL.iteration`` resumed from gail_r4's whole state (64
    envs, its discriminator and d-Adam, the expert cursor), horizon 32 of
    the run's 1024, g_step 3, d_step 1: one timed iteration, the launch
    counts set to 0 just before it.  Phase times are wall time between
    synchronizations."""
    from deepmimic_mujoco_torch.algos.trpo import Draws
    from deepmimic_mujoco_torch.io_utils import checkpoint

    learner = _gail_learner(64, GAIL_TRAIN_HORIZON)
    state = checkpoint.load_gail_state(CKPT_GAIL, learner, Draws(
        torch.Generator(device="cuda").manual_seed(SEED)))
    t = learner.trpo
    phase = {"rollout": 0.0, "policy update": 0.0, "vf epochs": 0.0,
             "d-step": 0.0}
    t._rollout = _timed(t._rollout, phase, "rollout")
    t._policy_update = _timed(t._policy_update, phase, "policy update")
    t._vf_update = _timed(t._vf_update, phase, "vf epochs")
    learner._d_update = _timed(learner._d_update, phase, "d-step")
    lens, trues = [], []

    def iterate(state):
        state, stats = learner.iteration(state)
        ended = stats.trpo.ep_lens > 0
        lens.extend(stats.trpo.ep_lens[ended].tolist())
        trues.extend(stats.true_ep_rets[ended].tolist())
        return state, stats

    _zero_counts(ops)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, stats = iterate(state)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = _counts(ops)
    steps = 3 * GAIL_TRAIN_HORIZON
    rec = {k: float(v) for k, v in (
        ("DLoss", stats.d_loss), ("GenAcc", stats.gen_acc),
        ("ExpertAcc", stats.exp_acc), ("meankl", stats.trpo.meankl),
        ("surrgain", stats.trpo.surrgain))}
    rec["EpTrueRewMean"] = sum(trues) / len(trues) if trues else float("nan")
    rec["EpLenMean"] = sum(lens) / len(lens) if lens else float("nan")
    rec.update(episodes=len(lens), env_steps_per_s=64 * steps / dt,
               iteration_s=dt, phase_s=dict(phase),
               apgd_launches_per_control_step=n["apgd_solve"] / steps,
               launches=n, expert_ptr=int(state.expert_ptr))
    params = state.trpo.params
    finite = all(bool(torch.isfinite(x).all()) for x in (
        [params["logstd"]] + [layer["w"] for layer in params["pol"]
                              + params["vf"] + state.d_params["net"]])) \
        and all(v == v and abs(v) != float("inf") for k, v in rec.items()
                if k in ("DLoss", "GenAcc", "ExpertAcc", "meankl",
                         "surrgain", "EpTrueRewMean"))
    print(f"[gail] GAIL.iteration resumed from gail_r4: 64 envs x "
          f"{GAIL_TRAIN_HORIZON} steps (horizon cut from 1024) x g_step 3, "
          f"d_step 1, 1 iteration: "
          f"{rec['env_steps_per_s']:.1f} env-steps/s, {dt:.3f} s ("
          + ", ".join(f"{k} {v:.3f} s" for k, v in phase.items())
          + f"); DLoss {rec['DLoss']:.4f}, GenAcc {rec['GenAcc']:.4f}, "
          f"ExpertAcc {rec['ExpertAcc']:.4f}, EpTrueRewMean "
          f"{rec['EpTrueRewMean']:.3f} over {len(lens)} episodes, EpLenMean "
          f"{rec['EpLenMean']:.1f}, meankl {rec['meankl']:.5f}; APGD "
          f"launches per control step "
          f"{rec['apgd_launches_per_control_step']:.2f} ({n}); finite "
          f"{finite}")
    if not (finite and lens and rec["meankl"] <= 1.5 * MAX_KL
            and 0 <= rec["GenAcc"] <= 1 and 0 <= rec["ExpertAcc"] <= 1):
        raise AssertionError(f"[gail] resumed training: {rec}")
    if n != {"apgd_solve": 8 * steps, "apgd_solve_lanes": 0,
             "apgd_solve_wide": 0}:
        raise AssertionError(f"[gail] resumed training: APGD launches {n}")
    return rec


def _tree_to(tree, dev):
    """A params dict (lists of layers, an obs-RMS or Adam triple) on
    ``dev``."""
    if hasattr(tree, "to"):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, dev) for v in tree]
    return type(tree)(*(_tree_to(v, dev) for v in tree))


def _rel(a, b) -> float:
    return float((a.cpu() - b.cpu()).abs().max()) / max(
        1.0, float(b.cpu().abs().max()))


def _gail_card_vs_cpu(torch) -> dict:
    """[gail] one exact d-step (2 minibatches) and one TRPO segment update
    from the same 8-env x 16-step segment (a discriminator-rewarded
    rollout of the recipe on the card), params and permutations, on the
    card and on the CPU: the discriminator's loss and accuracies, its
    logits on the segment, the policy's means and the values on it within
    1e-4 of max(1, max|x|); the parameters within 1e-2 (Adam moves a
    parameter by about its step size whatever the sign of a rounding-level
    gradient)."""
    from deepmimic_mujoco_torch.algos.gail import disc_leaves
    from deepmimic_mujoco_torch.algos.trpo import (Draws, flatten,
                                                   policy_leaves, vf_leaves)

    B, T = 8, 16
    gen = torch.Generator().manual_seed(SEED)
    d_perm = torch.randperm(B * T, generator=gen)
    vf_perms = torch.stack([torch.randperm(B * T, generator=gen)
                            for _ in range(3)])

    class Fixed(Draws):
        def d_permutation(self, n, device):
            return d_perm.to(device)

        def vf_permutations(self, n, epochs, device):
            return vf_perms.to(device)

    ref = _gail_learner(B, T, d_step=2)
    st = ref.init(torch.Generator(device="cuda").manual_seed(SEED))
    t = st.trpo
    seg = ref.trpo._rollout(
        t.params, t.env_state, t.new, t.draws, t.cur_ep_ret, t.cur_ep_len,
        reward_fn=lambda ob, ac: ref.disc.reward(st.d_params, ob, ac))[0]
    out = {}
    for dev in ("cuda", "cpu"):
        learner = _gail_learner(B, T, dev, d_step=2)
        s = {k: v.to(dev) for k, v in seg.items()}
        ob, ac = s["ob"].reshape(-1, 68), s["ac"].reshape(-1, 28)
        d_params, _, _, d_rec = learner._d_update(
            _tree_to(st.d_params, dev), _tree_to(st.d_adam, dev),
            st.expert_ptr.to(dev), ob, ac, Fixed(None))
        params = learner.trpo._segment_update(
            _tree_to(t.params, dev), _tree_to(t.vf_adam, dev), s,
            Fixed(None))[0]
        out[dev] = {
            "d_loss_accs": d_rec, "logits": learner.disc.logits(d_params, ob,
                                                                ac),
            "means": learner.policy.mean_logstd(params, ob)[0],
            "values": learner.policy.value(params, ob),
            "d_params": flatten(disc_leaves(d_params)),
            "pol_params": flatten(policy_leaves(params)),
            "vf_params": flatten(vf_leaves(params))}
    d = {k: _rel(out["cuda"][k], out["cpu"][k]) for k in out["cpu"]}
    bounds = {k: 1e-2 if k.endswith("params") else 1e-4 for k in d}
    print(f"[gail] one d-step and one segment update from a {B}-env x "
          f"{T}-step segment, card vs CPU: max diff / max(1, max|x|): "
          + ", ".join(f"{k} {v:.3e} (bound {bounds[k]:.0e})"
                      for k, v in d.items()))
    if not all(d[k] <= bounds[k] for k in d):
        raise AssertionError("[gail] the card's d-step or segment update "
                             "disagrees with the CPU's")
    return d


def _gail_cli(torch, tmp: str) -> dict:
    """[gail] ``cli.train_gail`` in-process with the r4 run's flags at 64
    envs x 32 steps, BC pretraining of ``GAIL_BC_ITERS`` steps, 1
    iteration, in ``tmp``:
    the BC loss goes down, the tabular keys are logged, and
    ``gail_state.npz`` reads back through ``load_gail_state``."""
    from deepmimic_mujoco_torch.algos.trpo import Draws
    from deepmimic_mujoco_torch.cli import train_gail
    from deepmimic_mujoco_torch.io_utils import checkpoint

    t0 = time.perf_counter()
    text, _ = _quiet(train_gail.main, [
        *GAIL_FLAGS, "--num-envs", "64", "--timesteps-per-batch",
        str(GAIL_TRAIN_HORIZON), "--num-iters", "1", "--pretrained",
        "--bc-max-iters", str(GAIL_BC_ITERS), "--seed", str(SEED),
        "--log-dir", os.path.join(tmp, "logs"),
        "--checkpoint-dir", os.path.join(tmp, "ckpt")])
    dt = time.perf_counter() - t0
    bc = [float(m) for m in re.findall(r"BC iter \d+: loss (\S+)", text)]
    run = os.path.join("DPEnvV3", "gail-walk-0")
    with open(os.path.join(tmp, "logs", run, "progress.csv")) as fh:
        rows = fh.read().strip().splitlines()
    last = dict(zip(rows[0].split(","), rows[-1].split(",")))
    learner = _gail_learner(64, GAIL_TRAIN_HORIZON)
    state = checkpoint.load_gail_state(
        os.path.join(tmp, "ckpt", run, "gail_state.npz"), learner,
        Draws(None))
    rec = {"bc_loss_first": bc[0], "bc_loss_last": bc[-1], "seconds": dt,
           "progress": last, "expert_ptr": int(state.expert_ptr)}
    print(f"[gail] CLI train_gail, the r4 flags at 64 envs x "
          f"{GAIL_TRAIN_HORIZON} steps, --pretrained --bc-max-iters "
          f"{GAIL_BC_ITERS}, "
          f"--num-iters 1, in-process: {dt:.1f} s; BC loss {bc[0]:.4f} -> "
          f"{bc[-1]:.4f}; last row "
          + ", ".join(f"{k} {last[k]}" for k in sorted(last))
          + f"; gail_state.npz reads back through load_gail_state, expert "
          f"cursor {rec['expert_ptr']}")
    keys = {"EpLenMean", "EpRewMean", "EpTrueRewMean", "DLoss", "GenAcc",
            "ExpertAcc", "TimestepsSoFar", "TimeElapsed"}
    if not (len(bc) == 2 and bc[-1] < bc[0] and set(last) == keys
            and len(rows) == 2
            and rec["expert_ptr"] == 64 * GAIL_TRAIN_HORIZON):
        raise AssertionError(f"[gail] the CLI's run is off: {rec}")
    return rec


def _ppo_cli(torch, ops, train_trpo, tmp: str) -> dict:
    """[ppo] ``cli.train_trpo --algo ppo --task train`` on walk (torque),
    in-process: 4096 envs x 64 steps (bench.py's width), the PPO defaults
    (4 epochs x 8 minibatches of 32,768 rows), 2 iterations, into ``tmp``.
    The rollout and the update are timed (wall time between
    synchronizations), the launch counts set to 0 just before."""
    from deepmimic_mujoco_torch.algos.ppo import PPO

    phase = {"rollout": 0.0, "update": 0.0}
    rollout, update = PPO._rollout, PPO._update
    PPO._rollout = _timed(rollout, phase, "rollout")
    PPO._update = _timed(update, phase, "update")
    _zero_counts(ops)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        state = train_trpo.main([
            "--task", "train", "--algo", "ppo", "--num-envs", str(B_MAIN),
            "--timesteps-per-batch", str(TRAIN_HORIZON), "--num-iters", "2",
            "--device", "cuda", "--seed", str(SEED),
            "--log-dir", os.path.join(tmp, "logs"),
            "--checkpoint-dir", os.path.join(tmp, "ckpt")])
        torch.cuda.synchronize()
    finally:
        PPO._rollout, PPO._update = rollout, update
    dt = time.perf_counter() - t0
    n = _counts(ops)
    with open(os.path.join(tmp, "logs", "DPEnvV3", "ppo-walk-0",
                           "progress.csv")) as fh:
        rows = fh.read().strip().splitlines()
    last = {k: float(v) for k, v in zip(rows[0].split(","),
                                        rows[-1].split(","))}
    steps = 2 * TRAIN_HORIZON
    rec = {"env_steps_per_s": B_MAIN * steps / dt, "seconds": dt,
           "phase_s_per_iteration": {k: v / 2 for k, v in phase.items()},
           "apgd_launches_per_env_step": n["apgd_solve"] / steps,
           "launches": n, **{k: last[k] for k in (
               "meankl", "optimgain", "surrgain", "entloss", "entropy",
               "ev_tdlam_before", "EpLenMean")}}
    params = state.params
    finite = all(bool(torch.isfinite(x).all()) for x in (
        [params["logstd"]] + [layer["w"] for layer in params["pol"]
                              + params["vf"]])) and all(
        v == v and abs(v) != float("inf") for k, v in rec.items()
        if k in ("meankl", "optimgain", "surrgain", "entloss", "entropy"))
    print(f"[ppo] CLI --algo ppo --task train, walk (torque), {B_MAIN} envs "
          f"x {TRAIN_HORIZON} steps, 4 epochs x 8 minibatches of "
          f"{B_MAIN * TRAIN_HORIZON // 8} rows, 2 iterations, in-process: "
          f"{rec['env_steps_per_s']:.1f} env-steps/s over {dt:.2f} s "
          f"(checkpoints and logs included); per iteration rollout "
          f"{phase['rollout'] / 2:.3f} s, update {phase['update'] / 2:.3f} "
          f"s; last row meankl {last['meankl']:.5f}, surrgain "
          f"{last['surrgain']:.5f}, entropy {last['entropy']:.3f}, "
          f"ev_tdlam_before {last['ev_tdlam_before']:.4f}, EpLenMean "
          f"{last['EpLenMean']}; APGD launches per env step "
          f"{rec['apgd_launches_per_env_step']:.2f} ({n}); finite {finite}")
    if not (finite and len(rows) == 3):
        raise AssertionError(f"[ppo] CLI run: {rec}")
    if n != {"apgd_solve": 4 * steps, "apgd_solve_lanes": 0,
             "apgd_solve_wide": 0}:
        raise AssertionError(f"[ppo] APGD launches {n}")
    return rec


def _ppo_card_vs_cpu(torch) -> dict:
    """[ppo] one ``PPO.iteration`` (walk, 16 envs x 16 steps, 4 epochs x 8
    minibatches) from the same state and the same draws (the CPU run's,
    recorded and replayed on the card): the policy's means and the values
    on the CPU's final obs and the iteration's stats within 1e-4 of
    max(1, max|x|), the parameters within 1e-2."""
    import dataclasses

    from deepmimic_mujoco_torch.algos.ppo import PPO, PPOConfig, train_leaves
    from deepmimic_mujoco_torch.algos.trpo import Draws, flatten
    from deepmimic_mujoco_torch.envs.dp_env_v3 import DPEnvV3
    from deepmimic_mujoco_torch.models.policy import MlpPolicy
    from deepmimic_mujoco_torch.physics.humanoid import build_humanoid

    log = []

    class Record(Draws):
        def action_noise(self, mean):
            log.append(super().action_noise(mean))
            return log[-1]

        def fresh_states(self, reset_fn, done, state=None):
            log.append(super().fresh_states(reset_fn, done, state))
            return log[-1]

        def vf_permutations(self, n, epochs, device):
            log.append(super().vf_permutations(n, epochs, device))
            return log[-1]

    class Replay(Draws):
        def action_noise(self, mean):
            return log.pop(0).to(mean.device)

        def fresh_states(self, reset_fn, done, state=None):
            return log.pop(0).map(lambda x: x.to(done.device))

        def vf_permutations(self, n, epochs, device):
            return log.pop(0).to(device)

    B, T = 16, 16
    cpu, card = (PPO(DPEnvV3(model=build_humanoid(device=dev)),
                     MlpPolicy(ob_dim=56, ac_dim=28),
                     PPOConfig(horizon=T, num_envs=B))
                 for dev in ("cpu", "cuda"))
    st = cpu.init(torch.Generator().manual_seed(SEED))
    st_card = dataclasses.replace(
        st, params=_tree_to(st.params, "cuda"),
        opt=_tree_to(st.opt, "cuda"),
        env_state=st.env_state.map(lambda x: x.to("cuda")),
        new=st.new.cuda(), draws=Replay(None), cur_ep_ret=st.cur_ep_ret.cuda(),
        cur_ep_len=st.cur_ep_len.cuda(), lr_scale=st.lr_scale.cuda())
    out, obs = {}, None
    for dev, learner, state in (
            ("cpu", cpu, dataclasses.replace(
                st, draws=Record(torch.Generator().manual_seed(SEED)))),
            ("cuda", card, st_card)):
        st1, stats = learner.iteration(state)
        obs = st1.env_state.obs if obs is None else obs.to(dev)
        out[dev] = {
            "means": learner.policy.mean_logstd(st1.params, obs)[0],
            "values": learner.policy.value(st1.params, obs),
            "stats": torch.stack([stats.meankl, stats.surrgain,
                                  stats.entropy, stats.ev_tdlam_before]),
            "params": flatten(train_leaves(st1.params))}
    d = {k: _rel(out["cuda"][k], out["cpu"][k]) for k in out["cpu"]}
    bounds = {k: 1e-2 if k == "params" else 1e-4 for k in d}
    print(f"[ppo] one PPO.iteration, {B} envs x {T} steps, the same draws, "
          f"card vs CPU: max diff / max(1, max|x|): " + ", ".join(
              f"{k} {v:.3e} (bound {bounds[k]:.0e})" for k, v in d.items())
          + f"; draws left unreplayed {len(log)}")
    if log or not all(d[k] <= bounds[k] for k in d):
        raise AssertionError("[ppo] the card's iteration disagrees with the "
                             "CPU's")
    return d


class _StepCount:
    """Counts the calls of ``cls.step`` while in use (every env instance of
    the class, the CLI's own included)."""

    def __init__(self, cls):
        self.cls, self.n = cls, 0

    def __enter__(self):
        self.step = step = self.cls.step

        def counted(env, *args, **kw):
            self.n += 1
            return step(env, *args, **kw)
        self.cls.step = counted
        return self

    def __exit__(self, *exc):
        self.cls.step = self.step


def _dp_eval(torch, ops) -> dict:
    """[dp-ppo] the r5 params (read by ``load_dp_ppo_params``) in TEST mode:
    ``RLAgentDriver.test_episodes`` over 512 RSI episodes from
    :func:`dp_frames`, horizon 300.  The first 64 episodes' reward per step
    within 0.03 and mean length within 10% of the port's CPU figure
    (``CPU_DP``); 8 ``apgd_solve`` launches per control step, no other."""
    from deepmimic_mujoco_torch.dp_policy.draws import Draws
    from deepmimic_mujoco_torch.dp_policy.ppo_agent import PPOAgent
    from deepmimic_mujoco_torch.dp_policy.rl_agent import RLAgentDriver
    from deepmimic_mujoco_torch.envs.deepmimic_surface import (
        DeepMimicSurfaceEnv,
    )
    from deepmimic_mujoco_torch.io_utils import checkpoint

    env = DeepMimicSurfaceEnv(device="cuda")
    if env.clip_len != 39:
        raise AssertionError(f"the walk clip has {env.clip_len} frames")
    agent = PPOAgent.for_env(env, reward_bounds=(0.0, 1.0))
    params = checkpoint.load_dp_ppo_params(CKPT_DP, agent, "cuda")
    frames = dp_frames()

    class Frames(Draws):
        def test_starts(self, reset_fn, n):
            return env.reset_at(frames[:n])

    driver = RLAgentDriver(env, agent, num_envs=DP_ENVS, draws=Frames(None))
    print(f"[dp-ppo] eval frames (the first 64 of {DP_ENVS}, "
          f"np.random.RandomState({SEED})): "
          + ",".join(str(int(f)) for f in frames[:64]))
    _zero_counts(ops)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _StepCount(DeepMimicSurfaceEnv) as steps:
        ret, length = driver.test_episodes(params, n_episodes=DP_ENVS,
                                           horizon=DP_HORIZON)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = _counts(ops)
    rets, lens = driver.test_returns.cpu(), driver.test_lengths.cpu()
    r64 = float(rets[:64].sum() / lens[:64].sum())
    l64 = float(lens[:64].double().mean())
    rec = {"Test_Return": ret, "Test_Length": length, "seconds": dt,
           "env_steps_per_s": float(lens.sum()) / dt,
           "control_steps": steps.n,
           "apgd_launches_per_control_step": n["apgd_solve"] / steps.n,
           "launches": n, "reward_per_step_64": r64, "length_64": l64,
           "reward_per_step": float(rets.sum() / lens.sum()),
           "max_length": int(lens.max())}
    print(f"[dp-ppo] eval r5, {DP_ENVS} RSI episodes x horizon {DP_HORIZON} "
          f"(test_episodes, the deterministic policy): Test_Return "
          f"{ret:.4f}, Test_Length {length:.2f} (longest {rec['max_length']}"
          f"), reward per step {rec['reward_per_step']:.4f}; {dt:.2f} s, "
          f"{rec['env_steps_per_s']:.1f} env-steps/s (the sum of the lengths "
          f"over the wall time), {steps.n} control steps; the first 64 "
          f"episodes: reward per step {r64:.4f}, mean length {l64:.2f} (the "
          f"port's CPU: {CPU_DP[0]}, {CPU_DP[1]}); APGD launches per control "
          f"step {rec['apgd_launches_per_control_step']:.2f} ({n})")
    if not (abs(r64 - CPU_DP[0]) <= 0.03
            and abs(l64 - CPU_DP[1]) <= 0.1 * CPU_DP[1]):
        raise AssertionError(f"[dp-ppo] eval off the CPU's figure: {rec}")
    if n != {"apgd_solve": 8 * steps.n, "apgd_solve_lanes": 0,
             "apgd_solve_wide": 0}:
        raise AssertionError(f"[dp-ppo] eval APGD launches {n}")
    return rec


def _dp_train(torch, ops, train_ppo, tmp: str) -> dict:
    """[dp-ppo] ``cli.train_ppo`` in-process at the r5 run's flags, cut:
    ``--surface deepmimic --motion walk --num-envs 512 --num-iters 3
    --resume <r5> --test-every 3`` into ``tmp``.  Per iteration the
    rollout, absorb and train seconds (between synchronizations), env steps
    and the logged metrics; the losses finite, ``actor_stepsize`` 2.5e-6,
    ``Samples`` grown by each train step's non-end records (in f32), the
    final ``ppo_params.npz`` read back, 8 launches per control step."""
    import numpy as np

    from deepmimic_mujoco_torch.dp_policy.ppo_agent import PPOAgent
    from deepmimic_mujoco_torch.dp_policy.rl_agent import RLAgentDriver
    from deepmimic_mujoco_torch.envs.deepmimic_surface import (
        DeepMimicSurfaceEnv,
    )
    from deepmimic_mujoco_torch.io_utils import checkpoint

    iters, cur = [], {"rollout": 0.0, "absorb": 0.0, "train": 0.0,
                      "chunks": 0, "non_end": 0}
    orig = {k: getattr(RLAgentDriver, k) for k in (
        "_rollout", "_absorb_chunk", "_train", "train_iteration")}

    def rollout(self, *a):
        cur["chunks"] += 1
        return _timed(orig["_rollout"], cur, "rollout")(self, *a)

    def train(self, params):
        cur["non_end"] = int((~self.replay_buffer.end_mask()).sum())
        return _timed(orig["_train"], cur, "train")(self, params)

    def iteration(self, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig["train_iteration"](self, *a)
        torch.cuda.synchronize()
        iters.append({**cur, "wall": time.perf_counter() - t0,
                      "env_steps": cur["chunks"] * self.chunk
                      * self.num_envs})
        cur.update(rollout=0.0, absorb=0.0, train=0.0, chunks=0)
        return out

    RLAgentDriver._rollout, RLAgentDriver._train = rollout, train
    RLAgentDriver._absorb_chunk = _timed(orig["_absorb_chunk"], cur, "absorb")
    RLAgentDriver.train_iteration = iteration
    _zero_counts(ops)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with _StepCount(DeepMimicSurfaceEnv) as steps:
            params = train_ppo.main([
                "--surface", "deepmimic", "--motion", "walk", "--num-envs",
                str(DP_ENVS), "--num-iters", str(DP_TRAIN_ITERS), "--resume",
                CKPT_DP, "--test-every", str(DP_TRAIN_ITERS), "--device",
                "cuda", "--seed", str(SEED),
                "--log-dir", os.path.join(tmp, "logs"),
                "--checkpoint-dir", os.path.join(tmp, "ckpt")])
        torch.cuda.synchronize()
    finally:
        for k, fn in orig.items():
            setattr(RLAgentDriver, k, fn)
    dt = time.perf_counter() - t0
    n = _counts(ops)
    run = os.path.join("deepmimic", f"ppo-walk-{SEED}")
    with open(os.path.join(tmp, "logs", run, "progress.csv")) as fh:
        rows = [r.split(",") for r in fh.read().strip().splitlines()]
    logged = [{k: float(v) for k, v in zip(rows[0], r) if v} for r in rows[1:]]
    samples = float(checkpoint.load_dp_ppo_params(CKPT_DP, PPOAgent(197, 36),
                                                  "cpu")["sample_count"])
    ok = len(iters) == len(logged) == DP_TRAIN_ITERS
    for it, (ph, row) in enumerate(zip(iters, logged)):
        samples = float(np.float32(samples) + np.float32(ph["non_end"]))
        ok &= row["Samples"] == samples
        ok &= all(np.isfinite(row[k]) for k in (
            "critic_loss", "actor_loss", "clip_frac", "adv_mean", "adv_std"))
        ok &= abs(row["actor_stepsize"] - 2.5e-6) < 1e-12
        print(f"[dp-ppo] train iteration {it}: rollout {ph['rollout']:.3f} s "
              f"({ph['chunks']} chunks), absorb {ph['absorb']:.3f} s, train "
              f"{ph['train']:.3f} s, {ph['env_steps']} env steps, "
              f"{ph['env_steps'] / ph['wall']:.1f} env-steps/s over "
              f"{ph['wall']:.3f} s; Samples {row['Samples']:.0f} (+"
              f"{ph['non_end']} non-end records), critic_loss "
              f"{row['critic_loss']:.5f}, actor_loss {row['actor_loss']:.5f}, "
              f"clip_frac {row['clip_frac']}, adv_mean {row['adv_mean']:.5f}, "
              f"adv_std {row['adv_std']:.5f}, avg_path_reward "
              f"{row.get('avg_path_reward', float('nan')):.4f}, "
              f"actor_stepsize {row['actor_stepsize']:.3e}")
    back = checkpoint.load_dp_ppo_params(
        os.path.join(tmp, "ckpt", run, "ppo_params.npz"),
        PPOAgent(197, 36), "cpu")
    ok &= float(back["sample_count"]) == samples == float(
        params["sample_count"])
    last = logged[-1]
    rec = {"seconds": dt, "iterations": iters, "logged": logged,
           "control_steps": steps.n, "launches": n,
           "apgd_launches_per_control_step": n["apgd_solve"] / steps.n,
           "env_steps_per_s": sum(p["env_steps"] for p in iters)
           / sum(p["wall"] for p in iters)}
    print(f"[dp-ppo] train CLI, the r5 flags at {DP_ENVS} envs, "
          f"{DP_TRAIN_ITERS} iterations resumed from r5: {dt:.2f} s in all "
          f"(the test and checkpoints included), {rec['env_steps_per_s']:.1f} "
          f"env-steps/s over the iterations; Test_Return "
          f"{last.get('Test_Return')}, Test_Length {last.get('Test_Length')} "
          f"at iteration {DP_TRAIN_ITERS}; ppo_params.npz reads back "
          f"(Samples {float(back['sample_count']):.0f}); APGD launches per "
          f"control step {rec['apgd_launches_per_control_step']:.2f} over "
          f"{steps.n} control steps ({n}); checks {ok}")
    if not ok or "Test_Return" not in last:
        raise AssertionError(f"[dp-ppo] train CLI run: {rec}")
    if n != {"apgd_solve": 8 * steps.n, "apgd_solve_lanes": 0,
             "apgd_solve_wide": 0}:
        raise AssertionError(f"[dp-ppo] train APGD launches {n}")
    return rec


# the card-vs-CPU check of one original-stack train iteration, as
# max|card − CPU| over max(1, max|CPU|): the rollout's actions, the
# buffer's logps and rewards and the metrics within 1e-5, the labels
# equal.  The buffer's states are the physics' 197-D obs after up to 32
# control steps: storing the dual matrix in bf16 (the surface's storage)
# turns 1-ulp f32 differences of the card's products into bf16 ulps, so
# they read 2.96e-5 with the kernel and 3.04e-5 with the plain solve on
# the card, 5.0e-6 and 7.0e-6 with f32 storage (python3 chip_smoke.py
# --dp-witness on an H100 80GB HBM3 at 700 W): bound 5e-5.  The
# parameters by dp_param_diff: the actor's step, 2.5e-6 times its
# momentum, moves by 5e-4 to 2.6e-3 of its size in those four runs (its
# gradient divides the actions' offsets from the mean, 1e-6 apart, by the
# noise's variance), a skipped momentum step by 0.34 or more: bound 1e-2
DP_CVC_BOUNDS = {"actions": 1e-5, "logps": 1e-5, "rewards": 1e-5,
                 "labels": 0.0, "metrics": 1e-5, "states": 5e-5}
DP_PARAM_BOUNDS = {"exact": 0.0, "leaves": 1e-3, "steps": 1e-2}


def _dp_named_leaves(params: dict) -> list:
    """(name, kind, tensor) of each leaf of an original-stack params dict:
    kind ``exact`` for the counts (the normalizers' and ``sample_count``)
    and ``actor_stepsize``, ``net`` for the nets' and their momentum's
    leaves, ``leaf`` for the normalizers' statistics."""
    out = []
    for k in sorted(params):
        v = params[k]
        layers = v if k in ("actor", "critic") else (
            v.m if k.endswith("_opt") else None)
        if layers is not None:
            out += [(f"{k}[{i}].{n}", "net", layer[n])
                    for i, layer in enumerate(layers) for n in sorted(layer)]
        elif hasattr(v, "_fields"):
            out += [(f"{k}.{f}", "exact" if f == "count" else "leaf", x)
                    for f, x in zip(v._fields, v)]
        else:
            out.append((k, "exact", v))
    return out


def dp_param_diff(p0: dict, p1: dict, ref: dict) -> dict:
    """Original-stack params ``p1`` against ``ref``, both one train step
    from ``p0``, leaf by leaf (read in f64):

    * ``exact``: the largest difference of a count or of
      ``actor_stepsize`` (f32 sums of whole numbers and a constant, alike on
      every device);
    * ``leaves``: the largest over the other leaves of max|p1 − ref| over
      max(1, max|ref|);
    * ``steps``: the largest over the nets' and their momentum's leaves of
      ‖p1 − ref‖ over ‖ref − p0‖, the step's own size (the actor moves by
      about 1e-8 per step, which its weights would hide in ``leaves``).

    Also ``worst``: the leaf that gave each figure."""
    out = {"exact": 0.0, "leaves": 0.0, "steps": 0.0}
    worst = {}

    def keep(group, name, value):
        if value > out[group] or group not in worst:
            out[group] = max(out[group], value)
            worst[group] = name

    for (name, kind, a), (_, _, b), (_, _, z) in zip(
            _dp_named_leaves(p1), _dp_named_leaves(ref),
            _dp_named_leaves(p0)):
        a, b, z = (x.detach().cpu().double() for x in (a, b, z))
        d = (a - b).abs()
        if kind == "exact":
            keep("exact", name, float(d.max()))
            continue
        keep("leaves", name, float(d.max()) / max(1.0, float(b.abs().max())))
        if kind == "net":
            step, gap = float((b - z).norm()), float(d.norm())
            keep("steps", name, gap / step if step > 0 else (
                0.0 if gap == 0 else float("inf")))
    return {**out, "worst": worst}


def plant_fault(agent, fault: str) -> None:
    """Make ``agent``'s train step wrong in one of the ways the card-vs-CPU
    check must catch: ``critic`` skips the critic's momentum step of the
    first minibatch, ``actor`` the actor's, ``sample_count`` adds 2 to the
    sample count."""
    if fault == "sample_count":
        train = agent.train_on_batch

        def counted(*a, **kw):
            params, metrics = train(*a, **kw)
            return {**params,
                    "sample_count": params["sample_count"] + 2}, metrics

        agent.train_on_batch = counted
        return
    if fault not in ("critic", "actor"):
        raise ValueError(f"unknown fault {fault!r}")
    step, calls = agent._minibatch_step, []

    def skipped(params, c_rows, a_rows):
        out = step(params, c_rows, a_rows)
        calls.append(1)
        if len(calls) > 1:
            return out
        return ({**out[0], fault: params[fault],
                 f"{fault}_opt": params[f"{fault}_opt"]},) + out[1:]

    agent._minibatch_step = skipped


def _dp_iteration(torch, dev: str, log: list | None,
                  solver_dtype: str = "bf16", solve: str = "kernel",
                  fault: str | None = None) -> dict:
    """One ``RLAgentDriver.train_iteration`` at 16 envs x chunks of 16 steps
    from the r5 params with a small spec (BatchSize 128, MiniBatchSize 32)
    on ``dev``: with ``log`` None its draws come from a generator and are
    recorded into the record's ``log``, else ``log``'s are replayed.
    ``solver_dtype`` is the dual matrix's storage; ``solve="plain"`` swaps
    the solver's APGD dispatch for the plain version (on any device);
    ``fault`` is planted by :func:`plant_fault`."""
    from deepmimic_mujoco_torch.dp_policy.draws import Draws
    from deepmimic_mujoco_torch.dp_policy.ppo_agent import PPOAgent
    from deepmimic_mujoco_torch.dp_policy.rl_agent import RLAgentDriver
    from deepmimic_mujoco_torch.envs.deepmimic_surface import (
        DeepMimicSurfaceEnv,
    )
    from deepmimic_mujoco_torch.io_utils import checkpoint
    from deepmimic_mujoco_torch.ops import apgd as ops
    from deepmimic_mujoco_torch.physics import solver
    from deepmimic_mujoco_torch.physics.humanoid import build_humanoid

    record, queue = log is None, [] if log is None else list(log)

    class Seam(Draws):
        def _next(self, fresh, to):
            if record:
                queue.append(fresh())
                return queue[-1]
            return to(queue.pop(0))

        def rollout_chunk(self, steps, n_envs, action_size, device):
            return self._next(
                lambda: super(Seam, self).rollout_chunk(
                    steps, n_envs, action_size, device),
                lambda x: tuple(y.to(device) for y in x))

        def fresh_states(self, reset_fn, done):
            return self._next(
                lambda: super(Seam, self).fresh_states(reset_fn, done),
                lambda x: x.map(lambda y: y.to(done.device)))

        def minibatch_indices(self, p_critic, *a):
            return self._next(
                lambda: super(Seam, self).minibatch_indices(p_critic, *a),
                lambda x: tuple(y.to(p_critic.device) for y in x))

    B, T = 16, 16
    spec = {"BatchSize": 128, "MiniBatchSize": 32}
    env = DeepMimicSurfaceEnv(model=build_humanoid(
        device=dev, solver_dtype=solver_dtype))
    agent = PPOAgent.for_env(env, spec=spec)
    if fault:
        plant_fault(agent, fault)
    params = checkpoint.load_dp_ppo_params(CKPT_DP, agent, dev)
    draws = Seam(torch.Generator().manual_seed(SEED) if record else None)
    driver = RLAgentDriver(env, agent, num_envs=B, chunk=T, draws=draws)
    trajs, bufs = [], {}
    rollout, train = driver._rollout, driver._train

    def rec_rollout(p, st):
        st, traj = rollout(p, st)
        trajs.append(traj)
        return st, traj

    def rec_train(p):
        buf = driver.replay_buffer
        n = buf.get_current_size()
        bufs.update({k: torch.as_tensor(buf.get_all(k)) for k in (
            "states", "actions", "logps", "rewards")})
        bufs["labels"] = torch.as_tensor(
            buf._terminate[:n] * 4 + buf.end_mask() * 2
            + buf.flag_mask(1)).float()
        return train(p)

    def plain(a, b, mu, f0, *, iterations, nc, nl, layout="blocks"):
        return ops._apgd_scan(a, b, mu, f0, iterations=iterations, nc=nc,
                              nl=nl)

    driver._rollout, driver._train = rec_rollout, rec_train
    kept = solver.apgd
    if solve == "plain":
        solver.apgd = plain
    elif solve != "kernel":
        raise ValueError(f"unknown solve {solve!r}")
    try:
        p1, _, metrics = driver.train_iteration(
            params, env.reset_at(dp_frames(B)))
    finally:
        solver.apgd = kept
    return {"actions": torch.cat([t[1] for t in trajs]).cpu(), **bufs,
            "metrics": torch.tensor([metrics[k] for k in sorted(metrics)]),
            "obs_steps": torch.cat([t[0] for t in trajs]).cpu(),
            "p0": params, "p1": p1, "log": queue if record else None,
            "left": len(queue)}


def _dp_card_vs_cpu(torch, solver_dtype: str = "bf16", solve: str = "kernel",
                    faults: tuple = (), check: bool = True) -> dict:
    """[dp-ppo] one train iteration (:func:`_dp_iteration`) on the CPU and
    then on the card with the CPU run's draws replayed: the rollout's
    actions, the buffer's logps, rewards, end marks, terminate labels and
    flags, and the metrics within 1e-5 of max(1, max|x|), the buffer's
    states within ``DP_CVC_BOUNDS["states"]``, the parameters within
    ``DP_PARAM_BOUNDS`` (:func:`dp_param_diff`).  Then each of ``faults``
    planted on the card (:func:`plant_fault`) must fail the parameters'
    check.  ``check`` False reports without failing (the witness runs)."""
    cpu = _dp_iteration(torch, "cpu", None, solver_dtype)
    card = _dp_iteration(torch, "cuda", cpu["log"], solver_dtype, solve)
    label = (f"[dp-ppo] one train_iteration, 16 envs x chunks of 16, "
             f"BatchSize 128, MiniBatchSize 32, A {solver_dtype}, the card's "
             f"solve {solve}")
    keys = list(DP_CVC_BOUNDS)
    shapes = {k: (tuple(card[k].shape), tuple(cpu[k].shape)) for k in keys}
    if any(a != b for a, b in shapes.values()):
        raise AssertionError(f"[dp-ppo] card vs CPU shapes differ: {shapes}")
    d = {k: _rel(card[k], cpu[k]) for k in keys}
    # how the physics' states part step by step (max diff / max(1, max|x|)
    # of the rollout's obs at each control step)
    per_step = [_rel(a, b) for a, b in zip(card["obs_steps"],
                                           cpu["obs_steps"])]
    p = dp_param_diff(card["p0"], card["p1"], cpu["p1"])
    print(f"{label}, the CPU's draws replayed on the card: "
          f"{cpu['states'].shape[0]} records; max diff / max(1, max|x|): "
          + ", ".join(f"{k} {v:.3e} (bound {DP_CVC_BOUNDS[k]:.0e})"
                      for k, v in d.items())
          + "; params " + ", ".join(
              f"{k} {p[k]:.3e} (bound {DP_PARAM_BOUNDS[k]:.0e}, "
              f"{p['worst'][k]})" for k in DP_PARAM_BOUNDS)
          + f"; draws left unreplayed {card['left']}; the obs by control "
          f"step: " + " ".join(f"{x:.2e}" for x in per_step))
    ok = (card["left"] == 0
          and all(d[k] <= DP_CVC_BOUNDS[k] for k in d)
          and all(p[k] <= DP_PARAM_BOUNDS[k] for k in DP_PARAM_BOUNDS))
    if check and not ok:
        raise AssertionError("[dp-ppo] the card's train iteration disagrees "
                             "with the CPU's")
    rec = {**d, "params": {k: p[k] for k in DP_PARAM_BOUNDS},
           "obs_by_step": per_step, "ok": ok}
    for fault in faults:
        bad = _dp_iteration(torch, "cuda", cpu["log"], solver_dtype, solve,
                            fault)
        pb = dp_param_diff(bad["p0"], bad["p1"], cpu["p1"])
        caught = [k for k in DP_PARAM_BOUNDS if pb[k] > DP_PARAM_BOUNDS[k]]
        print(f"{label}, fault planted on the card ({fault}): params "
              + ", ".join(f"{k} {pb[k]:.3e} ({pb['worst'][k]})"
                          for k in DP_PARAM_BOUNDS)
              + f"; over the bound: {caught}")
        if not caught:
            raise AssertionError(f"[dp-ppo] the parameters' check missed "
                                 f"the planted fault {fault!r}")
        rec[f"fault_{fault}"] = {k: pb[k] for k in DP_PARAM_BOUNDS}
    return rec


def _dp_v3(torch, ops, train_ppo, tmp: str) -> dict:
    """[dp-ppo] ``cli.train_ppo --surface v3`` in-process: DPEnvV3 (56-D
    obs, torque, the alive reward) at 512 envs, 2 iterations of a fresh
    agent: env-steps/s and 4 ``apgd_solve`` launches per env step."""
    from deepmimic_mujoco_torch.envs.dp_env_v3 import DPEnvV3

    _zero_counts(ops)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _StepCount(DPEnvV3) as steps:
        train_ppo.main(["--surface", "v3", "--motion", "walk", "--num-envs",
                        str(DP_ENVS), "--num-iters", "2", "--device", "cuda",
                        "--seed", str(SEED),
                        "--log-dir", os.path.join(tmp, "logs"),
                        "--checkpoint-dir", os.path.join(tmp, "ckpt")])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = _counts(ops)
    with open(os.path.join(tmp, "logs", "v3", f"ppo-walk-{SEED}",
                           "progress.csv")) as fh:
        rows = fh.read().strip().splitlines()
    rec = {"seconds": dt, "env_steps": steps.n * DP_ENVS,
           "env_steps_per_s": steps.n * DP_ENVS / dt, "launches": n,
           "apgd_launches_per_env_step": n["apgd_solve"] / steps.n,
           "last_row": dict(zip(rows[0].split(","), rows[-1].split(",")))}
    print(f"[dp-ppo] v3 CLI, {DP_ENVS} envs x 2 iterations: {steps.n} env "
          f"steps per env in {dt:.2f} s (setup, training and checkpoints), "
          f"{rec['env_steps_per_s']:.1f} env-steps/s; APGD launches per env "
          f"step {rec['apgd_launches_per_env_step']:.2f} ({n}); last row "
          + ", ".join(f"{k} {v}" for k, v in rec["last_row"].items()))
    if not (len(rows) == 3 and n == {"apgd_solve": 4 * steps.n,
                                     "apgd_solve_lanes": 0,
                                     "apgd_solve_wide": 0}):
        raise AssertionError(f"[dp-ppo] v3 run: {rec}")
    return rec


def _quiet(fn, argv) -> tuple:
    """(stdout text, return value) of ``fn(argv)``."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(argv)
    return buf.getvalue(), out


def _dp_get_action() -> dict:
    """[dp-ppo] ``cli.get_action --arg-file assets/args/run_humanoid3d_walk_
    args.txt`` on the card: it prints the shape (36,)."""
    from deepmimic_mujoco_torch.cli import get_action

    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        text, ac = _quiet(get_action.main, ["--arg-file", os.path.join(
            "assets", "args", "run_humanoid3d_walk_args.txt")])
    finally:
        os.chdir(cwd)
    print("[dp-ppo] get_action on the card: " + " / ".join(
        text.strip().splitlines()))
    if "shape: (36,)" not in text or ac.shape != (36,):
        raise AssertionError(f"[dp-ppo] get_action printed {text!r}")
    return {"shape": list(ac.shape)}


def _other_env(name: str, dev: str):
    from deepmimic_mujoco_torch.envs import (
        DPEnvV1,
        DPEnvV2,
        HumanoidTestEnv,
    )

    return {"DPEnvV1": DPEnvV1, "DPEnvV2": DPEnvV2,
            "HumanoidTestEnv": HumanoidTestEnv}[name](device=dev)


def _obs_blocks(env) -> dict:
    """HumanoidTestEnv's obs blocks: name → slice."""
    nb, out, a = env.model.nbody, {}, 0
    for name, size in (("qpos[2:]", 33), ("qvel", 34), ("cinert", 10 * nb),
                       ("cvel", 6 * nb), ("qfrc_actuator", 34),
                       ("cfrc_ext", 6 * nb)):
        out[name] = slice(a, a + size)
        a += size
    return out


def _cvc_env(name: str, dev: str):
    """A card-vs-CPU case's env: DPEnvV1, DPEnvV2 or HumanoidTestEnv, or
    ``DPEnvV3(model=mode_model(name))`` for a [physics-modes] case."""
    if name in MODE_CASES:
        from deepmimic_mujoco_torch.envs.dp_env_v3 import DPEnvV3

        return DPEnvV3(model=mode_model(name, dev))
    return _other_env(name, dev)


def env_card_vs_cpu(torch, ops, name: str, n_envs: int = ENV_CVC_ENVS,
                    steps: int = ENV_CVC_STEPS) -> dict:
    """[envs] or [physics-modes]: ``n_envs`` envs of ``name`` (DPEnvV1,
    DPEnvV2, HumanoidTestEnv, or a ``MODE_CASES`` case: DPEnvV3 on
    :func:`mode_model`) x ``steps`` control steps on the card and on the
    CPU, from the same starts (clip frames; HumanoidTestEnv: noise starts
    drawn on the CPU) and the same actions (0.1·N(0, 1) from a CPU
    generator).  Bounds (``ENV_CVC_ATOL``): qpos within it absolutely,
    rewards (and a mode's qvel) within it of max(1, |x|), equal done flags
    at every step; HumanoidTestEnv's obs within it of max(1, |x|) per
    block.  On the card exactly :func:`_cvc_launches` APGD launches per
    control step and no call of the plain ``_apgd_scan``.  Reports the CPU
    root height's closest approach to the done thresholds."""
    mode = name in MODE_CASES
    tag = "[physics-modes]" if mode else "[envs]"
    envs = {d: _cvc_env(name, d) for d in ("cuda", "cpu")}
    if name == "HumanoidTestEnv":
        start = envs["cpu"].reset(torch.Generator().manual_seed(SEED), n_envs)
        states = {d: e.reset_to(start.qpos.to(d), start.qvel.to(d))
                  for d, e in envs.items()}
    else:
        frames = torch.arange(n_envs) * 5 % envs["cpu"].clip_len
        states = {d: e.reset_at(frames) for d, e in envs.items()}
    acts = 0.1 * torch.randn(
        (steps, n_envs, 28),
        generator=torch.Generator().manual_seed(ENV_ACTION_SEED[name]))
    traj = {}
    with _watch(torch, ops) as w:
        st, traj["cuda"] = states["cuda"], []
        for a in acts:
            st = envs["cuda"].step(st, a.to("cuda"))
            traj["cuda"].append(st)
    n, scans = w["launches"], w["scans"]
    st, traj["cpu"] = states["cpu"], []
    for a in acts:
        st = envs["cpu"].step(st, a)
        traj["cpu"].append(st)
    lo, hi = ENV_DONE_AT[name]
    rel_fields = ("reward", "qvel") if mode else ("reward",)
    rec = {"qpos": 0.0, **{k: 0.0 for k in rel_fields}, "done_equal": True,
           "obs": {}, "closest_to_threshold": float("inf")}
    blocks = _obs_blocks(envs["cpu"]) if name == "HumanoidTestEnv" else {}
    for c, p in zip(traj["cuda"], traj["cpu"]):
        rec["qpos"] = max(rec["qpos"], float((c.qpos.cpu() - p.qpos)
                                             .abs().max()))
        for k in rel_fields:
            rec[k] = max(rec[k], _rel(getattr(c, k), getattr(p, k)))
        rec["done_equal"] &= bool(torch.equal(c.done.cpu(), p.done))
        for k, sl in blocks.items():
            rec["obs"][k] = max(rec["obs"].get(k, 0.0),
                                _rel(c.obs[:, sl].cpu(), p.obs[:, sl]))
        z = p.qpos[:, 2]
        rec["closest_to_threshold"] = min(
            rec["closest_to_threshold"],
            float(torch.minimum((z - lo).abs(), (z - hi).abs()).min()))
    per_step = _cvc_launches(name)
    rec.update(launches=n, apgd_scan_calls=len(scans),
               launches_per_control_step={k: v / steps for k, v in n.items()},
               done_at_end=int(traj["cpu"][-1].done.sum()),
               card_s_per_control_step=w["seconds"] / steps)
    obs_txt = (", obs per block " + ", ".join(
        f"{k} {v:.3e}" for k, v in rec["obs"].items()) + " of max(1, |x|)"
        ) if blocks else ""
    print(f"{tag} {name}, {n_envs} envs x {steps} control steps, card vs "
          f"CPU from the same starts and actions (bound {ENV_CVC_ATOL}): "
          f"qpos max_abs_diff {rec['qpos']:.3e}, "
          + ", ".join(f"{k} {rec[k]:.3e}" for k in rel_fields)
          + f" of max(1, |x|){obs_txt}; done flags equal at every step "
          f"{rec['done_equal']} ({rec['done_at_end']} done at the end; "
          f"root height's closest approach to {lo}/{hi}: "
          f"{rec['closest_to_threshold']:.4f}); on the card "
          f"{rec['card_s_per_control_step']:.3f} s per control step, APGD "
          f"launches per control step {rec['launches_per_control_step']} "
          f"({n}), _apgd_scan called {len(scans)} times")
    if not (max(rec[k] for k in ("qpos", *rel_fields)) <= ENV_CVC_ATOL
            and rec["done_equal"]
            and all(v <= ENV_CVC_ATOL for v in rec["obs"].values())):
        raise AssertionError(f"{tag} {name}: the card disagrees with the "
                             f"CPU: {rec}")
    want = {k: v * steps for k, v in per_step.items()}
    if n != want or scans:
        raise AssertionError(f"{tag} {name}: APGD launches {n}, expected "
                             f"{want}; _apgd_scan {len(scans)}")
    return rec


def vec_normalize_run(torch, ops, n_envs: int = VECNORM_ENVS,
                      steps: int = VECNORM_STEPS) -> dict:
    """[envs] ``VecNormalize(VectorEnv(HumanoidTestEnv(), n_envs,
    autoreset="init"))`` on the card, ``steps`` steps of 0.1·N(0, 1)
    actions from a seeded generator: the normalized obs finite and within
    ±10 at every step; 21 apgd_solve launches per step plus 1 at each step
    where some env finished (one batch of fresh starts), 1 at the reset."""
    from deepmimic_mujoco_torch.envs.humanoid_test_env import HumanoidTestEnv
    from deepmimic_mujoco_torch.envs.vec_normalize import VecNormalize
    from deepmimic_mujoco_torch.envs.vector import VectorEnv

    norm = VecNormalize(VectorEnv(HumanoidTestEnv(device="cuda"), n_envs,
                                  autoreset="init"))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    _zero_counts(ops)
    state = norm.reset(gen)
    at_reset = ops.apgd_solve.launches
    worst = norm.observe(state).abs().max()
    finite = torch.isfinite(norm.observe(state)).all()
    per_step, fresh = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        n0 = ops.apgd_solve.launches
        a = 0.1 * torch.randn((n_envs, 28), generator=gen, device="cuda")
        state, obs, rew, done = norm.step(state, a, gen)
        per_step.append(ops.apgd_solve.launches - n0)
        fresh.append(bool(done.any()))
        worst = torch.maximum(worst, obs.abs().max())
        finite = finite & torch.isfinite(obs).all() & torch.isfinite(rew).all()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = _counts(ops)
    rec = {"env_steps_per_s": n_envs * steps / dt, "seconds": dt,
           "launches_at_reset": at_reset, "launches_per_step": per_step,
           "steps_with_fresh_starts": sum(fresh), "max_abs_obs": float(worst),
           "finite": bool(finite), "ob_count": float(state.ob_rms.count),
           "ret_std": float(state.ret_rms.std), "launches": n}
    print(f"[envs] VecNormalize(VectorEnv(HumanoidTestEnv(), {n_envs}, "
          f"autoreset='init')), {steps} steps: {rec['env_steps_per_s']:.1f} "
          f"env-steps/s ({dt:.2f} s); normalized obs finite {rec['finite']}, "
          f"max |obs| {rec['max_abs_obs']:.3f} (clip 10); apgd_solve "
          f"launches per step {per_step} ({sum(fresh)} steps with fresh "
          f"starts, 1 launch each), {at_reset} at the reset; return std "
          f"{rec['ret_std']:.4f}")
    want = [ENV_LAUNCHES["HumanoidTestEnv"] + int(f) for f in fresh]
    if not (rec["finite"] and rec["max_abs_obs"] <= 10.0 and per_step == want
            and at_reset == 1 and n["apgd_solve_wide"] == 0):
        raise AssertionError(f"[envs] VecNormalize run off: {rec}")
    return rec


def facade_card_vs_cpu(torch, ops, updates: int = FACADE_UPDATES) -> dict:
    """[envs] ``DeepMimicEnv(reward_mode="imitation")`` on the card and on
    the CPU, from walk's frame 0, ``updates`` calls of ``set_action`` (the
    PD targets of the next frame, ``targets_to_action``) and
    ``update(1/30)``: after each, ``calc_reward`` within 1e-3 and equal
    ``check_terminate``, and ``record_state`` within 1e-3 over the first
    ``FACADE_STATE_UPDATES`` (after them it is reported: the open-loop
    character loses its balance and f32 runs part, see the constant); on
    the card 8 apgd_solve launches per update (2 substeps)."""
    from deepmimic_mujoco_torch.envs.deepmimic_api import DeepMimicEnv
    from deepmimic_mujoco_torch.envs.deepmimic_surface import (
        targets_to_action,
    )

    envs = {d: DeepMimicEnv(reward_mode="imitation", device=d)
            for d in ("cuda", "cpu")}
    clip = envs["cpu"].mocap
    for e in envs.values():
        e.qpos = torch.as_tensor(clip.qpos_cont[0], dtype=torch.float32,
                                 device=e.device)
        e.qvel = torch.as_tensor(clip.qvel_fd[0], dtype=torch.float32,
                                 device=e.device)
    rec = {"record_state": [], "calc_reward": 0.0, "terminate_equal": True,
           "launches_per_update": [], "card_s": 0.0, "rewards": [],
           "terminate": []}
    for k in range(updates):
        act = targets_to_action(clip.qpos_cont[(k + 1) % len(clip), 7:])
        out = {}
        for d, e in envs.items():
            n0 = ops.apgd_solve.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e.set_action(0, act)
            e.update(1.0 / 30.0)
            out[d] = (e.record_state(), e.calc_reward(), e.check_terminate())
            if d == "cuda":
                rec["card_s"] += time.perf_counter() - t0
                rec["launches_per_update"].append(
                    ops.apgd_solve.launches - n0)
        rec["record_state"].append(float(
            abs(out["cuda"][0] - out["cpu"][0]).max()))
        rec["calc_reward"] = max(rec["calc_reward"],
                                 abs(out["cuda"][1] - out["cpu"][1]))
        rec["terminate_equal"] &= out["cuda"][2] == out["cpu"][2]
        rec["rewards"].append(out["cpu"][1])
        rec["terminate"].append(out["cpu"][2])
    held = min(updates, FACADE_STATE_UPDATES)
    state_held = max(rec["record_state"][:held])
    print(f"[envs] DeepMimicEnv(reward_mode='imitation'), {updates} x "
          f"set_action + update(1/30) from walk's frame 0 under the clip's "
          f"PD targets, card vs CPU: record_state max_abs_diff "
          f"{state_held:.3e} over the first {held} updates (atol 1e-3), "
          f"{max(rec['record_state']):.3e} over all {updates} (per update: "
          + ", ".join(f"{d:.1e}" for d in rec["record_state"])
          + f"), calc_reward "
          f"{rec['calc_reward']:.3e} (atol 1e-3), check_terminate equal "
          f"{rec['terminate_equal']} (CPU: {sum(rec['terminate'])} of "
          f"{updates} FAIL); reward on the CPU first/last "
          f"{rec['rewards'][0]:.4f}/{rec['rewards'][-1]:.4f}; on the card "
          f"{1e3 * rec['card_s'] / updates:.1f} ms per update, apgd_solve "
          f"launches per update {sorted(set(rec['launches_per_update']))}")
    if not (state_held <= 1e-3 and rec["calc_reward"] <= 1e-3
            and rec["terminate_equal"]
            and rec["launches_per_update"] == [8] * updates):
        raise AssertionError(f"[envs] the facade on the card disagrees: "
                             f"{rec}")
    return rec


def envs_clis(torch, ops, tmp: str) -> dict:
    """[envs] the CLIs in-process on the card: ``cli.train_trpo --env-id
    DPEnvV1 --task train`` at 256 envs x 16 steps, g_step 1, one iteration
    (its checkpoint reads back; 24 launches per control step);
    ``cli.torque_test --steps 100`` (mean tracking reward within 0.03 of
    the port's CPU figure; 4 launches per step); ``cli.play_mocap --motion
    spinkick --through-dynamics --cycles 1`` (the clip's frames as one
    batch: 4 launches; reward within 0.03 of the CPU's); and
    ``gym_shim.make("DPEnvV2", device="cuda")``, reset and 5 steps (24
    launches per step; without gymnasium ``GymEnv`` derives from
    ``object``)."""
    import numpy as np

    from deepmimic_mujoco_torch.cli import play_mocap, torque_test, train_trpo
    from deepmimic_mujoco_torch.envs import gym_shim
    from deepmimic_mujoco_torch.io_utils import checkpoint
    from deepmimic_mujoco_torch.models.policy import MlpPolicy

    rec = {}
    _zero_counts(ops)
    t0 = time.perf_counter()
    text, state = _quiet(train_trpo.main, [
        "--env-id", "DPEnvV1", "--task", "train", "--num-envs", "256",
        "--timesteps-per-batch", "16", "--g-step", "1", "--num-iters", "1",
        "--seed", str(SEED), "--log-dir", os.path.join(tmp, "logs"),
        "--checkpoint-dir", os.path.join(tmp, "ckpt")])
    dt = time.perf_counter() - t0
    n = _counts(ops)
    run = os.path.join("DPEnvV1", "trpo-walk-0")
    with open(os.path.join(tmp, "logs", run, "progress.csv")) as fh:
        rows = fh.read().strip().splitlines()
    last = dict(zip(rows[0].split(","), rows[-1].split(",")))
    params = checkpoint.load_trpo_params(
        os.path.join(tmp, "ckpt", run, "trpo_state.npz"),
        MlpPolicy(ob_dim=67, ac_dim=28), "cuda")
    same = all(bool(torch.equal(a["w"], b["w"])) for a, b in
               zip(params["pol"], state.params["pol"]))
    rec["train_trpo_v1"] = {"seconds": dt, "launches": n,
                            "progress": last, "checkpoint_reads_back": same}
    print(f"[envs] cli.train_trpo --env-id DPEnvV1 --task train, 256 envs x "
          f"16 steps, g_step 1, 1 iteration, in-process: {dt:.1f} s; "
          f"apgd_solve launches per control step {n['apgd_solve'] / 16:.2f} "
          f"({n}); meankl {last['meankl']}, EpLenMean {last['EpLenMean']}; "
          f"the checkpoint reads back {same}")
    if not (same and len(rows) == 2 and n == {
            "apgd_solve": 24 * 16, "apgd_solve_lanes": 0,
            "apgd_solve_wide": 0}
            and float(last["meankl"]) <= 1.5 * MAX_KL):
        raise AssertionError(f"[envs] the V1 training CLI is off: {rec}")

    _zero_counts(ops)
    text, mean = _quiet(torque_test.main, ["--steps", "100"])
    n = _counts(ops)
    rec["torque_test"] = {"mean_reward": mean, "launches": n}
    print("[envs] cli.torque_test --steps 100 on the card: "
          + " / ".join(text.strip().splitlines())
          + f" (the port on the CPU: {CPU_TORQUE_TEST}); apgd_solve "
          f"launches {n['apgd_solve']}")
    if not (abs(mean - CPU_TORQUE_TEST) <= 0.03
            and n["apgd_solve"] == 4 * 100):
        raise AssertionError(f"[envs] torque_test off: {rec}")

    _zero_counts(ops)
    text, track = _quiet(play_mocap.main, ["--motion", "spinkick",
                                           "--through-dynamics",
                                           "--cycles", "1"])
    n = _counts(ops)
    reward = float(re.findall(r"mean config reward (\S+)", text)[0])
    rec["play_mocap"] = {"mean_reward": reward, "launches": n,
                         "frames": int(track.shape[0])}
    print("[envs] cli.play_mocap --motion spinkick --through-dynamics "
          "--cycles 1 on the card: " + " / ".join(text.strip().splitlines())
          + f" (the port on the CPU: {CPU_PLAY_MOCAP}); apgd_solve launches "
          f"{n['apgd_solve']} (the {track.shape[0]} frames in one batch)")
    if not (abs(reward - CPU_PLAY_MOCAP) <= 0.03 and n["apgd_solve"] == 4):
        raise AssertionError(f"[envs] play_mocap off: {rec}")

    _zero_counts(ops)
    env = gym_shim.make("DPEnvV2", device="cuda")
    obs, _ = env.reset(seed=SEED)
    rews = []
    for _ in range(5):
        obs, r, done, trunc, info = env.step(np.zeros(28, np.float32))
        rews.append(r)
    n = _counts(ops)
    rec["gym_shim"] = {"rewards": rews, "launches": n,
                       "bases": [b.__name__ for b in type(env).__bases__],
                       "mocap_idx": info["mocap_idx"]}
    print(f"[envs] gym_shim.make('DPEnvV2', device='cuda'): GymEnv bases "
          f"{rec['gym_shim']['bases']}, reset + 5 steps, obs {obs.shape} "
          f"finite {bool(np.isfinite(obs).all())}, rewards "
          + ", ".join(f"{r:.4f}" for r in rews)
          + f", mocap_idx {info['mocap_idx']}; apgd_solve launches "
          f"{n['apgd_solve']}")
    if not (obs.shape == (67,) and np.isfinite(obs).all()
            and info["mocap_idx"] == 5 and n["apgd_solve"] == 24 * 5):
        raise AssertionError(f"[envs] the gym shim is off: {rec}")
    return rec


def envs_phase(torch, ops) -> dict:
    """[envs]: TRPO on DPEnvV2 at 4096 envs x 16 steps, the card against
    the CPU for DPEnvV1, DPEnvV2 and HumanoidTestEnv, VecNormalize over a
    4096-env VectorEnv of HumanoidTestEnv, the DeepMimic facade card vs
    CPU, and the CLIs.  Returns the records; ``launches`` is the phase's
    apgd_solve launches on the card."""
    import tempfile

    t0 = time.perf_counter()
    rec = {"train_v2": _train(torch, ops, B_MAIN, kind="v2")}
    launches = rec["train_v2"]["launches"]["apgd_solve"]
    for name in ("DPEnvV1", "DPEnvV2", "HumanoidTestEnv"):
        rec[name] = env_card_vs_cpu(torch, ops, name)
        launches += rec[name]["launches"]["apgd_solve"]
    rec["vec_normalize"] = vec_normalize_run(torch, ops)
    rec["facade"] = facade_card_vs_cpu(torch, ops)
    launches += (rec["vec_normalize"]["launches"]["apgd_solve"]
                 + sum(rec["facade"]["launches_per_update"]))
    with tempfile.TemporaryDirectory() as tmp:
        rec["clis"] = envs_clis(torch, ops, tmp)
    launches += sum(r["launches"]["apgd_solve"]
                    for r in rec["clis"].values())
    rec["launches"] = launches
    rec["seconds"] = time.perf_counter() - t0
    print(f"[envs] the phase took {rec['seconds']:.1f} s; {launches} "
          f"apgd_solve launches")
    return rec


def mode_model(case: str, dev: str):
    """[physics-modes] the model of a case: the exported humanoid imported
    by ``parse_mjcf`` at 16/16 caps (exact-cold, ne 64), the euler
    humanoid, the default humanoid with the Cholesky M⁻¹, or with PGS."""
    import dataclasses

    from deepmimic_mujoco_torch.physics.humanoid import build_humanoid, to_mjcf
    from deepmimic_mujoco_torch.physics.mjcf import parse_mjcf

    if case == "import":
        return parse_mjcf(to_mjcf(), contact_cap=16, limit_cap=16, device=dev)
    if case == "euler":
        return build_humanoid(integrator="euler", device=dev)
    kw = {"cholesky": dict(minv_mode="cholesky"),
          "pgs": dict(solver_mode="pgs")}[case]
    return dataclasses.replace(build_humanoid(device=dev), **kw)


def _imported_models(torch) -> dict:
    """[physics-modes] ``parse_mjcf(to_mjcf(), 16, 16)`` and the shipped
    DeepMimic character on the card: sizes, body masses and positions,
    hinge ranges, gears and qpos0 equal ``build_humanoid()``'s to 1e-6,
    ``minv_mode`` 'ns'; then ``calibrate_minv_mode`` on the card: 'ns' for
    the humanoid, and for the ill-conditioned model of ``tests/
    test_physics.py`` (one body 10⁶ times heavier, armature 10⁵ on four
    hinges) the CPU's choice."""
    import dataclasses

    from deepmimic_mujoco_torch.physics import engine
    from deepmimic_mujoco_torch.physics.deepmimic_character import (
        load_character,
    )
    from deepmimic_mujoco_torch.physics.humanoid import build_humanoid

    ref = build_humanoid(device="cuda")
    t0 = time.perf_counter()
    models = {"mjcf": mode_model("import", "cuda"),
              "character": load_character(
                  os.path.join(ROOT, "assets", "characters",
                               "humanoid3d.json"),
                  os.path.join(ROOT, "assets", "controllers",
                               "humanoid3d_ctrl.json"), device="cuda")}
    load_s = time.perf_counter() - t0
    rec = {"load_s": load_s}
    for name, m in models.items():
        diff = max(float((getattr(m, f) - getattr(ref, f)).abs().max())
                   for f in ("body_mass", "body_pos", "hinge_range",
                             "actuator_gear", "qpos0"))
        sizes = (m.nq, m.nv, m.nu) == (ref.nq, ref.nv, ref.nu)
        rec[name] = {"max_abs_diff": diff, "sizes_equal": sizes,
                     "minv_mode": m.minv_mode, "device": str(m.device)}
        if not (sizes and diff <= 1e-6 and m.minv_mode == "ns"
                and m.device.type == "cuda"):
            raise AssertionError(f"[physics-modes] the imported {name} model "
                                 f"is off: {rec[name]}")
    bad = {}
    for dev in ("cuda", "cpu"):
        m = build_humanoid(device=dev)
        bm, arma = m.body_mass.clone(), m.armature.clone()
        bm[1] *= 1e6
        arma[:4] = 1e5
        bad[dev] = engine.calibrate_minv_mode(
            dataclasses.replace(m, body_mass=bm, armature=arma)).minv_mode
    humanoid = engine.calibrate_minv_mode(ref).minv_mode
    rec.update(calibrate_humanoid=humanoid, calibrate_ill_conditioned=bad)
    print(f"[physics-modes] imported on the card in {load_s:.2f} s: "
          f"parse_mjcf(to_mjcf(), 16, 16) max_abs_diff "
          f"{rec['mjcf']['max_abs_diff']:.3e} and load_character(shipped "
          f"json) {rec['character']['max_abs_diff']:.3e} from "
          f"build_humanoid() (bound 1e-6), minv_mode "
          f"{rec['mjcf']['minv_mode']}/{rec['character']['minv_mode']}; "
          f"calibrate_minv_mode on the card: humanoid {humanoid}, the "
          f"ill-conditioned model {bad['cuda']} (CPU {bad['cpu']})")
    if humanoid != "ns" or bad["cuda"] != bad["cpu"]:
        raise AssertionError(f"[physics-modes] calibration off: {rec}")
    return rec


def _cvc_launches(name: str) -> dict:
    """APGD launches per control step of a card-vs-CPU case, per kernel."""
    if name in MODE_CASES:
        return MODE_LAUNCHES[name]
    return {"apgd_solve": ENV_LAUNCHES[name], "apgd_solve_lanes": 0,
            "apgd_solve_wide": 0}


def _mode_eval(torch, ops, case: str) -> dict:
    """[physics-modes] the bundled walk policy through ``runner.rollout`` on
    ``DPEnvV3(model=mode_model(case))`` at 4096 envs x ``MODE_STEPS[case]``
    steps from walk frames, after one untimed step (the first call's set-up:
    cuSOLVER's for Cholesky, the allocator's): env-steps/s, seconds per
    step, APGD launches per control step (exactly ``MODE_LAUNCHES[case]``,
    no plain solve), finite states."""
    from deepmimic_mujoco_torch.algos import runner
    from deepmimic_mujoco_torch.envs.dp_env_v3 import DPEnvV3
    from deepmimic_mujoco_torch.io_utils import checkpoint
    from deepmimic_mujoco_torch.models.policy import MlpPolicy

    steps = MODE_STEPS[case]
    env = DPEnvV3(model=mode_model(case, "cuda"))
    policy = MlpPolicy(ob_dim=56, ac_dim=28)
    params = checkpoint.load_trpo_params(CKPT, policy, "cuda")
    state = env.reset_at(torch.arange(B_MAIN) % env.clip_len)
    runner.rollout(env, policy, params, state, 1)  # warm-up, not counted
    with _watch(torch, ops) as w:
        out = runner.rollout(env, policy, params, state, steps)
    dt, n, scans = w["seconds"], w["launches"], w["scans"]
    st = out.state
    finite = all(bool(torch.isfinite(x).all())
                 for x in (st.qpos, st.qvel, st.obs))
    rec = {"env_steps_per_s": B_MAIN * steps / dt, "seconds": dt,
           "s_per_step": dt / steps, "launches": n,
           "launches_per_control_step": {k: v / steps for k, v in n.items()},
           "avg_len": float(out.ep_len.float().mean()), "finite": finite,
           "apgd_scan_calls": len(scans)}
    print(f"[physics-modes] {case}: the walk policy, {B_MAIN} envs x {steps} "
          f"steps after 1 untimed: {rec['env_steps_per_s']:.1f} env-steps/s "
          f"({rec['s_per_step']:.4f} s per step), APGD launches per control "
          f"step {rec['launches_per_control_step']}, _apgd_scan called "
          f"{len(scans)} times, mean length {rec['avg_len']:.2f}, finite "
          f"{finite}")
    want = {k: v * steps for k, v in MODE_LAUNCHES[case].items()}
    if not finite or n != want or scans:
        raise AssertionError(f"[physics-modes] {case} at {B_MAIN} envs: "
                             f"{rec}, expected launches {want}")
    return rec


def physics_modes_phase(torch, ops) -> dict:
    """[physics-modes]: the imported models and the calibration, then each
    case at 4096 envs (:func:`_mode_eval`) and card vs CPU
    (:func:`env_card_vs_cpu`).  Returns the records; ``launches`` sums
    each kernel's launches over the phase."""
    t0 = time.perf_counter()
    rec = {"imported": _imported_models(torch)}
    launches = {"apgd_solve": 0, "apgd_solve_lanes": 0, "apgd_solve_wide": 0}
    for case in MODE_CASES:
        rec[case] = {"evaluate": _mode_eval(torch, ops, case),
                     "card_vs_cpu": env_card_vs_cpu(torch, ops, case)}
        for part in rec[case].values():
            for k, v in part["launches"].items():
                launches[k] += v
    rec["launches"] = launches
    rec["seconds"] = time.perf_counter() - t0
    print(f"[physics-modes] the phase took {rec['seconds']:.1f} s; APGD "
          f"launches {launches}")
    return rec


def _smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def dist_phase(torch) -> dict:
    """[dist] data-parallel TRPO across processes (``parallel/``, slice
    11): one NCCL rank spawned (``init_process_group("nccl",
    world_size=1)``) running ``TRPO.iteration`` at 4096 envs x 16 steps,
    against the same iteration (the same draws) in this process within
    1e-6; two gloo ranks on the one card at 4096 envs in total (2048 each)
    x 16 steps, g_step 1: the replicas within 1e-6 and ``sync_check``
    true, the policy leaves and ob_rms within 1e-3 of one process's
    ``_segment_update`` on the ranks' two segments side by side, 4 APGD
    launches per env step on each rank; the ranks' first 16 envs' segments
    updated on 2 ranks on the card and on the CPU (the [train] segment
    check's bounds); the dry run's TRPO, GAIL and dp-PPO steps on 2 gloo
    ranks on the card.  Prints env-steps/s summed over the ranks, the
    collectives per iteration and their seconds, and the card."""
    from deepmimic_mujoco_torch.algos import adam
    from deepmimic_mujoco_torch.algos.trpo import (flatten, policy_leaves,
                                                   vf_leaves)
    from deepmimic_mujoco_torch.parallel import dryrun, mesh

    card = _smi()
    rec = {"card": card}
    per_rank = {"apgd_solve": 4 * DIST_HORIZON, "apgd_solve_lanes": 0,
                "apgd_solve_wide": 0}
    # 1. NCCL at world 1 against this process
    t0 = time.perf_counter()
    [one] = mesh.launch(dryrun.trpo_rank, 1, "nccl",
                        args=("cuda", DIST_ENVS, DIST_HORIZON),
                        device="cuda", timeout=600)
    local = dryrun.run_trpo(None, 0, 1, "cuda", DIST_ENVS, DIST_HORIZON)
    d_one = _rel(one["flat"], local["flat"])
    rec["nccl_world1"] = {
        "max_rel_diff": d_one, "seconds": one["seconds"],
        "collectives": one["collectives"],
        "collective_s": one["collective_s"], "launches": one["launches"],
        "launch_s": time.perf_counter() - t0}
    print(f"[dist] NCCL world 1: TRPO.iteration {DIST_ENVS} envs x "
          f"{DIST_HORIZON} steps in a spawned rank against the same "
          f"iteration in this process: params max diff / max(1, max|x|) "
          f"{d_one:.3e} (bound {DIST_EXACT}); {one['seconds']:.3f} s, "
          f"{one['collectives']} collectives ({one['collective_s']:.3f} s); "
          f"launches {one['launches']}; {card}")
    if not (d_one <= DIST_EXACT and one["synced"]
            and one["launches"] == per_rank == local["launches"]):
        raise AssertionError(f"[dist] NCCL world 1: {rec['nccl_world1']}, "
                             f"in-process launches {local['launches']}")
    # 2. two gloo ranks on the one card, the full width in total, and the
    # dry run's steps in the same launch
    t0 = time.perf_counter()
    ranks = mesh.launch(mesh.run_many, 2, "gloo", args=([
        (dryrun.trpo_rank, ("cuda", DIST_ENVS, DIST_HORIZON, dryrun.SEED,
                            True)),
        (dryrun.dryrun_rank, ("cuda",))],), device="cuda", timeout=900)
    launch_s = time.perf_counter() - t0
    it = [r[0] for r in ranks]
    d_rep = _rel(it[1]["flat"], it[0]["flat"])
    learner = dryrun.walk_learner(torch.device("cuda", 0), DIST_ENVS,
                                   DIST_HORIZON)
    params0 = learner.init(torch.Generator(device="cuda").manual_seed(
        dryrun.SEED)).params
    seg = {k: torch.cat([r["segment"][k] for r in it],
                        dim=0 if k == "nextvpred" else 1).cuda()
           for k in dryrun.SEG_KEYS}
    gen = torch.Generator().manual_seed(SEED)
    perms = torch.stack([torch.randperm(DIST_ENVS * DIST_HORIZON,
                                        generator=gen) for _ in range(3)])
    n_vf = sum(x.numel() for x in vf_leaves(params0))
    p1 = learner._segment_update(params0, adam.init(n_vf, "cuda"), seg,
                                 dryrun.FixedPerms(perms))[0]
    d_pol = _rel(it[0]["pol"], flatten(policy_leaves(p1)))
    d_rms = max(_rel(a, b) for a, b in zip(it[0]["ob_rms"], p1["ob_rms"]))
    step = float((flatten(policy_leaves(p1))
                  - flatten(policy_leaves(params0))).abs().max())
    rate = sum(r["env_steps"] / r["seconds"] for r in it)
    rec["gloo_world2"] = {
        "env_steps_per_s": rate, "seconds": [r["seconds"] for r in it],
        "collectives": [r["collectives"] for r in it],
        "collective_s": [r["collective_s"] for r in it],
        "launches": [r["launches"] for r in it], "replica_rel_diff": d_rep,
        "synced": [r["synced"] for r in it], "one_process_pol": d_pol,
        "one_process_ob_rms": d_rms, "one_process_step": step,
        "meankl": [r["meankl"] for r in it], "launch_s": launch_s}
    print(f"[dist] gloo world 2 on one card: TRPO.iteration "
          f"{DIST_ENVS // 2} + {DIST_ENVS // 2} envs x {DIST_HORIZON} steps, "
          f"g_step 1: {rate:.1f} env-steps/s summed over the ranks "
          f"(iteration {', '.join(f'{r['seconds']:.3f}' for r in it)} s); "
          f"collectives per iteration {[r['collectives'] for r in it]}, "
          f"{', '.join(f'{r['collective_s']:.3f}' for r in it)} s in them; "
          f"apgd_solve launches per rank "
          f"{[r['launches']['apgd_solve'] for r in it]}; replicas differ "
          f"by {d_rep:.3e} (bound {DIST_EXACT}), sync_check "
          f"{[r['synced'] for r in it]}; against one process on the same "
          f"{DIST_ENVS}-env segment: policy {d_pol:.3e}, ob_rms "
          f"{d_rms:.3e} of max(1, max|x|) (bound {DIST_ONE_PROCESS}; the "
          f"policy step {step:.3e}); meankl "
          f"{[round(r['meankl'], 6) for r in it]}")
    if not (d_rep <= DIST_EXACT and all(r["synced"] for r in it)
            and d_pol <= DIST_ONE_PROCESS and d_rms <= DIST_ONE_PROCESS
            and all(r["launches"] == per_rank for r in it)
            and all(r["meankl"] <= 1.5 * MAX_KL for r in it)):
        raise AssertionError(f"[dist] gloo world 2: {rec['gloo_world2']}")
    dry = [r[1] for r in ranks]
    rec["dryrun"] = dry
    print(f"[dist] dry run on 2 gloo ranks on the card: "
          f"{dryrun.summary(2, dry[0])}"
          f"; {dry[0]['collectives']} collectives per rank")
    # 3. card vs CPU: the ranks' first 16 envs, updated on 2 ranks on each
    segs = [{k: (v[:DIST_CVC_ENVS] if k == "nextvpred"
                 else v[:, :DIST_CVC_ENVS]) for k, v in r["segment"].items()}
            for r in it]
    perms = torch.stack([torch.randperm(DIST_CVC_ENVS * DIST_HORIZON,
                                        generator=gen) for _ in range(3)])
    params_cpu = _tree_to(params0, "cpu")
    cvc = mesh.launch(mesh.run_many, 2, "gloo", args=([
        (dryrun.segment_rank, (dev, params_cpu, segs, perms))
        for dev in ("cuda", "cpu")],), device="cuda", timeout=300)
    bounds = {"pol": 1e-4, "vf": 1e-3, "ob_rms": 1e-5, "adam_m": 1e-3,
              "losses": 1e-4, "ev": 1e-4}
    diffs = {}
    for r, (on_card, on_cpu) in enumerate(cvc):
        for k in bounds:
            if k == "ob_rms":
                d = max(_rel(a, b) for a, b in zip(on_card[k], on_cpu[k]))
            else:
                d = _rel(on_card[k], on_cpu[k])
            diffs[k] = max(diffs.get(k, 0.0), d)
    same_step = all((c["stepsize"], c["accepted"]) == (p["stepsize"],
                                                       p["accepted"])
                    for c, p in cvc)
    replicas = max(_rel(cvc[1][i]["pol"], cvc[0][i]["pol"]) for i in (0, 1))
    rec["card_vs_cpu"] = dict(diffs, same_step=same_step,
                              replica_rel_diff=replicas)
    print(f"[dist] card vs CPU, 2 gloo ranks x {DIST_CVC_ENVS} envs x "
          f"{DIST_HORIZON} steps, one _segment_update: max diff / max(1, "
          f"max|x|): " + ", ".join(f"{k} {v:.3e} (bound {bounds[k]:.0e})"
                                   for k, v in diffs.items())
          + f"; step size {cvc[0][0]['stepsize']} / {cvc[0][1]['stepsize']}"
          f", accepted {cvc[0][0]['accepted']} / {cvc[0][1]['accepted']}; "
          f"replicas differ by {replicas:.3e}")
    if not (all(diffs[k] <= bounds[k] for k in bounds) and same_step
            and replicas <= DIST_EXACT
            and all(c["synced"] and p["synced"] for c, p in cvc)):
        raise AssertionError(f"[dist] card vs CPU: {rec['card_vs_cpu']}")
    rec["launches"] = (one["launches"]["apgd_solve"]
                       + local["launches"]["apgd_solve"]
                       + sum(r["launches"]["apgd_solve"] for r in it))
    return rec


def mocap_ingest_phase(torch, ops) -> dict:
    """[mocap-ingest] DeepMimic JSON clips (slice 11): every bundled clip's
    raw frames and loop written as DeepMimic JSON, loaded by
    ``load_deepmimic_json`` and by ``load_clip_native`` (the C++ library
    built here with g++), both held against ``load_npz`` within 1e-12 (f64);
    then the bundled ``walk_r2`` policy on the recipe at 4096 envs x 32
    steps with ``DPEnvV3(clip=<walk.json>)`` and with ``clip="walk"``
    (counted runs): states and rewards exactly equal."""
    import tempfile

    import numpy as np

    from deepmimic_mujoco_torch.algos import runner
    from deepmimic_mujoco_torch.envs.dp_env_v3 import DPEnvV3
    from deepmimic_mujoco_torch.io_utils import checkpoint
    from deepmimic_mujoco_torch.mocap import loader, native
    from deepmimic_mujoco_torch.mocap.registry import (available_clips,
                                                       clip_path)
    from deepmimic_mujoco_torch.models.policy import MlpPolicy
    from deepmimic_mujoco_torch.physics.humanoid import build_humanoid

    rec = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        err = {"json": 0.0, "native": 0.0}
        names = available_clips()
        for name in names:
            with np.load(clip_path(name)) as z:
                frames, loop = z["frames"], str(z["loop"])
            path = os.path.join(tmp, name + ".json")
            with open(path, "w") as fh:
                json.dump({"Loop": loop, "Frames": frames.tolist()}, fh)
            ref = loader.load_npz(clip_path(name))
            for how, clip in (("json", loader.load_deepmimic_json(path)),
                              ("native", native.load_clip_native(path))):
                keys = ("durations", "qpos", "qvel", "raw_frames") + (
                    ("quat_frames",) if how == "json" else ())
                if clip.loop != ref.loop or clip.dt != ref.dt:
                    raise AssertionError(f"[mocap-ingest] {name} {how}: "
                                         f"loop or dt")
                err[how] = max(err[how], *(float(np.abs(
                    getattr(clip, k) - getattr(ref, k)).max()) for k in keys))
        rec.update(clips=len(names), max_abs_err=err,
                   load_s=time.perf_counter() - t0)
        print(f"[mocap-ingest] {len(names)} bundled clips written as "
              f"DeepMimic JSON, loaded by load_deepmimic_json and by the "
              f"native library (g++, built here): max abs diff from "
              f"load_npz {err['json']:.3e} / {err['native']:.3e} (bound "
              f"{INGEST_ATOL}), {rec['load_s']:.2f} s")
        if not (len(names) == 15 and max(err.values()) <= INGEST_ATOL):
            raise AssertionError(f"[mocap-ingest] loaders: {rec}")
        policy = MlpPolicy(**RECIPE_POLICY)
        params = checkpoint.load_trpo_params(CKPT_R2, policy, "cuda")
        outs = {}
        for clip in (os.path.join(tmp, "humanoid3d_walk.json"), "walk"):
            env = DPEnvV3(model=build_humanoid(device="cuda"),
                          **{**RECIPE_ENV, "clip": clip})
            state = env.reset_at(torch.arange(B_MAIN) % env.clip_len)
            with _watch(torch, ops) as w:
                out = runner.rollout(env, policy, params, state,
                                     INGEST_STEPS, record=True)
            outs["json" if clip != "walk" else "npz"] = (out, w)
    (a, wa), (b, wb) = outs["json"], outs["npz"]
    equal = {k: bool(torch.equal(getattr(a.state, k), getattr(b.state, k)))
             for k in ("qpos", "qvel", "obs", "done")}
    equal["rewards"] = bool(torch.equal(a.traj[2], b.traj[2]))
    want = {"apgd_solve": 8 * INGEST_STEPS, "apgd_solve_lanes": 0,
            "apgd_solve_wide": 0}
    rec.update(equal=equal, seconds=[wa["seconds"], wb["seconds"]],
               launches=[wa["launches"], wb["launches"]],
               reward_per_step=float(a.traj[2].mean()))
    print(f"[mocap-ingest] walk_r2 on the recipe, {B_MAIN} envs x "
          f"{INGEST_STEPS} steps, DPEnvV3(clip=<walk.json>) against "
          f"clip='walk': equal {equal}; {wa['seconds']:.2f} / "
          f"{wb['seconds']:.2f} s; reward per step "
          f"{rec['reward_per_step']:.4f}; launches {wa['launches']}")
    if not (all(equal.values()) and wa["launches"] == wb["launches"] == want
            and not wa["scans"] and not wb["scans"]):
        raise AssertionError(f"[mocap-ingest] the JSON clip's run: {rec}")
    return rec


def _profile(torch, runner, env, policy, params, state, steps: int,
             tag: str) -> dict:
    """A ``torch.profiler`` window of ``steps`` env steps (after 2 warm-up
    steps): step time, device busy share, kernel launches per step, the
    APGD kernel's share, top device kernels."""
    runner.rollout(env, policy, params, state, 2)  # warm-up
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        runner.rollout(env, policy, params, state, steps)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    rows = [(getattr(e, "self_device_time_total", 0.0), e.count, e.key)
            for e in prof.key_averages()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    busy_us = sum(r[0] for r in rows)
    solve = [r for r in rows if "apgd_kernel" in r[2]
             or "apgd_wide_kernel" in r[2]]
    apgd_us = sum(r[0] for r in solve)
    apgd_n = sum(r[1] for r in solve) / steps
    launches_per_step = sum(r[1] for r in rows) / steps
    top = sorted(rows, reverse=True)[:5]
    ms = 1e3 * steps
    if busy_us > 0:
        busy = (f"device busy {busy_us / ms:.2f} ms per step "
                f"({100 * busy_us / window_us:.1f}%), {launches_per_step:.0f} "
                f"kernel launches per step, the solve dispatch (APGD kernel) "
                f"{apgd_us / ms:.4f} ms per step over {apgd_n:.0f} launches "
                f"({100 * apgd_us / busy_us:.2f}% of the device time); top: "
                + "; ".join(f"{k[:48]} {t / ms:.3f} ms x{c // steps}"
                            for t, c, k in top))
    else:
        busy = "device time not measured (the profiler showed no kernels)"
    print(f"{tag} {steps} env steps at {state.qpos.shape[0]} envs: "
          f"{window_us / ms:.2f} ms per step, {busy}")
    return {"step_ms": window_us / ms, "busy_ms": busy_us / ms,
            "busy_share": busy_us / window_us,
            "launches_per_step": launches_per_step,
            "apgd_ms": apgd_us / ms, "apgd_launches_per_step": apgd_n}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from deepmimic_mujoco_torch.algos import runner
    from deepmimic_mujoco_torch.cli import train_trpo
    from deepmimic_mujoco_torch.envs.dp_env_v3 import DPEnvV3
    from deepmimic_mujoco_torch.io_utils import checkpoint
    from deepmimic_mujoco_torch.models.policy import MlpPolicy
    from deepmimic_mujoco_torch.ops import apgd as ops
    from deepmimic_mujoco_torch.ops import timing
    from deepmimic_mujoco_torch.physics import solver
    from deepmimic_mujoco_torch.physics.humanoid import build_humanoid

    t_start = time.perf_counter()
    # 1. device
    print(_smi())  # name, power limit

    # 2. build: one nvcc per source, started together
    t0 = time.perf_counter()
    builds = ops.load_kernels(("apgd", "apgd_wide"))
    print(f"[build] both sources in {time.perf_counter() - t0:.1f} s of wall "
          "time")
    ptxas = {}
    for built in builds.values():
        found = _ptxas(built.log)
        ptxas.update(found)
        how = f"{built.seconds:.1f} s" if built.seconds else "reused"
        print(f"[build] {os.path.basename(built.path)}: nvcc {how}; "
              + "; ".join(
                  f"{k}: {v.get('registers')} registers, "
                  f"{v.get('spill_bytes')} spill bytes, "
                  f"{v.get('static_smem')} B static smem"
                  for k, v in sorted(found.items())))
    wide_inst = [f"wide/{dt}/kt{k}" for dt in ("bf16", "f32")
                 for k in range(3, 13)]
    if sorted(ptxas) != sorted(["bf16/general", "bf16/slots8", "f32/general",
                                "f32/slots8", *wide_inst]):
        raise AssertionError(f"ptxas reported {sorted(ptxas)}")

    # 3. kernel against plain, then timing at the main path's shape
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    entry = {
        "apgd_solve": (ops.apgd_solve, lambda x: x, lambda x: x),
        "apgd_solve_lanes": (
            ops.apgd_solve_lanes,
            lambda x: x.permute(*range(1, x.dim()), 0).contiguous(),
            lambda x: x.T),
    }
    err = {name: 0.0 for name in entry}
    plain = {"grouped": ops._apgd_grouped, "interleaved": ops._apgd_scan}
    for a_dtype in (torch.float32, torch.bfloat16):
        a, b, mu, f0 = _problem(torch, B_MAIN, a_dtype, gen)
        for rows, iters in ((r, i) for r in plain for i in (15, 8, 60)):
            ref = plain[rows](a, b, mu, f0, iterations=iters, nc=NC, nl=NL)
            for name, (fn, to_layout, back) in entry.items():
                out = back(fn(to_layout(a), to_layout(b), to_layout(mu),
                              to_layout(f0), iterations=iters, nc=NC, nl=NL,
                              rows=rows))
                torch.cuda.synchronize()
                e = float((out - ref).abs().max())
                err[name] = max(err[name], e)
                print(f"[kernel] {name} A={str(a_dtype)[6:]} rows={rows} "
                      f"iters={iters}: max_abs_err {e:.3e} (|ref| max "
                      f"{float(ref.abs().max()):.3f}, atol {ATOL})")
                if not e <= ATOL:
                    raise AssertionError(f"{name} disagrees with the plain "
                                         f"version: {e} > {ATOL}")
    # the solver's dispatch (interleaved layout) against the plain oracle
    dispatch_of = {"blocks": "apgd_solve", "lanes": "apgd_solve_lanes"}
    layout_of = {v: k for k, v in dispatch_of.items()}
    a, b, mu, f0 = _problem(torch, B_MAIN, torch.bfloat16, gen)
    ref = ops._apgd_scan(a, b, mu, f0, iterations=15, nc=NC, nl=NL)
    for layout in ("blocks", "lanes"):
        out = ops.apgd(a, b, mu, f0, iterations=15, nc=NC, nl=NL,
                       layout=layout)
        e = float((out - ref).abs().max())
        err[dispatch_of[layout]] = max(err[dispatch_of[layout]], e)
        print(f"[kernel] dispatch layout={layout}: max_abs_err {e:.3e}")
        if not e <= ATOL:
            raise AssertionError(f"dispatch {layout}: {e} > {ATOL}")
    # ... and on the dual systems of the main path: bf16, many inactive rows
    # (a zero row with 1 on the diagonal)
    env = DPEnvV3(model=build_humanoid(device="cuda"))
    policy = MlpPolicy(ob_dim=56, ac_dim=28)
    params = checkpoint.load_trpo_params(CKPT, policy, "cuda")
    state = env.reset_at(torch.arange(B_MAIN) % env.clip_len)
    systems = _capture(solver, runner, env, policy, params, state, 3)
    a_sys = torch.stack([s_[0].float() for s_ in systems])
    diag = torch.diagonal(a_sys, dim1=-2, dim2=-1)
    inactive = float(((a_sys.abs().sum(-1) == 1) & (diag == 1)).float().mean())
    # Their forces reach ~10^3, where one f32 ulp (2.4e-4 at 2,048) exceeds
    # 1e-4: the bound there is ATOL in units of the system's largest force
    # (max(1, max|f|)), which is ATOL itself on the O(1) random systems.  The
    # inactive rows are held to ATOL absolute.  A second witness: the plain
    # version on the CPU, whose distance from the card's plain version is
    # the reference's own f32 rounding spread on these systems.
    refs = []
    for a_c, b_c, mu_c, f0_c, n_it in systems:
        a_row = a_c.float()
        dead = ((a_row.abs().sum(-1) == 1)
                & (torch.diagonal(a_row, dim1=-2, dim2=-1) == 1))
        for iters in (n_it, 60):
            kw = dict(iterations=iters, nc=NC, nl=NL)
            ref = ops._apgd_scan(a_c, b_c, mu_c, f0_c, **kw)
            ref_cpu = ops._apgd_scan(a_c.cpu(), b_c.cpu(), mu_c.cpu(),
                                     f0_c.cpu(), **kw).to("cuda")
            refs.append((a_c, b_c, mu_c, f0_c, kw, dead, ref, ref_cpu))
    spread = max(float((r[7] - r[6]).abs().max()) for r in refs)
    spread_rel = max(float((r[7] - r[6]).abs().max())
                     / max(1.0, float(r[6].abs().max())) for r in refs)
    main_err = {}
    for layout in ("blocks", "lanes"):
        e_max, e_cpu, e_dead, ref_max, worst = 0.0, 0.0, 0.0, 0.0, 0.0
        for a_c, b_c, mu_c, f0_c, kw, dead, ref, ref_cpu in refs:
            out = ops.apgd(a_c, b_c, mu_c, f0_c, layout=layout, **kw)
            d, d_cpu = (out - ref).abs(), (out - ref_cpu).abs()
            scale = max(1.0, float(ref.abs().max()))
            e_max, ref_max = max(e_max, float(d.max())), max(ref_max, scale)
            e_cpu = max(e_cpu, float(d_cpu.max()))
            e_dead = max(e_dead, float(torch.where(dead, d, 0.0).max()))
            worst = max(worst, float(d.max()) / scale,
                        float(d_cpu.max()) / scale)
        main_err[dispatch_of[layout]] = (e_max, ref_max)
        print(f"[kernel] dispatch layout={layout} on {len(systems)} dual "
              f"systems of 3 main-path steps ({systems[0][0].dtype}, "
              f"{100 * inactive:.1f}% inactive rows), at their own "
              f"iterations and at 60: max_abs_err {e_max:.3e} against the "
              f"plain version on the card, {e_cpu:.3e} against it on the "
              f"CPU (|ref| max {ref_max:.3f}); the two plain versions differ "
              f"by {spread:.3e} ({spread_rel:.3e} of max(1, max|f|)); "
              f"inactive rows {e_dead:.3e} (atol {ATOL}); max error / "
              f"max(1, max|f|) {worst:.3e} (bound {ATOL})")
        if not (worst <= ATOL and e_dead <= ATOL):
            raise AssertionError(f"dispatch {layout} on the main path's "
                                 f"systems: {worst}, inactive rows {e_dead}")
    iters = 15  # stage 1 of the main path; stages 2-4 run 8
    step_iters = (15, 8, 8, 8)
    bound_s, bound_by = _bound(B_MAIN, iters)
    times = {}
    for name, (fn, to_layout, _) in entry.items():
        args = [to_layout(x) for x in (a, b, mu, f0)]
        kw = dict(nc=NC, nl=NL)
        # ms: CUDA events around 200 launches made from Python (the
        # wrapper's host time when that is the longer);
        # device ms: the same launches replayed from a CUDA graph, also at
        # 0 and 60 iterations (the fixed cost and the cost per iteration)
        ms = timing.eager_ms(lambda: fn(*args, iterations=iters, **kw), 200)
        dev = {it: timing.graph_ms(lambda: fn(*args, iterations=it, **kw),
                                   calls=50, replays=4)
               for it in (0, iters, 60)}
        plain_ms = timing.eager_ms(
            lambda: ops._apgd_grouped(a, b, mu, f0, iterations=iters, **kw),
            20)
        times[name] = (ms, dev, plain_ms)
        print(f"[kernel] {name} B={B_MAIN} ne={NE} bf16 iters={iters}: "
              f"{ms:.4f} ms (CUDA events over 200 launches from Python), "
              f"device {dev[iters]:.4f} ms (the same from a CUDA graph; "
              f"{dev[0]:.4f} ms at 0 iterations, {dev[60]:.4f} at 60: "
              f"{1e3 * (dev[60] - dev[0]) / 60:.3f} us per iteration), plain "
              f"{plain_ms:.4f} ms, bound {bound_s * 1e3:.4f} ms "
              f"({bound_by}), library call: none")
    step_bound = sum(_bound(B_MAIN, it)[0] for it in step_iters)
    step_ms = {}
    for layout in ("blocks", "lanes"):
        kw = dict(nc=NC, nl=NL)
        def step(layout=layout):
            return [ops.apgd(a, b, mu, f0, iterations=it, layout=layout, **kw)
                    for it in step_iters]
        step_ms[layout] = (timing.eager_ms(step, 100),
                           timing.graph_ms(step, calls=10))
        plain_ms = timing.eager_ms(lambda: [
            ops._apgd_scan(a, b, mu, f0, iterations=it, **kw)
            for it in step_iters], 5)
        print(f"[kernel] one env step's 4 solves (15+8+8+8 iterations) "
              f"through apgd(layout={layout}), B={B_MAIN} bf16: "
              f"{step_ms[layout][0]:.4f} ms from Python, device "
              f"{step_ms[layout][1]:.4f} ms (CUDA graph), plain "
              f"{plain_ms:.4f} ms, bound {step_bound * 1e3:.4f} ms (bytes, "
              f"4 solves)")

    # the wide kernel (ne > 32) against the plain version, its time, and
    # the larger-caps paths that run it (counts set to 0 before each)
    wide = _wide_kernel(torch, ops, timing)
    for k in (f"wide/{dt}/kt{n}" for dt in ("bf16", "f32") for n in (4, 9)):
        print(f"[kernel] apgd_wide.cu {k} (ne {16 * int(k[-1]) - 15}-"
              f"{16 * int(k[-1])}): {ptxas[k].get('registers')} "
              f"registers, {ptxas[k].get('spill_bytes')} spill bytes, "
              f"{ptxas[k].get('static_smem')} B static shared memory")
    wide_launches = _larger_caps(torch, ops)

    # 4. main path, before any profiler session: after the profiler has
    # traced the card, later kernel launches of the process can cost more
    # host time (PERF.md §7)
    def evaluate(n_envs, layout, horizon=HORIZON):
        ops.apgd_solve.launches = 0
        ops.apgd_solve_lanes.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = train_trpo.main([
            "--task", "evaluate", "--load-model-path", CKPT,
            "--eval-episodes", str(n_envs), "--eval-horizon", str(horizon),
            "--motion", "walk", "--apgd-layout", layout,
            "--device", "cuda", "--seed", str(SEED)])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = {k: fn.launches for k, fn in (("blocks", ops.apgd_solve),
                                          ("lanes", ops.apgd_solve_lanes))}
        want = {k: (4 * horizon if k == layout else 0) for k in n}
        if n != want:
            raise AssertionError(f"APGD launches {n}, expected {want}")
        st = res.rollout.state
        finite = all(bool(torch.isfinite(x).all())
                     for x in (st.qpos, st.qvel, st.obs))
        if not (finite and res.avg_len > 0):
            raise AssertionError(f"main path: finite={finite} "
                                 f"avg_len={res.avg_len}")
        print(f"[main] evaluate {n_envs} envs x {horizon} steps, "
              f"layout={layout}: avg_len {res.avg_len:.2f} avg_ret "
              f"{res.avg_ret:.2f}, {dt:.2f} s, "
              f"{n_envs * horizon / dt:.1f} env-steps/s, launches {n}")
        return n[layout]

    launches = {"apgd_solve": 0, "apgd_solve_lanes": 0}
    # the lanes layout at 768 envs only: a 4096-env run would measure the
    # same kernel as the 768-env one
    for n_envs, horizon, layout in ((B_MAIN, HORIZON, "blocks"),
                                    (768, HORIZON_768, "blocks"),
                                    (768, HORIZON_768, "lanes")):
        launches[dispatch_of[layout]] += evaluate(n_envs, layout, horizon)

    # training: TRPO.iteration at 768 and 4096 envs, one segment update on
    # the card against the CPU, and the training CLI; still before any
    # profiler session
    train = {768: _train(torch, ops, 768, horizon=TRAIN_HORIZON_768,
                         warm_up=True),
             B_MAIN: _train(torch, ops, B_MAIN)}
    launches["apgd_solve"] += sum(r["launches"]["apgd_solve"]
                                  for r in train.values())
    seg_diff = _segment_card_vs_cpu(torch)
    _train_cli()

    # the imitation recipe: evaluation of walk_r2, then training; still
    # before any profiler session
    imit = {"evaluate": _imitation_eval(torch, ops, train_trpo)}
    imit["train"] = _train(torch, ops, B_MAIN, kind="recipe")
    launches["apgd_solve"] += (imit["evaluate"]["launches"]["apgd_solve"]
                               + imit["train"]["launches"]["apgd_solve"])
    _train_cli(recipe=True)

    # the multi-clip path: DPEnvV3Multi card vs CPU, the multi-skill
    # policy's evaluation, then the TRPO lanes (evaluation, training resumed
    # and fresh, one segment update card vs CPU); before any profiler
    # session
    import tempfile

    multi = {"card_vs_cpu": _multi_card_vs_cpu(torch, ops),
             "eval_multiskill": _multi_eval(torch, ops)}
    with tempfile.TemporaryDirectory() as tmp:
        lanes_rec = {"evaluate": _lane_eval(torch, ops, tmp)}
    lanes_rec["train_resumed"] = _lane_train(torch, ops, resumed=True)
    lanes_rec["train_fresh"] = _lane_train(torch, ops, resumed=False)
    lanes_rec["segment_card_vs_cpu"] = _lane_segment_card_vs_cpu(torch)
    launches["apgd_solve"] += sum(
        r["launches"]["apgd_solve"] for r in (
            multi["card_vs_cpu"], multi["eval_multiskill"],
            lanes_rec["evaluate"], lanes_rec["train_resumed"],
            lanes_rec["train_fresh"]))

    # GAIL from the bundled r4 run (evaluation, resumed training, one d-step
    # and segment update card vs CPU, the CLI with BC), then PPO (the CLI at
    # bench.py's width, one iteration card vs CPU); before any profiler
    # session
    gail = {"evaluate": _gail_eval(torch, ops),
            "train_resumed": _gail_train(torch, ops),
            "card_vs_cpu": _gail_card_vs_cpu(torch)}
    with tempfile.TemporaryDirectory() as tmp:
        gail["cli"] = _gail_cli(torch, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        ppo = {"train_cli": _ppo_cli(torch, ops, train_trpo, tmp)}
    ppo["card_vs_cpu"] = _ppo_card_vs_cpu(torch)
    launches["apgd_solve"] += sum(
        r["launches"]["apgd_solve"] for r in (
            gail["evaluate"], gail["train_resumed"], ppo["train_cli"]))

    # the original DeepMimic PPO stack from the bundled r5 run: evaluation,
    # the training CLI resumed, one train iteration card vs CPU, the CLI on
    # v3, get_action; before any profiler session
    from deepmimic_mujoco_torch.cli import train_ppo

    dp = {"evaluate": _dp_eval(torch, ops)}
    with tempfile.TemporaryDirectory() as tmp:
        dp["train_cli"] = _dp_train(torch, ops, train_ppo, tmp)
    dp["card_vs_cpu"] = _dp_card_vs_cpu(torch)
    with tempfile.TemporaryDirectory() as tmp:
        dp["v3"] = _dp_v3(torch, ops, train_ppo, tmp)
    dp["get_action"] = _dp_get_action()
    launches["apgd_solve"] += sum(
        dp[k]["launches"]["apgd_solve"] for k in ("evaluate", "train_cli",
                                                   "v3"))

    # the other envs (DPEnvV1, DPEnvV2, HumanoidTestEnv), VecNormalize over a
    # VectorEnv, the DeepMimic facade and their CLIs; before any profiler
    # session
    envs_rec = envs_phase(torch, ops)
    launches["apgd_solve"] += envs_rec["launches"]

    # the physics-fidelity modes and the imported models (euler, the
    # Cholesky M⁻¹, PGS, parse_mjcf at 16/16 caps); before any profiler
    # session
    modes = physics_modes_phase(torch, ops)
    launches["apgd_solve"] += modes["launches"]["apgd_solve"]
    wide_launches += modes["launches"]["apgd_solve_wide"]

    # data-parallel TRPO across processes (NCCL at world 1, gloo at world 2
    # on the one card, card vs CPU, the dry run) and the DeepMimic JSON
    # clips; before any profiler session
    dist = dist_phase(torch)
    launches["apgd_solve"] += dist["launches"]
    ingest = mocap_ingest_phase(torch, ops)
    launches["apgd_solve"] += sum(n["apgd_solve"]
                                  for n in ingest["launches"])

    # one env step's four solves through the dispatch: the wrappers' counts
    # give the launches; profiler windows show what ran on the device (a
    # window may miss a kernel's record, so the most any window saw is read)
    for layout in ("blocks", "lanes"):
        counts, n_host = [], []
        for _ in range(3):
            n0 = ops.apgd_solve.launches + ops.apgd_solve_lanes.launches
            names = timing.device_kernels(lambda: [
                ops.apgd(a, b, mu, f0, iterations=it, nc=NC, nl=NL,
                         layout=layout) for it in step_iters])
            n_host.append(ops.apgd_solve.launches
                          + ops.apgd_solve_lanes.launches - n0)
            counts.append((len(names),
                           sum("apgd_kernel" in n for n in names)))
        print(f"[kernel] one env step's 4 solves through apgd(layout="
              f"{layout}): {n_host[0]} APGD launches counted by the "
              f"wrappers; device launches (all, APGD) in 3 profiler "
              f"windows: {counts}")
        if n_host != [4, 4, 4]:
            raise AssertionError(f"apgd(layout={layout!r}) counted {n_host}")
        if layout == "blocks" and not (
                all(n == k for n, k in counts) and max(counts)[0] == 4):
            raise AssertionError(f"apgd(layout='blocks') ran {counts}")

    # where an env step's time goes: a profiled window of 5 steps at 4096
    # (blocks layout, whose solve dispatch launches the APGD kernel alone),
    # then 3 steps of the imitation recipe at 4096
    _profile(torch, runner, env, policy, params, state, 5, "[profile]")
    imit_env = DPEnvV3(model=build_humanoid(device="cuda"), **RECIPE_ENV)
    imit_policy = MlpPolicy(**RECIPE_POLICY)
    imit["profile"] = _profile(
        torch, runner, imit_env, imit_policy,
        checkpoint.load_trpo_params(CKPT_R2, imit_policy, "cuda"),
        imit_env.reset_at(torch.arange(B_MAIN) % imit_env.clip_len), 3,
        "[imitation] [profile]")
    # a PGS step's launches (its sweeps are plain PyTorch) and the imported
    # model's exact-cold step, the first user path on the wide kernel
    for case in ("pgs", "import"):
        m_env = DPEnvV3(model=mode_model(case, "cuda"))
        modes[case]["profile"] = _profile(
            torch, runner, m_env, policy, params,
            m_env.reset_at(torch.arange(B_MAIN) % m_env.clip_len), 2,
            f"[physics-modes] [profile] {case}")

    # the card's rollout against the CPU's (plain versions), small input
    idx = torch.arange(16) * 2 % 39
    out = {}
    for dev in ("cuda", "cpu"):
        env = DPEnvV3(model=build_humanoid(device=dev))
        policy = MlpPolicy(ob_dim=56, ac_dim=28)
        params = checkpoint.load_trpo_params(CKPT, policy, dev)
        out[dev] = runner.rollout(env, policy, params, env.reset_at(idx), 20)
    d_q = float((out["cuda"].state.qpos.cpu() - out["cpu"].state.qpos).abs().max())
    same_len = bool((out["cuda"].ep_len.cpu() == out["cpu"].ep_len).all())
    print(f"[main] 16 envs x 20 steps, card vs CPU: qpos max_abs_diff "
          f"{d_q:.3e} (atol {ROLLOUT_ATOL}), ep_len equal {same_len}")
    if not (d_q <= ROLLOUT_ATOL and same_len):
        raise AssertionError("the card's rollout disagrees with the CPU's")
    imit["card_vs_cpu"] = _imitation_card_vs_cpu(torch)

    # 5. report
    kernels = []
    # the Pallas kernel bodies: _apgd_kernel and _apgd_kernel_lanes
    for name, line in (("apgd_solve", 68), ("apgd_solve_lanes", 118)):
        ms, dev, plain_ms = times[name]
        a_main = a if name == "apgd_solve" else entry[name][1](a)
        plan = ops.launch_plan(a_main, NC, lanes=name != "apgd_solve")
        inst = ptxas["bf16/slots8"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "deepmimic_mujoco_torch/ops/csrc/apgd.cu",
            "replaces": f"deepmimic_mujoco_tpu/ops/apgd.py:{line}",
            "launches": launches[name], "max_abs_err": err[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_s * 1e3,
            "bound_by": bound_by, "library_ms": None,
            "registers": inst.get("registers"),
            "spill_bytes": inst.get("spill_bytes"),
            "smem_bytes": plan["smem"] + inst.get("static_smem", 0),
            "device_ms": dev[iters], "device_ms_0_iterations": dev[0],
            "device_ms_60_iterations": dev[60],
            "main_path_max_abs_err": main_err[name][0],
            "main_path_max_abs_f": main_err[name][1],
            "step_ms": step_ms[layout_of[name]][0],
            "step_device_ms": step_ms[layout_of[name]][1],
            "step_bound_ms": step_bound * 1e3,
            "ptxas": ptxas})
    w64 = wide["ne=64 bfloat16"]
    kernels.append({
        "name": "apgd_solve_wide", "route": "cuda",
        "source": "deepmimic_mujoco_torch/ops/csrc/apgd_wide.cu",
        # no Pallas kernel computes ne > 32: it replaces make_apgd's XLA
        # route, _apgd_scan
        "replaces": "deepmimic_mujoco_tpu/ops/apgd.py:181",
        "launches": wide_launches,
        "max_abs_err": max(r["max_abs_err"] for r in wide.values()),
        **{k: w64[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None, "shape": "B 4096, ne 64 (16/16 caps), bf16 A, "
                                     "15 iterations",
        "device_ms": w64["device_ms"],
        "registers": ptxas["wide/bf16/kt4"].get("registers"),
        "spill_bytes": ptxas["wide/bf16/kt4"].get("spill_bytes"),
        "smem_bytes": w64["plan"]["smem"],
        "shapes": wide, "ptxas": {k: ptxas[k] for k in wide_inst}})
    kernels[0]["train"] = {str(n): r for n, r in train.items()}
    kernels[0]["train_segment_card_vs_cpu"] = seg_diff
    kernels[0]["imitation"] = imit
    kernels[0]["multi"] = multi
    kernels[0]["trpo_lanes"] = lanes_rec
    kernels[0]["gail"] = gail
    kernels[0]["ppo"] = ppo
    kernels[0]["dp_ppo"] = dp
    kernels[0]["envs"] = envs_rec
    kernels[0]["physics_modes"] = modes
    kernels[0]["dist"] = dist
    kernels[0]["mocap_ingest"] = ingest
    print(f"[done] {time.perf_counter() - t_start:.1f} s after the imports")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def dp_witness() -> int:
    """``python3 chip_smoke.py --dp-witness``: the [dp-ppo] card-vs-CPU
    check of one train iteration with the card's solve on the kernel and on
    the plain version, each with the dual matrix stored in bf16 (the
    surface's) and in f32, reported without failing; then the kernel's run
    with each planted fault, which the parameters' check must catch.  The
    readings say where the card's physics states part from the CPU's."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from deepmimic_mujoco_torch.ops import apgd as ops

    print(_smi())
    ops.load_kernels(("apgd",))
    rec = {}
    for dtype in ("bf16", "f32"):
        for solve in ("kernel", "plain"):
            faults = (("critic", "actor", "sample_count")
                      if (dtype, solve) == ("bf16", "kernel") else ())
            rec[f"{dtype}/{solve}"] = _dp_card_vs_cpu(
                torch, dtype, solve, faults=faults, check=False)
    print(json.dumps({"dp_witness": rec}))
    return 0


def wide_vs(old_src: str) -> int:
    """``python3 chip_smoke.py --wide-vs OLD.cu``: the wide kernel of this
    checkout against another version of ``apgd_wide.cu`` with the same C
    entry point (``apgd_wide_launch``), built here with the same flags: at
    each shape of ``_wide_shapes`` and at ne 192, both against the plain
    version, then their device times (a CUDA graph of 20 launches,
    replayed) and times from Python (CUDA events) in turns, old, new, new,
    old, on the same inputs; one JSON line before the last."""
    import ctypes

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from deepmimic_mujoco_torch.ops import _build
    from deepmimic_mujoco_torch.ops import apgd as ops
    from deepmimic_mujoco_torch.ops import timing

    print(_smi())
    ops.load_kernels(("apgd_wide",))
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(_build.BUILD_DIR, "libapgd_wide_other.so")
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib_path,
                    old_src], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(lib_path)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.apgd_wide_launch.argtypes = [ptr, i32, ptr, ptr, ptr, ptr, ptr, i64,
                                     i32, i32, i32, ptr]
    lib.apgd_wide_launch.restype = ctypes.c_int

    def old_solve(a, b, mu, f0, *, iterations, nc, nl):
        out = torch.empty_like(b)
        err = lib.apgd_wide_launch(
            a.data_ptr(), a.dtype is torch.bfloat16, b.data_ptr(),
            mu.data_ptr(), f0.data_ptr(), out.data_ptr(),
            ops._momentum_table(iterations, a).data_ptr(), b.shape[0],
            b.shape[1], nc, iterations,
            torch._C._cuda_getCurrentRawStream(a.get_device()))
        if err != 0:
            raise RuntimeError(f"{old_src}: cudaError {err}")
        return out

    solves = {"old": old_solve, "new": ops.apgd_solve_wide}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rec = {}
    # and MAX_NE_WIDE, where f32 A is kept as f32 and split per iteration
    largest = [("ne=192", 50, 42, dt, 15)
               for dt in (torch.float32, torch.bfloat16)]
    for label, nc, nl, a_dtype, iters in _wide_shapes(torch) + largest:
        es = 2 if a_dtype is torch.bfloat16 else 4
        a, b, mu, f0 = _problem(torch, B_MAIN, a_dtype, gen, nc, nl)
        kw = dict(iterations=iters, nc=nc, nl=nl)
        ref = ops._apgd_scan(a, b, mu, f0, **kw)
        err = {k: float((fn(a, b, mu, f0, **kw) - ref).abs().max())
               for k, fn in solves.items()}
        dev = {"old": [], "new": []}
        ms = {"old": [], "new": []}
        for who in ("old", "new", "new", "old"):
            fn = solves[who]
            dev[who].append(timing.graph_ms(
                lambda: fn(a, b, mu, f0, **kw), calls=20, replays=2))
            ms[who].append(timing.eager_ms(lambda: fn(a, b, mu, f0, **kw),
                                           50))
        bound_s, bound_by = _bound(B_MAIN, iters, nc, nl, es)
        key = f"{label} {str(a_dtype)[6:]}"
        rec[key] = {"iterations": iters, "max_abs_err": err,
                    "device_ms": dev, "ms": ms, "bound_ms": bound_s * 1e3,
                    "bound_by": bound_by}
        print(f"[wide-vs] B={B_MAIN} {key} iters={iters}: device ms old "
              f"{dev['old'][0]:.4f} / {dev['old'][1]:.4f}, new "
              f"{dev['new'][0]:.4f} / {dev['new'][1]:.4f}; from Python old "
              f"{ms['old'][0]:.4f} / {ms['old'][1]:.4f}, new "
              f"{ms['new'][0]:.4f} / {ms['new'][1]:.4f}; bound "
              f"{bound_s * 1e3:.4f} ({bound_by}); max_abs_err old "
              f"{err['old']:.3e}, new {err['new']:.3e} (atol {ATOL})")
        if not max(err.values()) <= ATOL:
            raise AssertionError(f"{key}: {err}")
    print(json.dumps({"wide_vs": rec}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--dp-witness"]:
        sys.exit(dp_witness())
    if sys.argv[1:2] == ["--wide-vs"] and len(sys.argv) == 3:
        sys.exit(wide_vs(sys.argv[2]))
    sys.exit(main())
