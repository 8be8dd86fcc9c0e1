"""The port's walk evaluation (env, policy, checkpoint reader, runner, CLI)
against the JAX reference on the CPU.

The bundled checkpoint ``train_ckpt/DPEnvV3/trpo-walk-0/trpo_state.npz``
is loaded into both stacks; the slice test runs the JAX package's own
``evaluate`` (one jitted rollout program) and the port's rollout from the
same mocap frames."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepmimic_mujoco_tpu.algos.ppo import PPO, PPOConfig
from deepmimic_mujoco_tpu.algos.runner import evaluate as jax_evaluate
from deepmimic_mujoco_tpu.algos.trpo import TRPO, TRPOConfig
from deepmimic_mujoco_tpu.envs import DPEnvV3 as JaxDPEnvV3
from deepmimic_mujoco_tpu.io_utils import checkpoint as jax_checkpoint
from deepmimic_mujoco_tpu.models import MlpPolicy as JaxMlpPolicy
from deepmimic_mujoco_torch.algos import runner
from deepmimic_mujoco_torch.algos.trpo import pick_reset_fn
from deepmimic_mujoco_torch.cli import train_trpo
from deepmimic_mujoco_torch.envs.dp_env_v3 import DPEnvV3
from deepmimic_mujoco_torch.io_utils import checkpoint
from deepmimic_mujoco_torch.models.policy import MlpPolicy
from deepmimic_mujoco_torch.utils.device import PLATFORMS

torch.set_num_threads(1)

CKPT = os.path.join(os.path.dirname(__file__), "..", "train_ckpt", "DPEnvV3",
                    "trpo-walk-0", "trpo_state.npz")


@pytest.fixture(scope="module")
def jax_side():
    env = JaxDPEnvV3(clip="walk")
    policy = JaxMlpPolicy(ob_dim=56, ac_dim=28)
    like = TRPO(env, policy, TRPOConfig(num_envs=8)).init(
        jax.random.PRNGKey(0))
    # the bundled checkpoint predates EnvState.clip_id: its structure string
    # differs from a fresh TRPOState's after the policy leaves, whose shapes
    # all line up — the JAX loader's documented opt-in for that case
    params = jax_checkpoint.load(CKPT, like, allow_structure_drift=True).params
    return env, policy, params


@pytest.fixture(scope="module")
def port_side():
    env = DPEnvV3(clip="walk", device="cpu")
    policy = MlpPolicy(ob_dim=56, ac_dim=28)
    return env, policy, checkpoint.load_trpo_params(CKPT, policy, "cpu")


# ---------------------------------------------------------------------------
# checkpoint reader and policy


def test_checkpoint_reader_matches_jax_loader(jax_side, port_side):
    _, _, jp = jax_side
    _, _, tp = port_side
    for head in ("pol", "vf"):
        for jl, tl in zip(jp[head], tp[head]):
            for k in ("w", "b"):
                np.testing.assert_array_equal(tl[k].numpy(), np.asarray(jl[k]))
    np.testing.assert_array_equal(tp["logstd"].numpy(),
                                  np.asarray(jp["logstd"]))
    for jx, tx in zip(jp["ob_rms"], tp["ob_rms"]):
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))


def test_from_numpy_params_carries_jax_params(jax_side, port_side):
    _, _, jp = jax_side
    tp = checkpoint.from_numpy_params(jax.tree.map(np.asarray, jp), "cpu")
    np.testing.assert_array_equal(tp["pol"][2]["w"].numpy(),
                                  np.asarray(jp["pol"][2]["w"]))
    np.testing.assert_array_equal(tp["ob_rms"].count.numpy(),
                                  np.asarray(jp["ob_rms"].count))


def test_checkpoint_reader_accepts_both_trpo_state_layouts(jax_side,
                                                           tmp_path):
    """A checkpoint written by the current JAX code (EnvState with
    ``clip_id``) reads the same policy leaves as the bundled one."""
    env, policy, _ = jax_side
    state = TRPO(env, policy, TRPOConfig(num_envs=2)).init(
        jax.random.PRNGKey(1))
    jax_checkpoint.save(str(tmp_path / "fresh.npz"), state)
    tp = checkpoint.load_trpo_params(str(tmp_path / "fresh.npz"),
                                     MlpPolicy(56, 28), "cpu")
    np.testing.assert_array_equal(tp["vf"][0]["w"].numpy(),
                                  np.asarray(state.params["vf"][0]["w"]))
    np.testing.assert_array_equal(tp["ob_rms"].var.numpy(),
                                  np.asarray(state.params["ob_rms"].var))


def test_checkpoint_reader_rejects_other_structures(tmp_path):
    with np.load(CKPT) as z:
        arrays = {k: z[k] for k in z.files}
    bad = dict(arrays, __treedef__=np.frombuffer(b"PyTreeDef(*)", np.uint8))
    np.savez(tmp_path / "bad.npz", **bad)
    with pytest.raises(ValueError, match="not a TRPOState"):
        checkpoint.load_trpo_params(str(tmp_path / "bad.npz"),
                                    MlpPolicy(56, 28), "cpu")
    with pytest.raises(ValueError, match="layer 0"):
        checkpoint.load_trpo_params(CKPT, MlpPolicy(56, 28, hid_size=64),
                                    "cpu")


def test_deterministic_actions_and_values_match_jax(jax_side, port_side):
    """f32 MLP on the same obs: 1e-5 (sums in another order)."""
    _, jpol, jp = jax_side
    _, tpol, tp = port_side
    ob = np.random.RandomState(0).randn(16, 56).astype(np.float32)
    jmean, jlogstd = jpol.mean_logstd(jp, ob)
    tmean, tlogstd = tpol.mean_logstd(tp, torch.as_tensor(ob))
    np.testing.assert_allclose(tmean.numpy(), np.asarray(jmean), atol=1e-5)
    np.testing.assert_array_equal(tlogstd.numpy(), np.asarray(jlogstd))
    np.testing.assert_allclose(tpol.value(tp, torch.as_tensor(ob)).numpy(),
                               np.asarray(jpol.value(jp, ob)), atol=1e-5)


# ---------------------------------------------------------------------------
# env resets and reset choice


def test_reset_at_matches_jax(jax_side, port_side):
    jenv, _, _ = jax_side
    tenv, _, _ = port_side
    idx = np.array([0, 7, 38])
    js = jax.vmap(jenv.reset_at)(jax.random.split(jax.random.PRNGKey(0), 3),
                                 jnp.asarray(idx))
    ts = tenv.reset_at(idx)
    for f in ("qpos", "qvel", "obs"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)))
    np.testing.assert_array_equal(ts.init_idx.numpy(), idx)


def test_reset_init_noise_and_generator(port_side):
    env, _, _ = port_side
    g = torch.Generator().manual_seed(3)
    s1 = env.reset_init(g, 64)
    s2 = env.reset_init(torch.Generator().manual_seed(3), 64)
    np.testing.assert_array_equal(s1.qpos.numpy(), s2.qpos.numpy())
    dq = (s1.qpos - env.model.qpos0).abs()
    assert float(dq.max()) <= 0.01 and float(s1.qvel.abs().max()) <= 0.01
    assert float(dq.max()) > 0.005  # noise was drawn
    assert (s1.step_count == 0).all() and not s1.done.any()


def test_pick_reset_fn_raises_on_unknown_mode(port_side):
    env, _, _ = port_side
    assert pick_reset_fn(env, "rsi") == env.reset
    assert pick_reset_fn(env, "noise") == env.reset_init
    with pytest.raises(ValueError, match="reset_mode"):
        pick_reset_fn(env, "nosie")


def test_env_substeps_and_episode_cap(port_side):
    """``n_substeps`` control steps advance ``engine.step`` that many
    substeps; ``max_episode_steps`` ends episodes at the cap."""
    from deepmimic_mujoco_torch.physics import engine

    env, _, _ = port_side
    env2 = DPEnvV3(model=env.model, n_substeps=2, max_episode_steps=2)
    s0 = env2.reset_at([3, 11])
    ac = torch.zeros(2, 28)
    s1 = env2.step(s0, ac)
    qp, qv = engine.step(env.model, s0.qpos, s0.qvel, ac, n_substeps=2)
    torch.testing.assert_close(s1.qpos, qp, rtol=0, atol=0)
    assert not s1.done.any() and env2.step(s1, ac).done.all()
    assert not torch.equal(env.step(s0, ac).qpos, s1.qpos)


@pytest.mark.parametrize("kw", [dict(reward_mode="imitation_dm"),
                                dict(control_mode="pd_residual"),
                                dict(termination="fall_contact"),
                                dict(obs_mode="full"),
                                dict(reward_mode="imitation", n_substeps=2,
                                     control_mode="pd"),
                                dict(reward_mode="mocap",
                                     clip_velocities="reference")])
def test_env_accepts_configs_of_the_imitation_slice(kw, port_side):
    """Each configuration builds on the CPU, steps once, and has the JAX
    env's observation size."""
    env = DPEnvV3(model=port_side[0].model, **kw)
    assert env.observation_size == JaxDPEnvV3(clip="walk",
                                              **kw).observation_size
    s = env.step(env.reset_at([4, 20]), torch.zeros(2, 28))
    assert s.obs.shape == (2, env.observation_size)
    assert torch.isfinite(s.qpos).all() and torch.isfinite(s.reward).all()


@pytest.mark.parametrize("case", ["mujoco", "euler"])
def test_env_step_of_later_slices_matches_jax(case):
    """``DPEnvV3`` on host MuJoCo (``dynamics="mujoco"``) and on the euler
    humanoid, 4 envs from walk frames x 5 steps of the same torques 0.3·
    N(0, 1) in both stacks: qpos, qvel, obs and rewards within 1e-4 of
    max(1, |x|) on the euler humanoid (its one warm-budget solve per step,
    sums in another order) and 1e-6 on MuJoCo (the same ``mj_step`` calls
    from fresh caches), equal done flags."""
    from deepmimic_mujoco_tpu.physics import build_humanoid as jax_build
    from deepmimic_mujoco_tpu.physics import mj_host as jmj
    from deepmimic_mujoco_torch.physics import mj_host
    from deepmimic_mujoco_torch.physics.humanoid import build_humanoid

    if case == "mujoco":
        pytest.importorskip("mujoco")
        jenv = JaxDPEnvV3(clip="walk", dynamics="mujoco")
        tenv = DPEnvV3(clip="walk", dynamics="mujoco", device="cpu")
        for fn in (jmj._mj_pool, mj_host._mj_pool):
            fn.cache_clear()
        rel = 1e-6
    else:
        jenv = JaxDPEnvV3(clip="walk", model=jax_build(integrator="euler"))
        tenv = DPEnvV3(clip="walk", device="cpu",
                       model=build_humanoid(integrator="euler", device="cpu"))
        rel = 1e-4
    idx = np.array([0, 7, 19, 30])
    js = jax.vmap(jenv.reset_at)(jax.random.split(jax.random.PRNGKey(0), 4),
                                 jnp.asarray(idx))
    ts = tenv.reset_at(idx)
    step = jax.jit(jax.vmap(jenv.step))
    rng = np.random.RandomState(6)
    for k in range(5):
        ac = (0.3 * rng.randn(4, 28)).astype(np.float32)
        js, ts = step(js, jnp.asarray(ac)), tenv.step(ts, torch.as_tensor(ac))
        for name in ("qpos", "qvel", "obs", "reward"):
            ref = np.asarray(getattr(js, name), np.float64)
            err = float(np.abs(getattr(ts, name).numpy() - ref).max())
            assert err <= rel * max(1.0, float(np.abs(ref).max())), (
                k, name, err)
        np.testing.assert_array_equal(ts.done.numpy(), np.asarray(js.done))
    assert float(np.abs(ts.qpos.numpy() - np.asarray(
        jenv.clip_qpos)[idx]).max()) > 1e-3


# ---------------------------------------------------------------------------
# the slice: evaluate with the bundled checkpoint


@pytest.fixture(scope="module")
def slice_run(jax_side, port_side, tmp_path_factory):
    jenv, jpol, jp = jax_side
    tenv, tpol, tp = port_side
    n, horizon = 4, 10
    key = jax.random.PRNGKey(0)
    path = str(tmp_path_factory.mktemp("eval") / "jax_eval.npz")
    jax_evaluate(jenv, jpol, jp, key, n_episodes=n, horizon=horizon,
                 save_path=path, reset_mode="rsi")
    with np.load(path, allow_pickle=True) as z:
        ref = {k: z[k] for k in z.files}
    # the mocap frames JAX's evaluate starts from (its rsi reset per key)
    frames = np.asarray(jax.vmap(jenv.reset)(
        jax.random.split(key, n + 1)[1:]).init_idx)
    out = runner.rollout(tenv, tpol, tp, tenv.reset_at(frames), horizon,
                         record=True)
    return ref, out


def test_evaluate_matches_jax_episode_lengths_and_returns(slice_run):
    """Equal lengths; alive returns equal to within f32 summation."""
    ref, out = slice_run
    np.testing.assert_array_equal(out.ep_len.numpy(), ref["lens"])
    np.testing.assert_allclose(out.ep_ret.numpy(), ref["ep_rets"], atol=1e-5)


def test_evaluate_matches_jax_observations_and_actions(slice_run):
    """Per-step obs and deterministic actions over each episode.  Budget:
    max |Δ| ≤ 1e-3 — the 20-step qpos agreement measured in
    test_torch_physics is ~3e-7, and the obs' velocities and the actions
    amplify it by at most the dynamics' and the policy's gain."""
    ref, out = slice_run
    obs, acs, _ = (t.swapaxes(0, 1).numpy() for t in out.traj)
    for e, n in enumerate(ref["lens"]):
        assert n > 0
        np.testing.assert_allclose(obs[e, :n], ref["obs"][e], atol=1e-3)
        np.testing.assert_allclose(acs[e, :n], ref["acs"][e], atol=1e-3)
    assert np.isfinite(out.state.qpos.numpy()).all()


def test_evaluate_exports_ragged_episodes(port_side, tmp_path):
    env, policy, params = port_side
    path = str(tmp_path / "port_eval.npz")
    res = runner.evaluate(env, policy, params, torch.Generator().manual_seed(0),
                          n_episodes=3, horizon=4, save_path=path,
                          reset_mode="noise")
    with np.load(path, allow_pickle=True) as z:
        lens = z["lens"]
        assert [len(o) for o in z["obs"]] == list(lens)
        assert z["obs"][0].shape[1] == 56 and z["acs"][0].shape[1] == 28
        np.testing.assert_allclose(z["ep_rets"], res.rollout.ep_ret.numpy())
    assert res.avg_len == float(np.mean(lens))


def test_stochastic_rollout_samples_around_the_mean(port_side):
    """Stochastic actions are mean + exp(logstd)·N(0, 1) from the caller's
    generator: reproducible per seed, and one step's action noise matches
    the checkpoint's std."""
    env, policy, params = port_side
    state = env.reset_at(list(range(0, 39, 3)))

    def run(seed, stochastic=True):
        return runner.rollout(env, policy, params, state, 1,
                              stochastic=stochastic, record=True,
                              generator=torch.Generator().manual_seed(seed))

    a, b, det = run(5), run(5), run(5, stochastic=False)
    torch.testing.assert_close(a.traj[1], b.traj[1], rtol=0, atol=0)
    noise = (a.traj[1] - det.traj[1]) / torch.exp(params["logstd"])
    assert 0.7 < float(noise.std()) < 1.3 and abs(float(noise.mean())) < 0.2


def test_cli_evaluate_on_cpu():
    res = train_trpo.main(["--task", "evaluate", "--device", "cpu",
                           "--eval-episodes", "3", "--eval-horizon", "4",
                           "--load-model-path", CKPT])
    assert 0 < res.avg_len <= 4 and res.avg_ret == res.avg_len
    assert res.rollout.state.qpos.shape == (3, 35)


@pytest.mark.parametrize("flags", [
    ["--platform", "cpu"],
    ["--platform", "gpu", "--device", "cpu"],   # --device takes precedence
], ids=["platform-cpu", "device-over-platform"])
def test_cli_platform_flag_picks_the_device(flags):
    """The JAX CLI's ``--platform`` (README's A/B command passes ``cpu``)
    maps to a device as in ``cli.train_ppo``; ``--device`` overrides it."""
    res = train_trpo.main(["--task", "evaluate", *flags, "--eval-episodes",
                           "2", "--eval-horizon", "3", "--load-model-path",
                           CKPT])
    assert res.rollout.state.qpos.device.type == "cpu"
    args = train_trpo.build_parser().parse_args(["--platform", "gpu"])
    assert PLATFORMS[args.platform] == "cuda" and args.device is None
    with pytest.raises(SystemExit):  # the JAX CLI's "tpu" is not a choice
        train_trpo.build_parser().parse_args(["--platform", "tpu"])


@pytest.mark.parametrize("case", ["train", "sample", "ppo"])
def test_cli_train_sample_and_ppo(case, tmp_path):
    """``--task train`` writes args.json, progress.csv, the monitor CSV
    under the JAX loop's name and the checkpoint; ``--task sample`` writes
    ragged episodes of stochastic actions; ``--algo ppo`` trains 2
    iterations and writes a checkpoint that JAX's strict
    ``checkpoint.load`` takes as a ``PPOState``."""
    if case == "ppo":
        state = train_trpo.main([
            "--task", "train", "--algo", "ppo", "--device", "cpu",
            "--num-iters", "2", "--num-envs", "2", "--timesteps-per-batch",
            "8", "--ppo-minibatches", "2", "--ppo-lr-decay", "0.5",
            "--log-dir", str(tmp_path / "logs"),
            "--checkpoint-dir", str(tmp_path / "ckpt")])
        logs = tmp_path / "logs" / "DPEnvV3" / "ppo-walk-0"
        assert (logs / "progress.csv").read_text().count("\n") == 3
        like = PPO(JaxDPEnvV3(clip="walk"), JaxMlpPolicy(ob_dim=56, ac_dim=28),
                   PPOConfig(num_envs=2)).init(jax.random.PRNGKey(0))
        js = jax_checkpoint.load(str(tmp_path / "ckpt" / "DPEnvV3" /
                                     "ppo-walk-0" / "trpo_state.npz"), like)
        np.testing.assert_array_equal(np.asarray(js.params["vf"][1]["w"]),
                                      state.params["vf"][1]["w"].numpy())
        assert float(js.lr_scale) == float(state.lr_scale) == 0.25
        assert float(js.opt.t) == 2 * 4 * 2  # iterations × epochs × mbs
        return
    if case == "sample":
        path = str(tmp_path / "samples.npz")
        res = train_trpo.main(["--task", "sample", "--device", "cpu",
                               "--eval-episodes", "3", "--eval-horizon", "4",
                               "--load-model-path", CKPT,
                               "--sample-save-path", path])
        with np.load(path, allow_pickle=True) as z:
            assert [len(o) for o in z["obs"]] == list(z["lens"])
            assert z["acs"][0].shape[1] == 28
        assert 0 < res.avg_len <= 4
        return
    state = train_trpo.main([
        "--task", "train", "--device", "cpu", "--num-iters", "1",
        "--num-envs", "2", "--timesteps-per-batch", "8",
        "--log-dir", str(tmp_path / "logs"),
        "--checkpoint-dir", str(tmp_path / "ckpt")])
    logs = tmp_path / "logs" / "DPEnvV3" / "trpo-walk-0"
    with open(logs / "args.json") as fh:
        assert json.load(fh)["num_envs"] == 2
    assert (logs / "progress.csv").read_text().count("\n") == 2
    assert (logs / "monitor.json.monitor.csv").exists()
    params = checkpoint.load_trpo_params(
        str(tmp_path / "ckpt" / "DPEnvV3" / "trpo-walk-0" / "trpo_state.npz"),
        MlpPolicy(56, 28), "cpu")
    torch.testing.assert_close(params["logstd"], state.params["logstd"])
