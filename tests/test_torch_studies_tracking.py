"""The tracking studies of the port (``cli/clip_tracking_study.py``,
``cli/tracking_ceiling_probe.py``, ``cli/setting_states.py``) against the
JAX package on the CPU, each JAX side written as its tool computes it
(``tools/clip_tracking_study.py:81-109``, ``tools/tracking_ceiling_probe.
py:56-81``, ``tools/setting_states.py:56-74``).

Tolerances: rewards, reward terms and the setting-states columns within
1e-4 (of max(1, |x|) for the columns); done flags and open-loop lengths
equal.  Three jitted JAX physics programs (the one-step and the open-loop
recipe rollouts, one probe); the setting states run eagerly, as the tool
does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmimic_mujoco_tpu.envs import rewards as jrewards
from deepmimic_mujoco_tpu.envs.dp_env_v3 import DPEnvV3 as JaxDPEnvV3
from deepmimic_mujoco_tpu.mocap.registry import get_clip as jget_clip
from deepmimic_mujoco_tpu.physics import build_humanoid as jax_build
from deepmimic_mujoco_tpu.physics import dynamics as jdynamics
from deepmimic_mujoco_tpu.physics import engine as jengine
from deepmimic_mujoco_tpu.physics import kinematics as jkin
from deepmimic_mujoco_tpu.physics.humanoid import (
    mocap_hinge_range as jax_mocap_range,
)
from deepmimic_mujoco_torch.cli import (
    clip_tracking_study,
    setting_states,
    tracking_ceiling_probe,
)
from deepmimic_mujoco_torch.mocap.registry import get_clip
from deepmimic_mujoco_torch.physics.humanoid import (
    build_humanoid,
    mocap_hinge_range,
)

torch.set_num_threads(1)

ATOL = 1e-4
N_FRAMES, N_STARTS, HORIZON = 4, 2, 5


def _jax_clip_tracking(env, n_frames, n_starts, horizon):
    """``tools/clip_tracking_study.py:81-109``: one-step rewards and done
    flags, then the open-loop summed rewards and lengths."""
    zero = jnp.zeros(env.action_size, jnp.float32)
    key = jax.random.PRNGKey(0)
    starts = jnp.asarray(
        np.linspace(0, env.clip_len - 2, n_frames).round(), jnp.int32)

    def track1(idx, key):
        s = env.step(env.reset_at(key, idx), zero)
        return s.reward, s.done

    r1, d1 = jax.jit(jax.vmap(track1))(starts,
                                       jax.random.split(key, n_frames))
    s_idx = jnp.asarray(
        np.linspace(0, env.clip_len - 2, n_starts).round(), jnp.int32)

    def rollout(idx, key):
        s0 = env.reset_at(key, idx)

        def body(carry, _):
            s, alive, rew, length = carry
            s1 = env.step(s, zero)
            alive1 = alive & ~s1.done
            rew = rew + jnp.where(alive, s1.reward, 0.0)
            length = length + alive.astype(jnp.int32)
            return (s1, alive1, rew, length), None

        (_, _, rew, length), _ = jax.lax.scan(
            body, (s0, jnp.ones((), bool), jnp.zeros(()),
                   jnp.zeros((), jnp.int32)), None, length=horizon)
        return rew, length

    rew, length = jax.jit(jax.vmap(rollout))(
        s_idx, jax.random.split(key, n_starts))
    return (np.asarray(starts), np.asarray(r1), np.asarray(d1),
            np.asarray(rew), np.asarray(length))


def test_clip_tracking_matches_jax():
    """walk with the mocap joint limits, 4 frames, 2 starts, horizon 5: the
    per-env one-step rewards and done flags, the open-loop rewards and
    lengths, and the row ``main`` prints and returns."""
    jenv = JaxDPEnvV3(clip="walk", model=jax_mocap_range(None),
                      reward_mode="imitation_dm", control_mode="pd_residual",
                      n_substeps=2, max_episode_steps=HORIZON)
    j_starts, j_r1, j_d1, j_rew, j_len = _jax_clip_tracking(
        jenv, N_FRAMES, N_STARTS, HORIZON)

    env = clip_tracking_study.make_env(
        "walk", mocap_hinge_range(build_humanoid(device="cpu")), HORIZON)
    starts, r1, d1 = clip_tracking_study.one_step(env, N_FRAMES)
    np.testing.assert_array_equal(starts, j_starts)
    np.testing.assert_allclose(r1, j_r1, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(d1, j_d1)
    rew, length = clip_tracking_study.open_loop(env, N_STARTS, HORIZON)
    np.testing.assert_allclose(rew, j_rew, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(length, j_len)

    [row] = clip_tracking_study.main([
        "--device", "cpu", "--clips", "walk", "--joint-limits", "mocap",
        "--n-frames", str(N_FRAMES), "--n-starts", str(N_STARTS),
        "--horizon", str(HORIZON)])
    want = {"clip": "walk", "clip_len": jenv.clip_len,
            "clip_fps": round(1.0 / jenv.clip.dt, 1), "loop": jenv.clip.loop,
            "onestep_reward_mean": float(np.mean(j_r1)),
            "onestep_reward_min": float(np.min(j_r1)),
            "onestep_done_frac": float(np.mean(j_d1)),
            "openloop_rew_per_step": float(
                (j_rew / np.maximum(j_len, 1)).mean()),
            "openloop_eplen_mean": float(j_len.mean())}
    assert row.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, float):
            assert abs(row[k] - v) <= ATOL, (k, row[k], v)
        else:
            assert row[k] == v, k


def test_tracking_ceiling_probe_matches_jax():
    """The probe "ref vels, 60Hz ctrl" on spinkick at 4 frames: the reward
    and each of its five terms per frame, as the JAX tool recomputes them
    from the post-step state."""
    kw = tracking_ceiling_probe.PROBES["ref vels, 60Hz ctrl"]
    env = JaxDPEnvV3(clip="spinkick", reward_mode="imitation_dm",
                     control_mode="pd_residual", n_substeps=kw["n_substeps"],
                     pd_target_interp=False, clip_velocities=kw["vels"])
    zero = jnp.zeros(env.action_size, jnp.float32)
    j_starts = jnp.asarray(
        np.linspace(0, env.clip_len - 2, N_FRAMES).round(), jnp.int32)

    def track1(idx, key):
        s1 = env.step(env.reset_at(key, idx), zero)
        ridx, cycles = env._clip_index(s1.mocap_idx, s1.init_idx)
        offset = cycles * env.cycle_offset
        ref_qp = env.clip_qpos[ridx].at[0:3].add(offset)
        kin = jkin.fk(env.model, s1.qpos)
        ee = jkin.geom_world_pos(env.model, kin)[env._ee_geoms]
        return jrewards.deepmimic_reward(
            s1.qpos, s1.qvel, ref_qp, env.clip_qvel[ridx], ee_pos=ee,
            ref_ee_pos=env.clip_ee[ridx] + offset,
            com_vel=jkin.com_velocity(env.model, kin, s1.qvel),
            ref_com_vel=env.clip_com_vel[ridx], return_terms=True)

    j_r, j_terms = jax.jit(jax.vmap(track1))(
        j_starts, jax.random.split(jax.random.PRNGKey(0), N_FRAMES))
    starts, r, terms = tracking_ceiling_probe.probe("spinkick", N_FRAMES,
                                                    device="cpu", **kw)
    np.testing.assert_array_equal(starts, np.asarray(j_starts))
    np.testing.assert_allclose(r, np.asarray(j_r), atol=ATOL, rtol=0)
    assert set(terms) == set(tracking_ceiling_probe.TERMS) == set(j_terms)
    for k in tracking_ceiling_probe.TERMS:
        np.testing.assert_allclose(terms[k], np.asarray(j_terms[k]),
                                   atol=ATOL, rtol=0, err_msg=k)
    res = tracking_ceiling_probe.summary(starts, r, terms)
    assert res["worst_frame"] == int(starts[int(np.argmin(np.asarray(j_r)))])


def test_setting_states_match_jax():
    """The first 3 walk frames: CoM height, ‖bias force‖, ‖qacc‖ of the
    passive forward dynamics and the finite-difference velocity error, as
    the JAX tool computes them frame by frame (eagerly)."""
    jclip, jmodel = jget_clip("walk"), jax_build()
    want = {k: [] for k in setting_states.COLUMNS}
    for k in range(3):
        qpos, qvel = jnp.asarray(jclip.qpos[k]), jnp.asarray(jclip.qvel[k])
        kin = jkin.fk(jmodel, qpos)
        want["com_z"].append(float(jkin.mass_center(jmodel, kin)[2]))
        want["bias"].append(float(jnp.linalg.norm(
            jdynamics.bias_force(jmodel, kin, qvel))))
        fwd = jengine.forward(jmodel, qpos, qvel, jnp.zeros(jmodel.nu))
        want["qacc"].append(float(jnp.linalg.norm(fwd.qacc)))
        fd = (np.asarray(jclip.qpos[k + 1][7:])
              - np.asarray(jclip.qpos[k][7:])) / jclip.dt
        want["fd_vel_err"].append(float(np.abs(
            fd - np.asarray(jclip.qvel[k + 1][6:])).mean()))
    table = setting_states.frame_table(get_clip("walk"), 3, device="cpu")
    for k in setting_states.COLUMNS:
        x, ref = table[k], np.asarray(want[k])
        assert x.shape == (3,)
        assert np.max(np.abs(x - ref) / np.maximum(1.0, np.abs(ref))) \
            <= ATOL, (k, x, ref)


def test_setting_states_cli_prints_each_frame(capsys):
    table = setting_states.main(["--device", "cpu", "--frames", "2"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("clip walk: 39 frames")
    assert len(out) == 2 + 2 and all(len(table[k]) == 2 for k in table)


@pytest.mark.parametrize("device", [None, "cuda"])
def test_study_clis_need_a_card_unless_asked_for_the_cpu(device):
    """Like every entry point of the port, the studies run on the card by
    default, and without one they raise rather than fall back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    argv = [] if device is None else ["--device", device]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        setting_states.main(argv + ["--frames", "1"])
