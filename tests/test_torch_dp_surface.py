"""The port's 197-D DeepMimic training surface
(``deepmimic_mujoco_torch/envs/deepmimic_surface.py``) and its quaternion
helper against the JAX package on the CPU.

Inputs are mocap frames and numpy draws from a seed, handed to both
stacks.  The JAX side jits one physics program: ``jax.vmap(env.step)`` of
the walk surface (4 envs × 10 steps).  The other configurations (a
non-looping clip, ``quirk_lateral``, ``write_phase=False``, the ``alive``
reward, the reference clip velocities, a step cap) are held with the
physics replaced by the same cheap map in both stacks.  Tolerances are
stated per test."""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepmimic_mujoco_tpu.envs import deepmimic_surface as jsurf
from deepmimic_mujoco_tpu.utils import quaternion as jquat
from deepmimic_mujoco_torch.envs import deepmimic_surface as tsurf
from deepmimic_mujoco_torch.utils import quaternion as quat

torch.set_num_threads(1)

FRAMES = np.array([0, 9, 21, 37])


def _t(x):
    return torch.as_tensor(np.array(x))


def test_euler_rxyz_from_quat_matches_jax_with_gimbal_inputs():
    """Random unit and non-unit quaternions, the identity, and quaternions
    at the gimbal (|cos b| = 0 exactly: (½, ½, ½, ½) and three more with
    R00 = R01 = 0, where the branch sets a = 0) and next to it: angles
    within 2e-6 rad of JAX's, the same gimbal branch taken."""
    rng = np.random.RandomState(0)
    q = [rng.randn(64, 4) * rng.uniform(0.5, 2.0, (64, 1)),
         [[1.0, 0, 0, 0], [0.5, 0.5, 0.5, 0.5], [0.5, -0.5, 0.5, -0.5],
          [-0.5, -0.5, -0.5, -0.5], [0.5, -0.5, -0.5, 0.5],
          [np.cos(np.pi / 4), 0, np.sin(np.pi / 4), 0],
          [np.cos(np.pi / 4 - 1e-4), 0, np.sin(np.pi / 4 - 1e-4), 0]]]
    q = np.concatenate([np.asarray(x, np.float64) for x in q]).astype(
        np.float32)
    ref = np.asarray(jquat.euler_rxyz_from_quat(jnp.asarray(q)))
    out = quat.euler_rxyz_from_quat(_t(q)).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-6, rtol=0)
    gimbal = slice(65, 69)
    assert (out[gimbal, 0] == 0).all() and (ref[gimbal, 0] == 0).all()
    # the round trip through the hinge composition
    back = quat.quat_from_euler_rxyz(_t(out))
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    dot = np.abs(np.sum(back.numpy() * qn, axis=1))
    np.testing.assert_allclose(dot, 1.0, atol=2e-6)


def _actions(n=48, seed=1):
    """Random DP-order actions with a zero axis, an axis of norm 1e-10
    (both below the 1e-9 threshold: the x axis) and angles up to ±π."""
    rng = np.random.RandomState(seed)
    a = rng.uniform(-np.pi, np.pi, (n, 36)).astype(np.float32)
    for j, (off, w) in tsurf.dp_action_slices().items():
        if w == 4:
            a[0, off + 1:off + 4] = 0.0
            a[1, off + 1:off + 4] = [1e-10, 0.0, 0.0]
            a[2, off] = 0.0                       # the identity
    return a


def test_action_to_targets_matches_jax_including_a_zero_axis():
    """(48, 36) actions → (48, 28) targets within 2e-6 of JAX's; the dp
    layout is JAX's."""
    assert tsurf.dp_action_slices() == jsurf.dp_action_slices()
    a = _actions()
    ref = np.asarray(jax.vmap(jsurf.action_to_targets)(jnp.asarray(a)))
    out = tsurf.action_to_targets(_t(a)).numpy()
    assert out.shape == (48, 28)
    np.testing.assert_allclose(out, ref, atol=2e-6, rtol=0)


def test_targets_to_action_matches_jax_and_inverts():
    """Clip poses (and a zero pose, whose axes vanish) → actions within
    2e-6 of JAX's ``targets_to_action``; ``action_to_targets`` takes them
    back to the poses within 2e-5."""
    env = tsurf.DeepMimicSurfaceEnv(device="cpu", reward_mode="alive")
    poses = np.concatenate([env.clip_qpos[FRAMES, 7:].numpy(),
                            np.zeros((1, 28), np.float32)])
    for pose in poses:
        out = tsurf.targets_to_action(pose)
        np.testing.assert_allclose(out, jsurf.targets_to_action(pose),
                                   atol=2e-6, rtol=0)
        back = tsurf.action_to_targets(_t(out)[None])[0].numpy()
        np.testing.assert_allclose(back, pose, atol=2e-5)


def _run(jenv, tenv, actions, frames=FRAMES):
    """Both envs from ``reset_at(frames)`` through ``actions`` (T, B, 36):
    the per-step obs, rewards and dones of each."""
    js = jax.vmap(jenv.reset_at, in_axes=(None, 0))(
        jax.random.PRNGKey(0), jnp.asarray(frames))
    ts = tenv.reset_at(frames)
    np.testing.assert_allclose(ts.obs.numpy(), np.asarray(js.obs), atol=1e-5)
    step = jax.jit(jax.vmap(jenv.step))
    out = []
    for a in actions:
        js, ts = step(js, jnp.asarray(a)), tenv.step(ts, _t(a))
        out.append((np.asarray(js.obs), ts.obs.numpy(),
                    np.asarray(js.reward), ts.reward.numpy(),
                    np.asarray(js.done), ts.done.numpy()))
    return out, js, ts


def test_walk_surface_ten_steps_match_jax():
    """4 envs × 10 steps of the walk surface on the physics (2 substeps,
    ``imitation_dm``) from the same frames and PD actions (the clip's pose
    plus noise): the 197-D obs within 1e-4, rewards within 1e-5, dones
    equal; the env's sizes and builders are JAX's."""
    jenv, tenv = jsurf.DeepMimicSurfaceEnv(), tsurf.DeepMimicSurfaceEnv(
        device="cpu")
    for k in ("observation_size", "action_size", "state_size", "goal_size",
              "clip_len", "cursor_scale", "clip_wraps",
              "fall_contact_bodies"):
        assert getattr(tenv, k) == getattr(jenv, k), k
    for k in ("build_state_offset", "build_state_scale",
              "build_state_norm_groups", "build_action_offset",
              "build_action_scale", "build_action_bound_min",
              "build_action_bound_max"):
        np.testing.assert_array_equal(getattr(tenv, k)(), getattr(jenv, k)())
    np.testing.assert_allclose(tenv.clip_ee.numpy(), np.asarray(jenv.clip_ee),
                               atol=1e-5)
    rng = np.random.RandomState(2)
    acts = []
    for t in range(10):
        poses = tenv.clip_qpos[(FRAMES + t + 1) % tenv.clip_len, 7:].numpy()
        acts.append(np.stack([tsurf.targets_to_action(p) for p in poses])
                    + 0.05 * rng.randn(4, 36).astype(np.float32))
    out, js, ts = _run(jenv, tenv, np.stack(acts))
    for jo, to, jr, tr, jd, td in out:
        np.testing.assert_allclose(to, jo, atol=1e-4, rtol=0)
        np.testing.assert_allclose(tr, jr, atol=1e-5, rtol=0)
        np.testing.assert_array_equal(td, jd)
    assert 0.2 < float(np.mean([o[3] for o in out])) <= 1.0
    np.testing.assert_array_equal(ts.mocap_idx.numpy(),
                                  np.asarray(js.mocap_idx))
    np.testing.assert_array_equal(ts.step_count.numpy(), 10)


def test_reset_draws_frames_of_the_clip():
    """``reset`` starts each env at a frame of the clip (its state equals
    ``reset_at`` of that frame)."""
    env = tsurf.DeepMimicSurfaceEnv(device="cpu", reward_mode="alive")
    st = env.reset(torch.Generator().manual_seed(0), 64)
    assert st.init_idx.min() >= 0 and st.init_idx.max() < env.clip_len
    assert len(set(st.init_idx.tolist())) > 10
    torch.testing.assert_close(st.obs, env.reset_at(st.init_idx).obs)


def _jfake(model, qp, qv, target, kp, kd, n_substeps=1):
    """A cheap stand-in for ``engine.step_pd``: half-way to the targets,
    the root pushed forward and, past x = 0.3, down by 0.2 per step."""
    drop = jnp.where(qp[0] > 0.3, 0.2, 0.0)
    return (qp.at[7:].set(0.5 * qp[7:] + 0.5 * target).at[0].add(0.02)
            .at[2].add(-drop), 0.9 * qv)


def _tfake(qp, qv, target):
    drop = torch.where(qp[:, 0] > 0.3, 0.2, 0.0)
    return (torch.cat([qp[:, :1] + 0.02, qp[:, 1:2],
                       qp[:, 2:3] - drop[:, None], qp[:, 3:7],
                       0.5 * qp[:, 7:] + 0.5 * target], dim=1), 0.9 * qv)


@pytest.mark.parametrize("kw", [
    dict(clip="kick", max_episode_steps=8),
    dict(quirk_lateral=True, write_phase=False),
    dict(reward_mode="alive", max_episode_steps=5),
    dict(clip="punch", clip_velocities="reference", write_phase=False),
], ids=["kick_clip_over", "quirks", "alive_cap", "punch_reference"])
def test_surface_bookkeeping_matches_jax(kw, monkeypatch):
    """The env's bookkeeping with the physics replaced by the same cheap
    map in both stacks, 6 envs × 10 steps: obs within 1e-5, rewards within
    1e-5, dones equal; on the non-looping clips envs end by ``_clip_over``
    (the frames near the end), by fall contact (the root pushed down) and
    by the step cap."""
    monkeypatch.setattr(jsurf, "engine",
                        types.SimpleNamespace(step_pd=_jfake))
    jenv = jsurf.DeepMimicSurfaceEnv(**kw)
    tenv = tsurf.DeepMimicSurfaceEnv(device="cpu", **kw)
    tenv._dynamics = _tfake
    frames = np.array([0, 3, tenv.clip_len - 9, tenv.clip_len - 4,
                       tenv.clip_len - 2, 5])
    acts = 0.3 * np.random.RandomState(3).randn(10, 6, 36).astype(np.float32)
    out, js, _ = _run(jenv, tenv, acts, frames)
    dones = np.stack([o[5] for o in out])
    for jo, to, jr, tr, jd, td in out:
        np.testing.assert_allclose(to, jo, atol=1e-5, rtol=0)
        np.testing.assert_allclose(tr, jr, atol=1e-5, rtol=0)
        np.testing.assert_array_equal(td, jd)
    assert dones.any()
    if kw.get("quirk_lateral") or not kw.get("write_phase", True):
        assert all((o[1][:, 0] == 0).all() for o in out)
    if not tenv.clip_wraps:
        pos = frames[:, None] + np.arange(1, 11) * tenv.cursor_scale
        over = pos >= tenv.clip_len - 1
        assert (dones.T[over]).all() and over.any()
