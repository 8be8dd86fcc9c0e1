"""Public members of ported classes and modules against the JAX package on
the CPU: ``PhysicsModel.body_index`` / ``geom_index``, ``MocapClip.
total_time`` / ``save_npz`` (a round trip through ``load_clip`` in both
packages), ``Monitor.episode_rewards`` / ``episode_lengths`` and
``mocap/_quat_np.from_euler_rxyz``; and ``cli/gen_assets.py`` against the
committed assets, byte for byte.

No JAX physics runs here.  Inputs are made from a seed with numpy; every
comparison is exact unless its test says otherwise."""

import filecmp
import os

import numpy as np
import pytest
import torch

from deepmimic_mujoco_tpu.mocap import _quat_np as jquat
from deepmimic_mujoco_tpu.mocap import loader as jloader
from deepmimic_mujoco_tpu.physics import build_humanoid as jax_build
from deepmimic_mujoco_tpu.utils import monitor as jmonitor
from deepmimic_mujoco_torch.cli import gen_assets
from deepmimic_mujoco_torch.mocap import _quat_np as tquat
from deepmimic_mujoco_torch.mocap import loader
from deepmimic_mujoco_torch.mocap.registry import available_clips, get_clip
from deepmimic_mujoco_torch.physics.humanoid import build_humanoid
from deepmimic_mujoco_torch.utils import monitor

torch.set_num_threads(1)

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
ASSET_DIRS = ("characters", "controllers", "agents", "args", "terrain")


def test_body_and_geom_index_match_jax():
    jm, tm = jax_build(), build_humanoid(device="cpu")
    assert tm.body_names == jm.body_names and tm.geom_names == jm.geom_names
    for name in jm.body_names:
        assert tm.body_index(name) == jm.body_index(name)
    for name in jm.geom_names:
        assert tm.geom_index(name) == jm.geom_index(name)
    with pytest.raises(ValueError):
        tm.body_index("no_such_body")


@pytest.mark.parametrize("name", available_clips())
def test_clip_total_time_matches_jax(name):
    from deepmimic_mujoco_tpu.mocap.registry import get_clip as jget_clip

    assert get_clip(name).total_time == jget_clip(name).total_time


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_save_npz_round_trips_through_both_loaders(tmp_path, writer):
    """A clip saved by one package's ``save_npz`` loads in both packages'
    ``load_clip`` to the clip it was: name, loop and every f64 array equal."""
    from deepmimic_mujoco_tpu.mocap.registry import get_clip as jget_clip

    for name in ("walk", "backflip"):
        src = get_clip(name) if writer == "port" else jget_clip(name)
        path = str(tmp_path / f"{name}.npz")
        src.save_npz(path)
        for back in (loader.load_clip(path), jloader.load_clip(path)):
            assert (back.name, back.loop, back.dt) == (src.name, src.loop,
                                                       src.dt)
            for k in ("durations", "qpos", "qvel", "raw_frames"):
                np.testing.assert_array_equal(getattr(back, k),
                                              getattr(src, k), err_msg=k)


def test_monitor_episode_lists_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    eps = [(float(rng.randn() * 50), int(rng.randint(1, 300)))
           for _ in range(7)]
    mons = (monitor.Monitor(str(tmp_path / "port")),
            jmonitor.Monitor(str(tmp_path / "jax")))
    for m in mons:
        assert m.episode_rewards == [] and m.episode_lengths == []
        for r, n in eps:
            m.record(r, n)
        m.close()
    assert mons[0].episode_rewards == mons[1].episode_rewards
    assert mons[0].episode_lengths == mons[1].episode_lengths
    assert mons[0].episode_lengths == [n for _, n in eps]


def test_from_euler_rxyz_matches_jax_and_inverts_euler_rxyz():
    rng = np.random.RandomState(1)
    for e in rng.uniform(-np.pi, np.pi, (64, 3)):
        q = tquat.from_euler_rxyz(e)
        np.testing.assert_array_equal(q, jquat.from_euler_rxyz(e))
        assert abs(np.linalg.norm(q) - 1.0) < 1e-12
        # the same rotation as the euler angles extracted from it
        np.testing.assert_allclose(
            tquat.to_mat(tquat.from_euler_rxyz(tquat.euler_rxyz(q))),
            tquat.to_mat(q), atol=1e-12)


def test_gen_assets_writes_the_committed_assets(tmp_path):
    """Every file ``cli.gen_assets`` writes equals the committed one, and
    every committed file of those directories is written."""
    written = gen_assets.main(["--out", str(tmp_path)])
    assert len(written) == 3 + 2 * len(gen_assets.SKILLS) + 1
    for d in ASSET_DIRS:
        committed = sorted(os.listdir(os.path.join(ROOT, "assets", d)))
        assert sorted(os.listdir(tmp_path / d)) == committed, d
        for f in committed:
            assert filecmp.cmp(tmp_path / d / f,
                               os.path.join(ROOT, "assets", d, f),
                               shallow=False), f"{d}/{f}"
