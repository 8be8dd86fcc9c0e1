"""DeepMimic clip ingestion of the port (``mocap/loader.py``'s
``load_deepmimic_json`` and ``load_clip`` dispatch, ``mocap/legacy.py``,
``mocap/native.py``) against the JAX package on the CPU.

No DeepMimic JSON clip is in the repository: every bundled clip's raw
``frames`` and ``loop`` (``assets/motions/*.npz``) are written as DeepMimic
JSON, once with the ``.json`` and once with the ``.txt`` suffix, and both
stacks load them.  Python's float repr round-trips, so the files hold the
frames exactly: the f64 arrays must agree within 1e-12 (they agree
exactly), the native library's within 1e-12 of the Python pipeline, as
``tests/test_native.py`` holds JAX's."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from deepmimic_mujoco_tpu.mocap import legacy as jlegacy
from deepmimic_mujoco_tpu.mocap import loader as jloader
from deepmimic_mujoco_tpu.mocap import native as jnative
from deepmimic_mujoco_torch.envs.dp_env_v3 import DPEnvV3
from deepmimic_mujoco_torch.mocap import legacy, loader, native
from deepmimic_mujoco_torch.mocap.registry import available_clips, clip_path

ATOL = 1e-12
ARRAYS = ("durations", "qpos", "qvel", "quat_frames", "raw_frames")


@pytest.fixture(scope="module")
def clip_files(tmp_path_factory):
    """{suffix: {clip name: path}} of every bundled clip as DeepMimic
    JSON."""
    d = tmp_path_factory.mktemp("clips")
    out = {"json": {}, "txt": {}}
    for name in available_clips():
        with np.load(clip_path(name)) as z:
            frames, loop = z["frames"], str(z["loop"])
        for suffix in out:
            path = str(d / f"{name}.{suffix}")
            with open(path, "w") as fh:
                json.dump({"Loop": loop, "Frames": frames.tolist()}, fh)
            out[suffix][name] = path
    assert len(out["json"]) == 15
    return out


def _same_clip(a, b, exact_quat=True):
    assert (a.name, a.loop, a.dt) == (b.name, b.loop, b.dt)
    for k in ARRAYS if exact_quat else ("durations", "qpos", "qvel",
                                        "raw_frames"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.shape == y.shape, k
        np.testing.assert_allclose(x, y, atol=ATOL, rtol=0, err_msg=k)
    np.testing.assert_allclose(a.qpos_cont, b.qpos_cont, atol=ATOL, rtol=0)
    np.testing.assert_allclose(a.qvel_fd, b.qvel_fd, atol=ATOL, rtol=0)


@pytest.mark.parametrize("suffix", ["json", "txt"])
def test_load_deepmimic_json_matches_jax(clip_files, suffix):
    """``load_deepmimic_json`` of every clip: name, loop, dt and every f64
    array (durations, qpos, qvel, quat_frames, raw_frames, and the
    continuous track and consistent velocities) equal to JAX's within
    1e-12, and the raw frames to the bundled ``.npz``'s."""
    for name, path in clip_files[suffix].items():
        clip = loader.load_deepmimic_json(path)
        _same_clip(clip, jloader.load_deepmimic_json(path))
        with np.load(clip_path(name)) as z:
            np.testing.assert_array_equal(clip.raw_frames, z["frames"])


@pytest.mark.parametrize("suffix", ["json", "txt"])
def test_load_clip_dispatches_as_jax_does(clip_files, suffix):
    """``load_clip``: a ``.json`` or ``.txt`` path goes to the JSON loader
    (the port used to read every existing path as ``.npz``), a ``.npz``
    path to ``load_npz`` and a name to the registry; each equal to JAX's
    ``load_clip`` and to the bundled clip."""
    for name, path in clip_files[suffix].items():
        clip = loader.load_clip(path)
        _same_clip(clip, jloader.load_clip(path))
        bundled = loader.load_clip(clip_path(name))
        _same_clip(bundled, jloader.load_clip(clip_path(name)))
        for k in ("qpos", "qvel", "raw_frames"):
            np.testing.assert_array_equal(getattr(clip, k),
                                          getattr(bundled, k))
    _same_clip(loader.load_clip("walk"), jloader.load_clip("walk"))


@pytest.mark.parametrize("suffix", ["json", "txt"])
def test_mocap_v1_matches_jax(clip_files, suffix):
    """``MocapV1.load_mocap`` by path (and by name): ``data``,
    ``data_vel``, ``data_angle``, ``durations`` and every frame's
    ``all_states`` equal to JAX's."""
    for name, path in list(clip_files[suffix].items()) + [("walk", "walk")]:
        a, b = legacy.MocapV1(), jlegacy.MocapV1()
        a.load_mocap(path)
        b.load_mocap(path)
        assert (a.num_bodies, a.pos_dim, a.rot_dim, a.dt) == (
            b.num_bodies, b.pos_dim, b.rot_dim, b.dt)
        np.testing.assert_allclose(a.data, b.data, atol=ATOL, rtol=0)
        np.testing.assert_allclose(np.array(a.data_vel),
                                   np.array(b.data_vel), atol=ATOL, rtol=0)
        np.testing.assert_allclose(np.array(a.data_angle),
                                   np.array(b.data_angle), atol=ATOL, rtol=0)
        assert a.durations == b.durations
        for sa, sb in zip(a.all_states, b.all_states):
            assert sa.keys() == sb.keys()
            for k in sa:
                np.testing.assert_array_equal(sa[k], sb[k])


def test_quat2euler_matches_jax():
    rng = np.random.RandomState(3)
    for q in rng.randn(50, 4):
        q /= np.linalg.norm(q)
        assert legacy.quat2euler(q) == jlegacy.quat2euler(q)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The port's native library compiled with g++ into a temporary build
    directory (skipped when there is no g++), and JAX's binding."""
    if shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("no C++ compiler")
    mp = pytest.MonkeyPatch()
    mp.setattr(native, "BUILD_DIR", str(tmp_path_factory.mktemp("_build")))
    mp.setattr(native, "_lib", None)
    assert native.available()
    assert os.listdir(native.BUILD_DIR)[0].startswith("libdmtpu_mocap_")
    yield
    mp.undo()


@pytest.mark.parametrize("suffix", ["json", "txt"])
def test_native_binding_matches_python_and_jax(clip_files, built, suffix):
    """``parse_clip`` gives the file's frames and loop exactly;
    ``convert_frames`` and ``load_clip_native`` give qpos and qvel within
    1e-12 of the Python loader and of JAX's native binding."""
    jax_native = jnative.available()
    for name, path in clip_files[suffix].items():
        ref = loader.load_clip(path)
        frames, loop = native.parse_clip(path)
        np.testing.assert_array_equal(frames, ref.raw_frames)
        assert loop == ref.loop
        qpos, qvel = native.convert_frames(ref.raw_frames)
        np.testing.assert_allclose(qpos, ref.qpos, atol=ATOL, rtol=0)
        np.testing.assert_allclose(qvel, ref.qvel, atol=ATOL, rtol=0)
        clip = native.load_clip_native(path)
        _same_clip(clip, ref, exact_quat=False)
        assert not clip.quat_frames.any()
        if jax_native:
            jq, jv = jnative.convert_frames(ref.raw_frames)
            np.testing.assert_allclose(qpos, jq, atol=ATOL, rtol=0)
            np.testing.assert_allclose(qvel, jv, atol=ATOL, rtol=0)
    with pytest.raises(ValueError):
        native.convert_frames(np.zeros((3, 43)))


def test_env_on_a_json_clip_equals_the_bundled_clip(clip_files):
    """``DPEnvV3(clip=<walk.json>)``: the clip tables, a reset's state and
    a step's state and reward equal those of ``clip="walk"``."""
    envs = [DPEnvV3(clip=c, device="cpu")
            for c in (clip_files["json"]["humanoid3d_walk"], "walk")]
    a, b = envs
    for k in ("clip_qpos", "clip_qvel"):
        assert torch.equal(getattr(a, k), getattr(b, k))
    idx = torch.arange(4) * 9 % a.clip_len
    sa, sb = a.reset_at(idx), b.reset_at(idx)
    act = torch.full((4, 28), 0.1)
    for x, y in ((sa, sb), (a.step(sa, act), b.step(sb, act))):
        for k in ("qpos", "qvel", "obs", "reward"):
            assert torch.equal(getattr(x, k), getattr(y, k)), k
