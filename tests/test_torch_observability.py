"""The port's observability modules and small utilities against the JAX
package on the CPU: ``utils/console``, ``misc``, ``tile_images``,
``benchmarks``, ``math.flatten``, ``mocap/constants``, ``statistics``,
``logger`` (every format, the module API, ``configure``'s environment),
``profiling``, ``monitor.load_results``, ``plotting``, ``cli/plot_curve``,
``io_utils/video`` and ``cli/trace_summary`` (against the JAX package's
``tools/trace_summary.py``).

No JAX physics runs here.  Inputs are made from a seed with numpy.  MuJoCo
cannot open a GL context on a host without a display, so both stacks'
``render_qpos_trajectory`` run with ``mujoco.Renderer`` replaced by one
stub that draws the bodies' positions after ``mj_forward``.  Tolerances
are stated per test; most comparisons are exact."""

import collections
import gzip
import importlib.util
import json
import os
import pickle
import sys
import time

import jax
import jax.flatten_util
import numpy as np
import pytest
import torch

from deepmimic_mujoco_tpu.io_utils import video as jvideo
from deepmimic_mujoco_tpu.mocap import constants as jconstants
from deepmimic_mujoco_tpu.utils import benchmarks as jbenchmarks
from deepmimic_mujoco_tpu.utils import console as jconsole
from deepmimic_mujoco_tpu.utils import logger as jlogger
from deepmimic_mujoco_tpu.utils import misc as jmisc
from deepmimic_mujoco_tpu.utils import monitor as jmonitor
from deepmimic_mujoco_tpu.utils import plotting as jplotting
from deepmimic_mujoco_tpu.utils import profiling as jprofiling
from deepmimic_mujoco_tpu.utils import statistics as jstatistics
from deepmimic_mujoco_tpu.utils import tile_images as jtile
from deepmimic_mujoco_torch.algos import lanes, trpo
from deepmimic_mujoco_torch.cli import plot_curve, profile_trace, trace_summary
from deepmimic_mujoco_torch.io_utils import video
from deepmimic_mujoco_torch.mocap import constants
from deepmimic_mujoco_torch.mocap.registry import get_clip
from deepmimic_mujoco_torch.utils import (
    benchmarks,
    console,
    logger,
    misc,
    monitor,
    plotting,
    profiling,
    statistics,
    tile_images,
)
from deepmimic_mujoco_torch.utils import math as umath
from deepmimic_mujoco_torch.utils.running_stats import RunningMeanStd
from tests.torch_render_stub import StubRenderer, read_frames, stdout_of

torch.set_num_threads(1)

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))


def _jax_tool(name: str):
    """A module of the JAX package's ``tools/`` directory (not a package)."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_tools_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --- small utilities -------------------------------------------------------

class _EzPort(misc.EzPickle):
    def __init__(self, a, b=2):
        misc.EzPickle.__init__(self, a, b=b)
        self.a, self.b = a, b


def test_console_matches_jax():
    """``colorize`` for every colour and attribute, ``fmt_row`` on seeded
    numbers and strings, and ``timed``'s lines (its seconds replaced):
    equal strings."""
    for color in jconsole.color2num:
        for bold in (False, True):
            for hl in (False, True):
                assert (console.colorize("x y", color, bold, hl)
                        == jconsole.colorize("x y", color, bold, hl))
    rng = np.random.default_rng(0)
    row = list(rng.normal(size=4) * 10.0 ** rng.integers(-3, 7, 4)) + [
        "name", 3, np.float32(2.5)]
    for width in (8, 12):
        for header in (False, True):
            assert (console.fmt_row(width, row, header)
                    == jconsole.fmt_row(width, row, header))

    def run(timed):
        with timed("phase"):
            pass
        with timed("quiet", False):
            pass

    out, _ = stdout_of(run, console.timed)
    ref, _ = stdout_of(run, jconsole.timed)
    strip = [line.split(" in ")[0] for line in out.splitlines()]
    assert strip == [line.split(" in ")[0] for line in ref.splitlines()]
    assert len(strip) == 2


def test_misc_matches_jax():
    """``zipsame`` (and its length check), ``set_global_seeds`` (the same
    numpy and Python draws after it), ``boolean_flag`` and ``EzPickle``."""
    assert list(misc.zipsame([1, 2], "ab")) == list(jmisc.zipsame([1, 2],
                                                                  "ab"))
    for mod in (misc, jmisc):
        with pytest.raises(AssertionError):
            list(mod.zipsame([1, 2], [1]))
    draws = []
    for mod in (misc, jmisc):
        mod.set_global_seeds(7)
        import random

        draws.append((np.random.rand(3).tolist(), random.random()))
    assert draws[0] == draws[1]
    import argparse

    for argv in ([], ["--render"], ["--no-render"]):
        got = []
        for mod in (misc, jmisc):
            p = argparse.ArgumentParser()
            mod.boolean_flag(p, "render", default=True, help="h")
            got.append(vars(p.parse_args(argv)))
        assert got[0] == got[1]

    obj = pickle.loads(pickle.dumps(_EzPort(5, b=[1, 2])))
    assert (obj.a, obj.b) == (5, [1, 2])
    assert (jmisc.EzPickle(1, x=2).__getstate__()
            == misc.EzPickle(1, x=2).__getstate__())


@pytest.mark.parametrize("n", [1, 3, 4, 7])
def test_tile_images_matches_jax(n):
    """N seeded (h, w, c) images tiled into one grid: equal arrays."""
    imgs = np.random.default_rng(n).integers(0, 255, (n, 5, 7, 3), np.uint8)
    np.testing.assert_array_equal(tile_images.tile_images(imgs),
                                  jtile.tile_images(imgs))


def test_benchmarks_match_jax():
    """Both suites word for word, the lookups, and the duplicate-name
    refusal."""
    assert benchmarks.list_benchmarks() == jbenchmarks.list_benchmarks()
    for name in benchmarks.list_benchmarks():
        b = benchmarks.get_benchmark(name)
        assert b == jbenchmarks.get_benchmark(name)
        assert (benchmarks.get_task(b, "DPEnvV3")
                == jbenchmarks.get_task(b, "DPEnvV3"))
    assert benchmarks.get_task(b, "nope") is None
    with pytest.raises(ValueError, match="already registered"):
        benchmarks.register_benchmark({"name": "DeepMimicStandup"})
    with pytest.raises(ValueError, match="not found"):
        benchmarks.get_benchmark("nope")


def test_constants_match_jax():
    """``NU``, ``joint_qpos_slices`` and ``joint_qvel_slices``: equal."""
    assert (constants.NQ, constants.NV, constants.NU) == (
        jconstants.NQ, jconstants.NV, jconstants.NU) == (35, 34, 28)
    assert constants.joint_qpos_slices() == jconstants.joint_qpos_slices()
    assert constants.joint_qvel_slices() == jconstants.joint_qvel_slices()


def test_flatten_matches_ravel_pytree():
    """``utils/math.flatten`` of a tree of dicts, lists, a named tuple and
    None against ``jax.flatten_util.ravel_pytree`` of the same numpy tree
    (equal vectors, f32 and promoted dtypes), its round trip (equal
    leaves, shapes and dtypes), and, per lane, the order ``algos/lanes.
    flatten`` uses for the policy vector."""
    rng = np.random.default_rng(3)

    def tree(xp):
        f = lambda *s: xp(rng.normal(size=s).astype(np.float32))  # noqa: E731
        return {"pol": [{"w": f(3, 2), "b": f(2)}, {"w": f(2, 1), "b": f(1)}],
                "logstd": f(1), "z": None,
                "ob_rms": RunningMeanStd(f(3), f(3), f())}

    rng = np.random.default_rng(3)
    ref, unravel = jax.flatten_util.ravel_pytree(tree(np.asarray))
    rng = np.random.default_rng(3)
    t = tree(torch.as_tensor)
    flat, unflatten = umath.flatten(t)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(ref))
    assert flat.dtype == torch.float32
    back = unflatten(flat * 2)
    jback = unravel(ref * 2)
    assert back["z"] is None and isinstance(back["ob_rms"], RunningMeanStd)
    for a, b in zip(umath._tree_leaves(back), jax.tree.leaves(jback)):
        assert a.shape == b.shape and a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # promoted dtypes: int32 and f32 leaves ravel to f32, come back as int32
    mixed = {"a": np.arange(3, dtype=np.int32), "b": np.ones(2, np.float32)}
    jflat, junravel = jax.flatten_util.ravel_pytree(mixed)
    pflat, punflatten = umath.flatten({k: torch.as_tensor(v)
                                       for k, v in mixed.items()})
    np.testing.assert_array_equal(pflat.numpy(), np.asarray(jflat))
    assert punflatten(pflat)["a"].dtype == torch.int32
    # the lanes' policy vector: lane k of lanes.flatten is flatten of lane k
    L = 3
    stacked = {"pol": [{"w": torch.randn(L, 4, 3), "b": torch.randn(L, 1, 3)},
                       {"w": torch.randn(L, 3, 2), "b": torch.randn(L, 1, 2)}],
               "logstd": torch.randn(L, 1, 2)}
    vec = lanes.flatten(trpo.policy_leaves(stacked))
    for k in range(L):
        one = {"pol": [{"w": x["w"][k], "b": x["b"][k, 0]}
                       for x in stacked["pol"]],
               "logstd": stacked["logstd"][k, 0]}
        np.testing.assert_array_equal(umath.flatten(one)[0].numpy(),
                                      vec[k].numpy())


# --- Stats and the logger --------------------------------------------------

def _event_triplets(run_dir: str) -> list:
    """(tag, step, value) of every summary under one run directory, read the
    way it was stored: TF2 tensor summaries (JAX through TensorFlow) or
    ``simple_value`` scalars (the port through ``SummaryWriter``)."""
    from tensorboard.backend.event_processing import event_accumulator
    from tensorboard.util import tensor_util

    acc = event_accumulator.EventAccumulator(run_dir)
    acc.Reload()
    out = [(tag, ev.step, float(ev.value))
           for tag in acc.Tags()["scalars"] for ev in acc.Scalars(tag)]
    out += [(tag, ev.step, float(tensor_util.make_ndarray(ev.tensor_proto)))
            for tag in acc.Tags()["tensors"] for ev in acc.Tensors(tag)]
    return sorted(out)


def _only_run(logdir) -> str:
    runs = [os.path.join(logdir, d) for d in os.listdir(logdir)]
    assert len(runs) == 1, runs
    return runs[0]


_ROWS = [[1.5, 2.0, -3.25], [float("nan"), 1.0, 2.0], [0.5, None, 1.0],
         [np.float64(4.0), 7, 1e-3]]


def _write_stats(cls, logdir):
    st = cls(["a/x", "b", "c"], logdir=str(logdir))
    for step, row in enumerate(_ROWS):
        st.add_all_summary(row, step)
    return st


def test_stats_events_match_jax(tmp_path):
    """``Stats`` through TensorFlow (JAX) and through ``SummaryWriter``
    (the port): the same (tag, step, value) triplets, each read back as it
    was stored (TF2 tensors, ``simple_value`` scalars; both f32, equal);
    the rows holding a NaN or None are skipped."""
    _write_stats(jstatistics.Stats, tmp_path / "jax")
    _write_stats(statistics.Stats, tmp_path / "port").close()
    got = _event_triplets(_only_run(tmp_path / "port"))
    assert got == _event_triplets(_only_run(tmp_path / "jax"))
    assert sorted({s for _, s, _ in got}) == [0, 3] and len(got) == 6


def test_stats_jsonl_fallback_matches_jax(tmp_path, monkeypatch):
    """With ``tensorflow`` refused in JAX and ``tensorboard`` in the port,
    both write ``<logdir>/<int(time)>/stats.jsonl``: equal line for line."""
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    monkeypatch.setitem(sys.modules, "tensorboard", None)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    jst = _write_stats(jstatistics.Stats, tmp_path / "jax")
    _write_stats(statistics.Stats, tmp_path / "port").close()
    jst._jsonl.close()
    files = [os.path.join(_only_run(tmp_path / d), "stats.jsonl")
             for d in ("port", "jax")]
    lines = [open(f).read().splitlines() for f in files]
    assert lines[0] == lines[1] and len(lines[0]) == 2


_KVS = [{"loss": 0.25, "EpLenMean": float("nan"), "iters": 1,
         "name": "walk"},
        {"loss": np.float32(0.125), "EpLenMean": 12.5, "iters": 2,
         "extra": -1e-7, "name": "walk"},
        {"loss": 1e6, "iters": 3, "longer_key_name_than_twenty": 3.0}]


def _drive(mod, logdir, formats):
    """Three dumps through ``mod``'s module API (new keys appear; NaN,
    numpy and string values), ``logkv_mean``, a DEBUG line below the level
    and a WARN line at it, then DISABLED."""
    mod.configure(str(logdir), formats)
    for kvs in _KVS:
        for k, v in kvs.items():
            mod.logkv(k, v)
        for v in (1.0, 2.0, 4.5):
            mod.logkv_mean("mean", v)
        mod.dumpkvs()
    mod.log("hidden", level=mod.DEBUG)
    mod.log("shown", 3, level=mod.WARN)
    mod.set_level(mod.DISABLED)
    mod.logkv("never", 1.0)
    mod.dumpkvs()
    assert mod.get_dir() == str(logdir)
    mod.Logger.CURRENT.close()


def test_logger_formats_match_jax(tmp_path, monkeypatch, capsys):
    """Every format (stdout, log, csv, json, tensorboard) through the module
    API of both loggers: stdout, ``log.txt``, ``progress.csv`` and
    ``progress.json`` equal byte for byte (the ``Logging to`` lines name
    each one's directory), and the tensorboard (tag, step, value) triplets
    equal (non-finite values dropped key by key, not the row; the step
    counts the rows); nothing is written at DISABLED."""
    monkeypatch.setattr(jlogger.Logger, "CURRENT", None)
    monkeypatch.setattr(logger.Logger, "CURRENT", None)
    fmts = ["stdout", "log", "csv", "json", "tensorboard"]
    outs = {}
    for name, mod in (("jax", jlogger), ("port", logger)):
        _drive(mod, tmp_path / name, fmts)
        outs[name] = capsys.readouterr().out.replace(str(tmp_path / name),
                                                     "DIR")
    assert outs["port"] == outs["jax"] and "shown 3" in outs["port"]
    assert "hidden" not in outs["port"] and "never" not in outs["port"]
    for f in ("log.txt", "progress.csv", "progress.json"):
        port = (tmp_path / "port" / f).read_text()
        ref = (tmp_path / "jax" / f).read_text()
        assert port.replace(str(tmp_path / "port"), "DIR") == ref.replace(
            str(tmp_path / "jax"), "DIR"), f
    assert "never" not in (tmp_path / "port" / "progress.csv").read_text()
    got = _event_triplets(_only_run(tmp_path / "port" / "tb"))
    assert got == _event_triplets(_only_run(tmp_path / "jax" / "tb"))
    assert ("EpLenMean", 1, 12.5) in got and ("loss", 0, 0.25) in got
    assert ("mean", 2, float(np.float32(2.5))) in got
    assert not [t for t in got if t[0] == "EpLenMean" and t[1] == 0]


def test_configure_reads_the_log_env_as_jax_does(tmp_path, monkeypatch):
    """``configure()`` with no arguments under ``DMTPU_LOGDIR`` and
    ``DMTPU_LOG_FORMAT``, then under ``OPENAI_LOGDIR`` and
    ``OPENAI_LOG_FORMAT`` with a ``log_suffix``: both loggers write the
    same files with the same contents into the directory the environment
    names."""
    monkeypatch.setattr(jlogger.Logger, "CURRENT", None)
    monkeypatch.setattr(logger.Logger, "CURRENT", None)
    for key in ("DMTPU_LOGDIR", "OPENAI_LOGDIR", "DMTPU_LOG_FORMAT",
                "OPENAI_LOG_FORMAT"):
        monkeypatch.delenv(key, raising=False)
    cases = (("DMTPU", "csv,json,log", ""), ("OPENAI", "json,csv", "_7"))
    for prefix, fmt, suffix in cases:
        monkeypatch.setenv(f"{prefix}_LOG_FORMAT", fmt)
        files = {}
        for name, mod in (("jax", jlogger), ("port", logger)):
            d = tmp_path / prefix / name
            monkeypatch.setenv(f"{prefix}_LOGDIR", str(d))
            lg = mod.configure(log_suffix=suffix)
            assert lg.get_dir() == str(d)
            mod.logkv("a", 1.5)
            mod.logkv("b", "x")
            mod.dumpkvs()
            lg.close()
            files[name] = {f: (d / f).read_text().replace(str(d), "DIR")
                           for f in sorted(os.listdir(d))}
        assert files["port"] == files["jax"]
        assert sorted(files["port"]) == sorted(
            {"csv": f"progress{suffix}.csv", "json": f"progress{suffix}.json",
             "log": f"log{suffix}.txt"}[f] for f in fmt.split(","))
        monkeypatch.delenv(f"{prefix}_LOG_FORMAT")
        monkeypatch.delenv(f"{prefix}_LOGDIR")


def test_profile_kv_and_timed_match_jax(monkeypatch, capsys):
    """``profile_kv``/``profile`` add the block's time to ``wait_<scope>``
    (a clock stepped by 0.5 s per reading: equal sums) and ``timed`` prints
    the same lines, in both loggers."""
    monkeypatch.setattr(jlogger.Logger, "CURRENT", None)
    monkeypatch.setattr(logger.Logger, "CURRENT", None)
    waits = []
    for mod in (jlogger, logger):
        clock = iter(np.arange(100) * 0.5)
        monkeypatch.setattr(time, "time", lambda c=clock: float(next(c)))

        @mod.profile("fn")
        def fn(x):
            return x + 1

        with mod.profile_kv("scope"):
            pass
        assert fn(1) == 2 and fn(2) == 3
        with mod.timed("phase"):
            pass
        with mod.timed("off", enabled=False):
            pass
        waits.append(dict(mod.Logger.CURRENT.name2val))
    assert waits[0] == waits[1] == {"wait_scope": 0.5, "wait_fn": 1.0}
    out = capsys.readouterr().out.splitlines()
    assert out[:2] == out[2:] and len(out) == 4


def test_phase_timers_match_jax(monkeypatch):
    """``PhaseTimers`` on a stepped clock: equal totals, counts and
    report; a phase that raises still counts."""
    reports = []
    for mod in (jprofiling, profiling):
        clock = iter(np.arange(100) * 0.25)
        monkeypatch.setattr(time, "perf_counter",
                            lambda c=clock: float(next(c)))
        t = mod.PhaseTimers()
        for name in ("rollout", "update", "rollout"):
            with t.phase(name):
                pass
        with pytest.raises(ValueError):
            with t.phase("bad"):
                raise ValueError
        reports.append((t.report(), dict(t.counts)))
    assert reports[0] == reports[1]
    assert reports[1][1] == {"rollout": 2, "update": 1, "bad": 1}
    assert profiling.xla_trace is profiling.device_trace


# --- monitor, plotting, plot_curve ----------------------------------------

def _monitors(root, n_runs: int = 2, n_eps: int = 40):
    rng = np.random.default_rng(5)
    for k in range(n_runs):
        d = root / f"run{k}"
        d.mkdir(parents=True)
        m = monitor.Monitor(str(d), env_id="DPEnvV3")
        for _ in range(n_eps):
            m.record(rng.normal() * 10, int(rng.integers(10, 300)))
        m.close()
    return root


def test_load_results_matches_jax(tmp_path):
    """A monitor CSV read by both stacks: equal frames and headers."""
    import pandas

    path = os.path.join(_monitors(tmp_path) / "run0", "monitor.csv")
    df, ref = monitor.load_results(path), jmonitor.load_results(path)
    pandas.testing.assert_frame_equal(df, ref)
    assert df.attrs["headers"] == ref.attrs["headers"]
    assert len(df) == 40 and list(df.columns) == ["r", "l", "t"]


def test_smoothing_matches_jax():
    """``symmetric_ema`` (default and given bounds) and ``smooth`` (both
    modes, a series shorter than the window) on seeded data, to 1e-12."""
    rng = np.random.default_rng(11)
    x = np.sort(rng.uniform(0, 100, 200))
    y = rng.normal(size=200).cumsum()
    for kw in ({}, {"low": 10.0, "high": 90.0, "n": 64, "decay_steps": 3.0}):
        for a, b in zip(plotting.symmetric_ema(x, y, **kw),
                        jplotting.symmetric_ema(x, y, **kw)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    for mode in ("two_sided", "causal"):
        for radius in (1, 5, 150):
            np.testing.assert_allclose(plotting.smooth(y, radius, mode),
                                       jplotting.smooth(y, radius, mode),
                                       rtol=0, atol=1e-12)


def _lines(fig):
    return [(line.get_label(), np.asarray(line.get_xydata()))
            for line in fig.axes[0].get_lines()]


def test_plot_results_and_plot_curve_match_jax(tmp_path):
    """``plot_results(out_path=None)``: the same lines (labels and data, to
    1e-12), one per run and, with ``average_group``, one mean per group;
    ``plot_curve`` and ``cli/plot_curve`` write their figures."""
    import matplotlib.pyplot as plt

    root = _monitors(tmp_path / "logs")
    for kw in ({}, {"average_group": True,
                    "group_fn": lambda run: "all"}):
        fig, ref = (plotting.plot_results(str(root), **kw),
                    jplotting.plot_results(str(root), **kw))
        got, want = _lines(fig), _lines(ref)
        assert [g[0] for g in got] == [w[0] for w in want]
        for (_, a), (_, b) in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
        assert len(got) == (1 if kw else 2)
        plt.close(fig)
        plt.close(ref)
    for mod in (plotting, jplotting):
        out = str(tmp_path / f"{mod.__name__.split('.')[0]}.svg")
        assert mod.plot_curve(str(root), out) == out
        assert os.path.getsize(out) > 1000
    out = str(tmp_path / "cli" / "curve.png")
    text, path = stdout_of(plot_curve.main, ["--log-dir", str(root), "--out",
                                           out])
    assert path == out and os.path.getsize(out) > 1000
    assert text == f"wrote {out}\n"
    with pytest.raises(FileNotFoundError):
        plotting.plot_curve(str(tmp_path / "empty"))


# --- video -----------------------------------------------------------------

def test_video_saver_files_match_jax(tmp_path):
    """``VideoSaver`` on seeded frames (some at another size, resized):
    byte-equal files."""
    rng = np.random.default_rng(2)
    frames = [rng.integers(0, 255, (48, 64, 3), np.uint8) for _ in range(4)]
    frames += [rng.integers(0, 255, (30, 40, 3), np.uint8) for _ in range(2)]
    paths = []
    for mod in (video, jvideo):
        path = str(tmp_path / f"{mod.__name__.split('.')[0]}.avi")
        saver = mod.VideoSaver(width=64, height=48, fps=30, output_path=path)
        for f in frames:
            saver.add_frame(f)
        saver.close()
        paths.append(path)
    data = [open(p, "rb").read() for p in paths]
    assert data[0] == data[1] and len(data[0]) > 1000
    assert len(read_frames(paths[0])) == 6


def test_render_qpos_trajectory_matches_jax(tmp_path, monkeypatch):
    """Six walk frames through both stacks' ``render_qpos_trajectory``
    with the stub renderer: equal frames read back (the port's MJCF is
    byte-equal to JAX's), at the model's rate by default."""
    import mujoco

    monkeypatch.setattr(mujoco, "Renderer", StubRenderer)
    qpos = np.asarray(get_clip("walk").qpos[:6], np.float64)
    outs = []
    for mod in (video, jvideo):
        path = str(tmp_path / f"{mod.__name__.split('.')[0]}.avi")
        assert mod.render_qpos_trajectory(qpos, path, width=96,
                                          height=64) == path
        outs.append(read_frames(path))
    assert len(outs[0]) == 6
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    assert not all((a == outs[0][0]).all() for a in outs[0][1:])


def test_require_renderer_names_the_missing_library(monkeypatch):
    for name in ("mujoco", "cv2"):
        with monkeypatch.context() as m:
            m.setitem(sys.modules, name, None)
            with pytest.raises(ImportError, match=name) as err:
                video.require_renderer()
            assert err.value.name == name


# --- trace_summary ---------------------------------------------------------

_KERNELS = {
    "void apgd_kernel<__nv_bfloat16, 8>(Params)": "apgd",
    "void apgd_wide_kernel<__nv_bfloat16, 4, 3>(Params)": "apgd",
    "void apgd_kernelx(int)": "other",
    "sm90_xmma_gemm_f32f32_tf32f32_f32_nn_n_tilesize128x128x32": "gemm",
    "nvjet_tst_128x64_64x8_2x1_v_bz_TNT": "gemm",
    "void cutlass::Kernel2<cutlass_80_simt_sgemm_128x32_8x5_nn_align1>"
    "(Params)": "gemm",
    "void at::native::vectorized_elementwise_kernel<4, at::native::"
    "CUDAFunctor_add<float>, std::array<char*, 3ul> >(int, ...)":
        "elementwise",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
    "at::native::func_wrapper_t<float, at::native::sum_functor> > >(...)":
        "reduce",
    "void at::native::unrolled_elementwise_kernel<at::native::"
    "direct_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}>(...)":
        "copy/memset",
    "Memcpy HtoD (Pageable -> Device)": "copy/memset",
    "Memset (Device)": "copy/memset",
    "void at::native::index_elementwise_kernel<128, 4, ...>(...)":
        "index/gather/scatter",
    "void at::native::sbtopk::gatherTopK<float, unsigned int, 2, false>"
    "(...)": "sort/topk",
    "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<...>(...)":
        "sort/topk",
    "void at::native::(anonymous namespace)::distribution_elementwise_grid_"
    "stride_kernel<float, 4, ...>(...)": "rng",
    "void at::native::elementwise_kernel<128, 2, at::native::FillFunctor"
    "<float> >(...)": "copy/memset",
    "void at::native::mbtopk::fill<unsigned int>(...)": "sort/topk",
    "some_custom_kernel": "other",
}


def test_trace_categories_of_cuda_kernel_names():
    """Every named CUDA kernel (torch's, cuBLAS/CUTLASS, the APGD kernels
    by their exact names) falls in its category."""
    for name, cat in _KERNELS.items():
        assert trace_summary.categorize(name) == cat, name


def _synthetic_trace(path):
    """A torch-style chrome trace: metadata, CPU ops, CUDA runtime calls,
    and device events on a GPU track (kernels, a memcpy, a memset)."""
    rng = np.random.default_rng(9)
    events = [{"ph": "M", "name": "process_name", "pid": 77, "tid": 0,
               "args": {"name": "python"}},
              {"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
               "args": {"name": "GPU 0"}}]
    ts = 1000.0
    cat_of = {"Memcpy HtoD (Pageable -> Device)": "gpu_memcpy",
              "Memset (Device)": "gpu_memset"}
    names = list(_KERNELS)
    for i in range(300):
        name = names[int(rng.integers(len(names)))]
        dur = float(rng.uniform(1, 50))
        events.append({"ph": "X", "cat": "cpu_op", "name": "aten::add",
                       "pid": 77, "tid": 77, "ts": ts, "dur": 3.0})
        events.append({"ph": "X", "cat": "cuda_runtime",
                       "name": "cudaLaunchKernel", "pid": 77, "tid": 77,
                       "ts": ts + 1, "dur": 2.0})
        events.append({"ph": "X", "cat": cat_of.get(name, "kernel"),
                       "name": name, "pid": 0, "tid": 7, "ts": ts + 5,
                       "dur": dur, "args": {"correlation": i}})
        events.append({"ph": "f", "id": i, "pid": 0, "tid": 7,
                       "ts": ts + 5, "cat": "ac2g", "name": "ac2g"})
        ts += dur + float(rng.uniform(0, 10))
    with gzip.open(path, "wt") as f:
        f.write(json.dumps({"schemaVersion": 1, "traceEvents": events,
                            "traceName": "x"}, indent=1))
    return events


def test_trace_summary_matches_jax_tool(tmp_path, monkeypatch):
    """On one synthetic ``.trace.json.gz``: ``iter_events`` yields JAX's
    tool's events; the summary has the tool's keys, the device events'
    busy time, span and per-name counts, and the port's CLI writes and
    prints it."""
    jtool = _jax_tool("trace_summary")
    d = tmp_path / "trace"
    d.mkdir()
    path = str(d / "host.1.2.trace.json.gz")
    events = _synthetic_trace(path)
    got = list(trace_summary.iter_events(path))
    assert got == list(jtool.iter_events(path)) == events
    monkeypatch.setattr(sys, "argv", ["trace_summary", str(d), "--out",
                                      str(tmp_path / "jax.json")])
    stdout_of(jtool.main)
    ref = json.loads((tmp_path / "jax.json").read_text())
    text, summary = stdout_of(trace_summary.main, [str(d), "--out",
                                                 str(tmp_path / "p.json")])
    assert json.loads((tmp_path / "p.json").read_text()) == summary
    assert sorted(summary) == sorted(list(ref) + ["by_category_count"])
    dev = [e for e in events if e.get("cat") in trace_summary.DEVICE_CATS]
    assert summary["n_events"] == len(dev) == 300
    assert summary["device_tracks"] == ["GPU 0"]
    assert summary["busy_ms"] == round(sum(e["dur"] for e in dev) / 1e3, 2)
    span = max(e["ts"] + e["dur"] for e in dev) - min(e["ts"] for e in dev)
    assert summary["span_ms"] == round(span / 1e3, 2)
    want = collections.Counter(_KERNELS[e["name"]] for e in dev)
    assert summary["by_category_count"] == dict(want)
    short = trace_summary.summarize(path, top=3)
    assert len(short["top_ops"]) == 3
    assert short["by_category_count"] == dict(want)
    full = trace_summary.summarize(path, top=None)
    assert sum(r["count"] for r in full["top_ops"]) == 300
    assert f"busy {summary['busy_ms']} ms" in text and "apgd" in text


def test_cpu_device_trace_holds_no_device_event(tmp_path):
    """``device_trace`` around CPU work, and ``cli/profile_trace`` at 2 envs
    × 2 steps on the CPU: a chrome trace is written where the summary
    finds it, with zero device events, and the summary says so."""
    with profiling.device_trace(str(tmp_path / "a")) as prof:
        x = torch.randn(64, 64)
        (x @ x).sum()
    assert any("aten::mm" in e.key for e in prof.key_averages())
    assert profiling.device_self_us(prof) == 0.0
    with profiling.device_trace(str(tmp_path / "off"), enabled=False) as p:
        assert p is None
    assert not os.path.exists(tmp_path / "off")
    text, summary = stdout_of(trace_summary.main, [str(tmp_path / "a")])
    assert summary["n_events"] == 0 and summary["busy_ms"] == 0.0
    assert "no device events" in text
    text, res = stdout_of(profile_trace.main, [
        "--device", "cpu", "--num-envs", "2", "--horizon", "2", "--iters",
        "1", "--out", str(tmp_path / "pt")])
    assert "traced 1 iterations:" in text and res["apgd_launches"] == 0
    assert profiling.device_self_us(res["profile"]) == 0.0
    summary = trace_summary.summarize(
        trace_summary.find_trace(str(tmp_path / "pt")))
    assert summary["n_events"] == 0
    with pytest.raises(SystemExit):
        trace_summary.main([str(tmp_path / "empty")])
