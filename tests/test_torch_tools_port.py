"""The ports of the last JAX tools (``deepmimic_mujoco_torch/cli/
imitation15_suite.py``, ``scaling_bench.py``, ``ball_vs_hinge_study.py``)
against ``tools/imitation15_suite.py``, ``tools/scaling_bench.py`` and
``tools/ball_vs_hinge_study.py``, loaded by path, on the CPU.

No JAX physics program is compiled: the suite's subprocesses are replaced
by a stub that records their command lines, JAX's scaling tool runs on
stubbed timings, and the ball-vs-hinge study is MuJoCo and numpy in both
stacks."""

import importlib.util
import io
import json
import math
import os
import subprocess
import sys
import types
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from deepmimic_mujoco_torch.cli import (
    ball_vs_hinge_study,
    eval_imitation,
    imitation15_suite,
    scaling_bench,
)
from deepmimic_mujoco_torch.physics.humanoid import to_mjcf_v1_ball

torch.set_num_threads(1)

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
WALK_R2 = os.path.join(ROOT, "train_ckpt_walk_r2", "DPEnvV3", "trpo-walk-0",
                       "trpo_state.npz")


def _jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def eval_printout():
    """What the port's ``cli.eval_imitation`` prints for the suite's eval
    flags (walk_r2, 2 episodes of 4 steps, on the CPU)."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        eval_imitation.main([
            "--ckpt", WALK_R2, "--motion", "walk", "--episodes", "2",
            "--horizon", "4", "--joint-limits", "mocap", "--hidden-sizes",
            "1024,512", "--activation", "relu", "--device", "cpu"])
    return buf.getvalue()


def test_eval_printout_has_the_jax_tool_lines(eval_printout):
    """The three lines the suite's regexes read, laid out as JAX's
    ``tools/eval_imitation.py`` prints them."""
    lines = eval_printout.splitlines()
    assert lines[0] == "episodes           : 2 (RSI starts, deterministic policy)"
    assert lines[1].startswith("EpLen   mean/median: 4.0 / 4  (cap 4)")
    assert lines[2].startswith("EpRew   mean       : ")
    assert lines[2].endswith("/step)")
    assert lines[3].startswith("pose err (weighted): ")
    assert lines[3].endswith(" deg") and " rad ≈ " in lines[3]


def _stub_run(calls: list, stdout: str):
    """A ``subprocess.run`` that records each command; training writes the
    checkpoint the suite looks for, evaluation prints ``stdout``."""
    def run(cmd, cwd=None, capture_output=False, text=False, timeout=None):
        calls.append((list(cmd), cwd, timeout))
        if "--checkpoint-dir" in cmd:
            motion = cmd[cmd.index("--motion") + 1]
            d = os.path.join(cmd[cmd.index("--checkpoint-dir") + 1],
                             "DPEnvV3", f"trpo-{motion}-0")
            os.makedirs(d, exist_ok=True)
            open(os.path.join(d, "trpo_state.npz"), "w").close()
            return types.SimpleNamespace(returncode=0, stdout="", stderr="")
        return types.SimpleNamespace(returncode=0, stdout=stdout, stderr="")
    return run


def _as_port(cmd: list) -> list:
    """JAX's command line with the port's module names."""
    out = []
    for c in cmd:
        if c == "deepmimic_mujoco_tpu.cli.train_trpo":
            out.append("deepmimic_mujoco_torch.cli.train_trpo")
        elif c == os.path.join(ROOT, "tools", "eval_imitation.py"):
            out += ["-m", "deepmimic_mujoco_torch.cli.eval_imitation"]
        else:
            out.append(c)
    return out


@pytest.mark.parametrize("motion", ["walk", "backflip"])
def test_suite_builds_jax_command_lines_and_rows(motion, eval_printout,
                                                 tmp_path, monkeypatch):
    """``run_clip`` runs JAX's two subprocesses, the same command lines up
    to the module names (and ``--device cpu`` when asked), and parses the
    port's evaluation printout into JAX's row."""
    jax_suite = _jax_tool("imitation15_suite")
    assert jax_suite.CLIPS == imitation15_suite.CLIPS
    assert jax_suite.TRAIN_ARGS == imitation15_suite.TRAIN_ARGS
    rows, calls = {}, {}
    for name, mod in (("jax", jax_suite), ("port", imitation15_suite)):
        calls[name] = []
        monkeypatch.setattr(mod.subprocess, "run",
                            _stub_run(calls[name], eval_printout))
        rows[name] = mod.run_clip(motion, 3, 2, 11, 7,
                                  str(tmp_path / name / "logs"),
                                  str(tmp_path / name / "ckpt"))
    want = [(_as_port(c), cwd, t) for c, cwd, t in calls["jax"]]
    got = [(c, cwd, t) for c, cwd, t in calls["port"]]
    assert [(c, cwd, t) for c, cwd, t in want] == [
        ([x.replace(str(tmp_path / "port"), str(tmp_path / "jax"))
          for x in c], cwd, t) for c, cwd, t in got]
    for row in rows.values():
        row.pop("train_s")
    assert rows["port"] == rows["jax"]
    assert set(rows["port"]) == {"motion", "iters", "eplen_mean",
                                 "eplen_median", "horizon_cap", "eprew_mean",
                                 "rew_per_step", "pose_err_rad"}
    assert rows["port"]["eplen_mean"] == 4.0

    calls["cpu"] = []
    monkeypatch.setattr(imitation15_suite.subprocess, "run",
                        _stub_run(calls["cpu"], eval_printout))
    imitation15_suite.run_clip(motion, 3, 2, 11, 7,
                               str(tmp_path / "port" / "logs"),
                               str(tmp_path / "port" / "ckpt"), "cpu")
    assert [c for c, _, _ in calls["cpu"]] == [
        c + ["--device", "cpu"] for c, _, _ in got]


def test_suite_main_writes_the_jax_table_and_file(eval_printout, tmp_path,
                                                  monkeypatch, capsys):
    """``main`` on two clips, one of whose trainings fails: the JSON file
    and the markdown table of the JAX tool."""
    out = {}
    for name, mod in (("jax", _jax_tool("imitation15_suite")),
                      ("port", imitation15_suite)):
        calls = []
        ok = _stub_run(calls, eval_printout)

        def run(cmd, **kw):
            if "--motion" in cmd and cmd[cmd.index("--motion") + 1] == "kick" \
                    and "--checkpoint-dir" in cmd:
                return types.SimpleNamespace(returncode=3, stdout="",
                                             stderr="boom")
            return ok(cmd, **kw)
        monkeypatch.setattr(mod.subprocess, "run", run)
        path = tmp_path / f"{name}.json"
        argv = ["--clips", "walk,kick", "--iters", "2", "--episodes", "2",
                "--out", str(path), "--log-root", str(tmp_path / "l"),
                "--ckpt-root", str(tmp_path / "c")]
        monkeypatch.setattr(sys, "argv", ["suite"] + argv)
        (mod.main() if name == "jax" else mod.main(argv))
        text = capsys.readouterr().out
        table = text[text.index("| motion |"):text.index("\nwrote")]
        rows = json.loads(path.read_text())
        for r in rows["rows"]:
            r.pop("train_s", None)
        out[name] = (table, rows)
    assert out["port"] == out["jax"]
    assert "| kick | — | — | — | train rc=3: boom |" in out["port"][0]


def test_scaling_bench_on_gloo_ranks_prints_jax_keys(capsys):
    """``--platform cpu --devices 1,2``: one rank in this process, then two
    gloo ranks; JAX's keys with finite values, efficiency 1 at the first
    size."""
    rows = scaling_bench.main(["--platform", "cpu", "--devices", "1,2",
                               "--envs-per-device", "2", "--horizon", "2",
                               "--iters", "1"])
    printed = [json.loads(line) for line in
               capsys.readouterr().out.strip().splitlines()]
    assert printed == rows and [r["devices"] for r in rows] == [1, 2]
    for r in rows:
        assert set(r) == {"devices", "env_steps_per_s", "scaling_efficiency"}
        assert math.isfinite(r["env_steps_per_s"]) and r["env_steps_per_s"] > 0
        assert math.isfinite(r["scaling_efficiency"])
    assert rows[0]["scaling_efficiency"] == 1.0


def test_scaling_efficiency_follows_the_jax_formula(monkeypatch, capsys):
    """On stubbed env-steps/s, the port prints what JAX's tool prints."""
    import jax

    sps = {2: 1000.04, 4: 1873.26, 8: 3000.0}
    jax_tool = _jax_tool("scaling_bench")
    monkeypatch.setattr(jax_tool, "run_one", lambda n, *a: sps[n])
    monkeypatch.setattr(jax.config, "update", lambda *a: None)
    monkeypatch.setattr(sys, "argv", ["scaling_bench", "--devices", "2,4,8"])
    jax_tool.main()
    want = capsys.readouterr().out
    monkeypatch.setattr(scaling_bench, "run_one", lambda n, *a: sps[n])
    scaling_bench.main(["--platform", "cpu", "--devices", "2,4,8"])
    assert capsys.readouterr().out == want
    assert [json.loads(x)["scaling_efficiency"]
            for x in want.splitlines()] == [1.0, 0.937, 0.75]


def test_scaling_bench_refuses_more_ranks_than_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="need 2 devices, have 1"):
        scaling_bench.run_one(2, 2, 2, 1, torch.device("cuda"))


def test_ball_vs_hinge_reads_jax_constants_and_notes_a_missing_xml(
        tmp_path, capsys):
    from deepmimic_mujoco_tpu.mocap import constants as jc
    from deepmimic_mujoco_tpu.mocap import registry as jr

    for name in ("BODY_JOINTS", "DOF_DEF", "JOINT_WEIGHT", "PARAMS_KP_KD"):
        assert getattr(ball_vs_hinge_study, name) == getattr(jc, name), name
    assert ball_vs_hinge_study.available_clips() == jr.available_clips()
    np.testing.assert_array_equal(
        np.asarray(ball_vs_hinge_study.get_clip("walk").qpos),
        np.asarray(jr.get_clip("walk").qpos))
    note = ball_vs_hinge_study.main(["--v1-xml", str(tmp_path / "none.xml")])
    assert note == {"skipped": "reference XML absent"}
    assert json.loads(capsys.readouterr().out) == note


def test_ball_vs_hinge_report_equals_jax_on_a_ball_joint_model(
        tmp_path, monkeypatch):
    """Both tools on the ball-joint v1 model of ``to_mjcf_v1_ball`` (the
    upstream XML is not in the repository): the same report, byte for
    byte."""
    pytest.importorskip("mujoco")
    xml = tmp_path / "v1_ball.xml"
    xml.write_text(to_mjcf_v1_ball())
    argv = ["--clips", "walk,spinkick", "--horizon", "12", "--fk-frames", "4"]
    jax_tool = _jax_tool("ball_vs_hinge_study")
    monkeypatch.setattr(jax_tool, "V1_XML", str(xml))
    monkeypatch.setattr(sys, "argv", ["study", *argv, "--out",
                                      str(tmp_path / "jax.json")])
    jax_tool.main()
    report = ball_vs_hinge_study.main(argv + ["--v1-xml", str(xml), "--out",
                                              str(tmp_path / "port.json")])
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "jax.json").read_bytes()
    assert report["summary"]["fk_max_dpos_all"] == 0.0
    assert set(report["pd_tracking"]) == {"walk", "spinkick"}
