"""The solver-accuracy studies of the port (``cli/warmstart_study.py``,
``cli/contactcap_study.py``) against the JAX package's tools on the CPU.

The P-controller tracking rollout of each stack (the JAX tool's
``rollout``, loaded by path from ``tools/warmstart_study.py``) runs 8
control steps of walk from frame 0 under the same model: qpos within 1e-4
of max(1, |x|) for f32 A and 1e-3 for bf16 A (the rounding of A to bf16
differs by an ulp where the two stacks' f32 sums differ).  Four jitted JAX
physics programs: ``cold50``, ``warm25+bf16``, ``cap8`` and ``full``.  The
studies' configurations and RMS tables are checked without physics."""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from deepmimic_mujoco_tpu.envs import DPEnvV3 as JaxDPEnvV3
from deepmimic_mujoco_tpu.physics import build_humanoid as jax_build
from deepmimic_mujoco_torch.cli import contactcap_study, warmstart_study
from deepmimic_mujoco_torch.envs.dp_env_v3 import DPEnvV3
from deepmimic_mujoco_torch.physics.humanoid import build_humanoid

torch.set_num_threads(1)

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
STEPS = 8
BOUND = {"f32": 1e-4, "bf16": 1e-3}
SOLVER_FIELDS = ("iterations", "warm_iterations", "solver_dtype",
                 "stage_reuse", "stage_iterations", "max_contacts",
                 "max_limits")


def _tool(name: str):
    """A JAX tool under ``tools/``, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_configs() -> dict:
    """The models of ``tools/warmstart_study.py:55-78``."""
    rep = dataclasses.replace
    base = jax_build(warm_iterations=0, solver_dtype="f32")
    kin = dict(warm_iterations=25, solver_dtype="bf16", stage_reuse="kin")
    return {
        "cold300": rep(base, iterations=300),
        "cold50": base,
        "warm25": rep(base, warm_iterations=25),
        "warm15": rep(base, warm_iterations=15),
        "warm10": rep(base, warm_iterations=10),
        "bf16": rep(base, solver_dtype="bf16"),
        "warm25+bf16": rep(base, warm_iterations=25, solver_dtype="bf16"),
        "stage_kin": rep(base, **kin),
        "stage_kin8": rep(base, **kin, stage_iterations=8),
        "stage_kin12": rep(base, **kin, stage_iterations=12),
        "stage_kin12w15": rep(base, warm_iterations=15, solver_dtype="bf16",
                              stage_reuse="kin", stage_iterations=12),
    }


def _rel_err(q, ref) -> float:
    return float(np.max(np.abs(q - ref) / np.maximum(1.0, np.abs(ref))))


def test_warmstart_configs_are_jax_s():
    ours, theirs = warmstart_study.configs("cpu"), _jax_configs()
    assert list(ours) == list(theirs)
    for name, m in ours.items():
        assert m.device.type == "cpu"
        for f in SOLVER_FIELDS:
            assert getattr(m, f) == getattr(theirs[name], f), (name, f)


@pytest.mark.parametrize("name", ["cold50", "warm25+bf16"])
def test_warmstart_rollout_matches_jax_tool(name):
    jtool = _tool("warmstart_study")
    jq = jtool.rollout(JaxDPEnvV3(clip="walk", model=_jax_configs()[name],
                                  n_substeps=1), n_steps=STEPS)
    model = warmstart_study.configs("cpu")[name]
    q = warmstart_study.rollout(DPEnvV3(clip="walk", model=model,
                                        n_substeps=1), STEPS)
    assert q.shape == jq.shape == (STEPS, 35)
    assert np.isfinite(q).all()
    assert _rel_err(q, jq) <= BOUND[model.solver_dtype], _rel_err(q, jq)


@pytest.mark.parametrize("cap", ["cap8", "full"])
def test_contactcap_rollout_matches_jax(cap):
    """Each cap's walk rollout against JAX's under the same caps: ``cap8`` is
    ``build_humanoid()``'s model (ne 32), ``full`` the uncapped one (ne
    139); both store A in bf16."""
    cc, lc = contactcap_study.CAPS[cap]
    jtool = _tool("contactcap_study")
    jq = jtool.rollout(JaxDPEnvV3(clip="walk", model=jax_build(
        contact_cap=cc, limit_cap=lc), n_substeps=1), n_steps=STEPS)
    model = build_humanoid(contact_cap=cc, limit_cap=lc, device="cpu")
    q = warmstart_study.rollout(DPEnvV3(clip="walk", model=model,
                                        n_substeps=1), STEPS)
    assert model.solver_dtype == "bf16"
    assert _rel_err(q, jq) <= BOUND["bf16"], _rel_err(q, jq)


def test_rms_table_is_the_tools_formula():
    """``rms_table`` gives, per track, the tools' ``sqrt(mean((q[:20] −
    truth[:20])²))`` and the same over all steps, on fixed arrays."""
    rng = np.random.RandomState(0)
    trajs = {k: rng.randn(40, 35) for k in ("cold300", "a", "b")}
    table = warmstart_study.rms_table(trajs, "cold300")
    truth = trajs["cold300"]
    assert list(table) == ["a", "b"]
    for k, (d20, d40) in table.items():
        q = trajs[k]
        assert d20 == float(np.sqrt(np.mean((q[:20] - truth[:20]) ** 2)))
        assert d40 == float(np.sqrt(np.mean((q - truth) ** 2)))
    assert warmstart_study.rms(truth, truth) == 0.0
    short = warmstart_study.rms_table(trajs, "cold300", short=5)
    assert short["a"][0] == warmstart_study.rms(trajs["a"][:5], truth[:5])


def test_study_clis_report_their_tracks_rms(capsys):
    """Both CLIs on the CPU at 2 steps: the tracks of the configs asked
    for, and the RMS of each against the study's truth, as printed."""
    out = warmstart_study.main(["--device", "cpu", "--steps", "2",
                                "--configs", "cold300,cold50"])
    assert list(out["qpos"]) == ["cold300", "cold50"]
    assert out["rms"] == warmstart_study.rms_table(out["qpos"], "cold300",
                                                   short=2)
    caps = contactcap_study.main(["--device", "cpu", "--steps", "2",
                                  "--caps", "full,cap10"])
    assert list(caps["qpos"]) == [(c, k) for c in ("walk", "spinkick")
                                  for k in ("full", "cap10")]
    assert list(caps["rms"]) == [("walk", "cap10"), ("spinkick", "cap10")]
    printed = capsys.readouterr().out
    assert "qpos RMS vs cold300 (2 steps)" in printed
    assert "[spinkick]      cap10" in printed
    with pytest.raises(ValueError, match="unknown configs"):
        warmstart_study.main(["--device", "cpu", "--configs", "warm99"])
