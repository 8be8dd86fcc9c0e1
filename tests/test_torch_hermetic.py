"""The port runs without JAX, MuJoCo or the JAX package.

The machine with the card has PyTorch but neither JAX nor MuJoCo, so any
import of them — or of ``deepmimic_mujoco_tpu``, whose modules import JAX —
from ``deepmimic_mujoco_torch`` or ``chip_smoke.py`` would stop the port
there at import.  One test runs the CLIs in a subprocess whose import
system refuses those packages, another imports the modules that reach the
host-MuJoCo backend or the host-only libraries there; the others scan the
sources.  MuJoCo may be imported only by ``physics/mj_host.py``,
``io_utils/video.py`` and ``cli/ball_vs_hinge_study.py``, and only inside
their functions; cv2, matplotlib,
pandas and tensorboard, which serve rendering, plots and logs on the host,
only inside functions."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
FORBIDDEN = ("jax", "jaxlib", "mujoco", "deepmimic_mujoco_tpu")
# the modules that may import MuJoCo, inside their functions only
MJ_HOST = os.path.join(ROOT, "deepmimic_mujoco_torch", "physics",
                       "mj_host.py")
VIDEO = os.path.join(ROOT, "deepmimic_mujoco_torch", "io_utils", "video.py")
BALL_VS_HINGE = os.path.join(ROOT, "deepmimic_mujoco_torch", "cli",
                             "ball_vs_hinge_study.py")
# host-only libraries: imported inside functions only, anywhere
HOST_ONLY = ("cv2", "matplotlib", "pandas", "tensorboard")

_BLOCKER = """
import runpy, sys
FORBIDDEN = {forbidden!r}
TMP = {tmp!r}
EXPERT = {expert!r}
SPEC = {spec!r}

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError(f"import of {{name}} refused")
        return None

sys.meta_path.insert(0, Refuse())
sys.argv = ["train_trpo", "--task", "evaluate", "--device", "cpu",
            "--eval-episodes", "2", "--eval-horizon", "3"]
runpy.run_module("deepmimic_mujoco_torch.cli.train_trpo", run_name="__main__")
sys.argv = ["imitation15_vmapped", "--eval-only", "--device", "cpu",
            "--clips", "walk,kick", "--envs", "2", "--hidden-sizes", "16",
            "--eval-episodes", "2", "--eval-horizon", "3",
            "--out", TMP + "/out.json", "--ckpt-root", TMP + "/ckpt",
            "--log-root", TMP + "/logs"]
runpy.run_module("deepmimic_mujoco_torch.cli.imitation15_vmapped",
                 run_name="__main__")
sys.argv = ["train_gail", "--device", "cpu", "--expert-path", EXPERT,
            "--reward-mode", "imitation_dm", "--control-mode", "pd_residual",
            "--reset-mode", "rsi", "--n-substeps", "2", "--obs-mode", "full",
            "--num-envs", "2", "--timesteps-per-batch", "2", "--g-step", "1",
            "--num-iters", "1", "--pretrained", "--bc-max-iters", "2",
            "--log-dir", TMP + "/glogs", "--checkpoint-dir", TMP + "/gckpt"]
runpy.run_module("deepmimic_mujoco_torch.cli.train_gail", run_name="__main__")
sys.argv = ["train_trpo", "--algo", "ppo", "--task", "train", "--device",
            "cpu", "--num-iters", "1", "--num-envs", "2",
            "--timesteps-per-batch", "4", "--ppo-minibatches", "2",
            "--log-dir", TMP + "/plogs", "--checkpoint-dir", TMP + "/pckpt"]
runpy.run_module("deepmimic_mujoco_torch.cli.train_trpo", run_name="__main__")
for surface in ("deepmimic", "v3"):
    sys.argv = ["train_ppo", "--device", "cpu", "--surface", surface,
                "--num-envs", "2", "--num-iters", "1", "--agent-spec", SPEC,
                "--max-episode-steps", "4", "--log-dir", TMP + "/dlogs",
                "--checkpoint-dir", TMP + "/dckpt"]
    runpy.run_module("deepmimic_mujoco_torch.cli.train_ppo",
                     run_name="__main__")
sys.argv = ["get_action", "--device", "cpu", "--arg-file",
            "assets/args/run_humanoid3d_walk_args.txt"]
runpy.run_module("deepmimic_mujoco_torch.cli.get_action", run_name="__main__")
sys.argv = ["train_trpo", "--env-id", "DPEnvV2", "--task", "train", "--device",
            "cpu", "--num-iters", "1", "--num-envs", "2",
            "--timesteps-per-batch", "2", "--g-step", "1",
            "--log-dir", TMP + "/vlogs", "--checkpoint-dir", TMP + "/vckpt"]
runpy.run_module("deepmimic_mujoco_torch.cli.train_trpo", run_name="__main__")
sys.argv = ["torque_test", "--device", "cpu", "--steps", "3"]
runpy.run_module("deepmimic_mujoco_torch.cli.torque_test", run_name="__main__")
sys.argv = ["play_mocap", "--device", "cpu", "--through-dynamics",
            "--cycles", "1"]
runpy.run_module("deepmimic_mujoco_torch.cli.play_mocap", run_name="__main__")
assert not [m for m in sys.modules if m.split(".")[0] in FORBIDDEN]
"""


def test_cli_evaluate_runs_with_jax_and_mujoco_refused(tmp_path):
    """The walk evaluation, the lane tool, GAIL training (BC included), PPO
    training, the original-stack PPO CLI on both surfaces, get_action,
    DPEnvV2 training, torque_test and play_mocap run with JAX and MuJoCo
    refused."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    spec = tmp_path / "spec.json"
    spec.write_text('{"BatchSize": 8, "MiniBatchSize": 4}')
    code = _BLOCKER.format(forbidden=FORBIDDEN, tmp=str(tmp_path),
                           expert=os.path.join(ROOT, "assets", "expert",
                                               "walk_expert.npz"),
                           spec=str(spec))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Average length: 3.0" in proc.stdout
    assert "| kick |" in proc.stdout and (tmp_path / "out.json").exists()
    assert "BC iter 1: loss" in proc.stdout and "EpTrueRewMean" in proc.stdout
    assert (tmp_path / "gckpt" / "DPEnvV3" / "gail-walk-0" /
            "gail_state.npz").exists()
    assert (tmp_path / "pckpt" / "DPEnvV3" / "ppo-walk-0" /
            "trpo_state.npz").exists()
    for surface in ("deepmimic", "v3"):
        assert (tmp_path / "dckpt" / surface / "ppo-walk-0" /
                "ppo_params.npz").exists()
    assert "shape: (36,)" in proc.stdout
    assert (tmp_path / "vckpt" / "DPEnvV2" / "trpo-walk-0" /
            "trpo_state.npz").exists()
    assert "mean tracking reward over 3 steps" in proc.stdout
    assert "cycle 0: mean config reward" in proc.stdout


def _sources():
    pkg = os.path.join(ROOT, "deepmimic_mujoco_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _imports(path):
    """(root package, inside a function) of every import in a source."""
    tree = ast.parse(open(path).read(), path)

    def visit(node, in_fn):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], in_fn
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], in_fn
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            yield node.args[0].value.split(".")[0], in_fn
        in_fn = in_fn or isinstance(node, (ast.FunctionDef,
                                           ast.AsyncFunctionDef, ast.Lambda))
        for child in ast.iter_child_nodes(node):
            yield from visit(child, in_fn)

    yield from visit(tree, False)


def _imported_roots(path):
    for root, _ in _imports(path):
        yield root


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_sources_import_no_jax(path):
    """No source imports JAX or the JAX package; none but
    ``physics/mj_host.py``, ``io_utils/video.py`` and
    ``cli/ball_vs_hinge_study.py`` imports MuJoCo."""
    allowed = ({"mujoco"} if path in (MJ_HOST, VIDEO, BALL_VS_HINGE)
               else set())
    bad = sorted(set(_imported_roots(path)) & (set(FORBIDDEN) - allowed))
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_mj_host_imports_mujoco_only_inside_functions():
    for path in (MJ_HOST, VIDEO, BALL_VS_HINGE):
        found = [in_fn for root, in_fn in _imports(path) if root == "mujoco"]
        assert found and all(found), (path, found)


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_host_only_libraries_are_imported_inside_functions(path):
    """cv2, matplotlib, pandas and tensorboard appear only inside
    functions."""
    bad = sorted({root for root, in_fn in _imports(path)
                  if root in HOST_ONLY and not in_fn})
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad} at top level"


_MJ_BLOCKER = """
import sys
FORBIDDEN = {forbidden!r} + {host_only!r}

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError(f"import of {{name}} refused")
        return None

sys.meta_path.insert(0, Refuse())
import deepmimic_mujoco_torch.physics.mj_host
import deepmimic_mujoco_torch.envs.dp_env_v3
import deepmimic_mujoco_torch.cli.train_trpo
import deepmimic_mujoco_torch.io_utils.video
import deepmimic_mujoco_torch.utils.plotting
import deepmimic_mujoco_torch.utils.statistics
import deepmimic_mujoco_torch.cli.plot_curve
import deepmimic_mujoco_torch.cli.render_policy
import deepmimic_mujoco_torch.cli.render_vmapped
import deepmimic_mujoco_torch.cli.play_mocap
for study in ("warmstart_study", "contactcap_study", "clip_tracking_study",
              "tracking_ceiling_probe", "setting_states", "gen_assets",
              "import_motions", "imitation15_suite", "scaling_bench",
              "ball_vs_hinge_study"):
    __import__("deepmimic_mujoco_torch.cli." + study)
import deepmimic_mujoco_torch.utils.divergence
from deepmimic_mujoco_torch.cli import ball_vs_hinge_study
assert ball_vs_hinge_study.main(["--v1-xml", "absent.xml"]) == {{
    "skipped": "reference XML absent"}}
from deepmimic_mujoco_torch.envs.dp_env_v3 import DPEnvV3
try:
    DPEnvV3(dynamics="mujoco", device="cpu")
except ImportError as e:
    print("refused:", e)
assert not [m for m in sys.modules if m.split(".")[0] in FORBIDDEN]
"""


def test_mj_host_env_and_cli_import_with_mujoco_refused():
    """``physics.mj_host``, ``envs.dp_env_v3``, ``cli.train_trpo`` and the
    rendering, plotting and stats modules with their CLIs
    (``io_utils.video``, ``utils.plotting``, ``utils.statistics``,
    ``cli.plot_curve``, ``cli.render_policy``, ``cli.render_vmapped``,
    ``cli.play_mocap``), the studies' and data tools' CLIs, the suite,
    the scaling bench, the ball-vs-hinge study (which runs to its note
    without the upstream XML) and ``utils.divergence`` import with MuJoCo,
    cv2, matplotlib, pandas and tensorboard (and JAX) refused; only
    building the MuJoCo backend reaches for it."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", _MJ_BLOCKER.format(forbidden=FORBIDDEN,
                                                  host_only=HOST_ONLY)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "refused: import of mujoco refused" in proc.stdout
