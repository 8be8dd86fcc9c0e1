"""The port's model importers and exporters against the JAX reference on the
CPU: ``humanoid.to_mjcf`` and ``to_mjcf_v1_ball`` (byte for byte),
``mjcf.parse_mjcf`` / ``load_mjcf`` (every model field, the calibrated
``minv_mode``, the refusals) and ``deepmimic_character.load_character`` /
``export_character`` (the shipped assets and the round trip).

No JAX physics program is jitted: JAX's ``parse_mjcf`` runs its
calibration eagerly (~9 s for the humanoid)."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from deepmimic_mujoco_tpu.physics import deepmimic_character as jchar
from deepmimic_mujoco_tpu.physics import humanoid as jhum
from deepmimic_mujoco_tpu.physics import mjcf as jmjcf
from deepmimic_mujoco_torch.physics import deepmimic_character as tchar
from deepmimic_mujoco_torch.physics import humanoid as thum
from deepmimic_mujoco_torch.physics import mjcf as tmjcf

torch.set_num_threads(1)

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
CHAR = os.path.join(ROOT, "assets", "characters", "humanoid3d.json")
CTRL = os.path.join(ROOT, "assets", "controllers", "humanoid3d_ctrl.json")

PENDULUM = """
<mujoco>
  <option timestep="0.01" integrator="Euler"/>
  <worldbody>
    <body name="base" pos="0 0 1">
      <joint type="free"/>
      <geom name="ball" type="sphere" size="0.1" mass="2"/>
      <body name="arm" pos="0 0 -0.2">
        <joint name="swing" axis="0 1 0" range="-1 1" type="hinge"/>
        <geom name="rod" type="capsule" size="0.02"
              fromto="0 0 0 0 0 -0.3" mass="0.5"/>
      </body>
    </body>
  </worldbody>
  <actuator><motor joint="swing" gear="10"/></actuator>
</mujoco>"""

# defaults, a tilted root, a box, friction, no <option> (Euler, dt 0.002)
DEFAULTS = """
<mujoco>
  <default>
    <joint armature="0.02" damping="5" limited="false"/>
    <motor ctrlrange="-1 1"/>
  </default>
  <worldbody>
    <geom type="plane" friction="0.8 0.1 0.1" size="5 5 0.1"/>
    <body name="root" pos="0 0 1" quat="0.7071068 0 0.7071068 0">
      <joint type="free"/>
      <geom type="box" size="0.1 0.2 0.05" mass="3" pos="0 0 0.1"
            quat="0.9238795 0 0 0.3826834" friction="1.5 0.1 0.1"/>
      <body name="leg" pos="0 0 -0.3">
        <joint name="hip" axis="1 0 0" range="-2 2" limited="true"/>
        <joint name="hip2" axis="0 1 0" range="-1 1" damping="2"/>
        <geom type="capsule" size="0.04" fromto="0 0 0 0.1 0 -0.4" mass="1"/>
        <site name="ignored"/>
      </body>
    </body>
  </worldbody>
  <actuator>
    <motor joint="hip" gear="40"/>
    <motor joint="hip2" gear="20" ctrlrange="-0.3 0.3"/>
  </actuator>
</mujoco>"""


def _assert_models_equal(tm, jm, atol=1e-6):
    """Every field of the JAX model in the port's: tensors within ``atol``,
    metadata (names, sizes, options, ``minv_mode``, ``integrator``) equal."""
    for f in dataclasses.fields(jm):
        ref, out = getattr(jm, f.name), getattr(tm, f.name)
        if isinstance(out, torch.Tensor) and out.is_floating_point():
            np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                       atol=atol, err_msg=f.name)
        elif isinstance(out, torch.Tensor):
            np.testing.assert_array_equal(out.numpy(), np.asarray(ref),
                                          err_msg=f.name)
        else:
            assert out == ref, f.name
    assert tm.device == torch.device("cpu")


# ---------------------------------------------------------------------------
# exporters


@pytest.mark.parametrize("kw", [{}, dict(visual=True),
                                dict(timestep=0.002, integrator="Euler")])
def test_to_mjcf_equals_jax_byte_for_byte(kw):
    assert thum.to_mjcf(**kw) == jhum.to_mjcf(**kw)


@pytest.mark.parametrize("kw", [{}, dict(timestep=0.0166)])
def test_to_mjcf_v1_ball_equals_jax_byte_for_byte(kw):
    assert thum.to_mjcf_v1_ball(**kw) == jhum.to_mjcf_v1_ball(**kw)


# ---------------------------------------------------------------------------
# the MJCF importer


@pytest.fixture(scope="module")
def exported():
    """The exported humanoid parsed by both stacks at 16/16 caps."""
    xml = thum.to_mjcf()
    return (jmjcf.parse_mjcf(xml, contact_cap=16, limit_cap=16),
            tmjcf.parse_mjcf(xml, contact_cap=16, limit_cap=16, device="cpu"))


def test_parse_exported_humanoid_matches_jax(exported):
    """Every field to 1e-6; ``minv_mode`` 'ns' and ``integrator`` 'rk4' in
    both; the importer's exact-cold defaults (ne 64)."""
    jm, tm = exported
    _assert_models_equal(tm, jm)
    assert (tm.minv_mode, tm.integrator) == ("ns", "rk4")
    assert (tm.max_contacts, tm.max_limits, tm.warm_iterations,
            tm.solver_dtype, tm.stage_reuse) == (16, 16, 0, "f32", "none")


def test_parse_exported_humanoid_matches_build_humanoid(exported):
    """The dynamical fields equal ``build_humanoid()``'s to 1e-6."""
    _, tm = exported
    ref = thum.build_humanoid(device="cpu")
    assert (tm.nq, tm.nv, tm.nu) == (ref.nq, ref.nv, ref.nu)
    assert (tm.body_names, tm.parent) == (ref.body_names, ref.parent)
    for f in ("body_mass", "body_pos", "body_inertia", "hinge_range",
              "actuator_gear", "qpos0", "cand_pos", "cand_mu", "damping"):
        np.testing.assert_allclose(getattr(tm, f).numpy(),
                                   getattr(ref, f).numpy(), atol=1e-6,
                                   err_msg=f)


def test_visual_export_parses_to_the_same_model(exported):
    _, tm = exported
    deco = tmjcf.parse_mjcf(thum.to_mjcf(visual=True), contact_cap=16,
                            limit_cap=16, device="cpu")
    for f in dataclasses.fields(tm):
        a, b = getattr(tm, f.name), getattr(deco, f.name)
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


@pytest.mark.parametrize("xml", [PENDULUM, DEFAULTS],
                         ids=["pendulum", "defaults"])
def test_parse_small_models_match_jax(xml):
    """JAX's minimal pendulum (``tests/test_mjcf.py``) and a model with
    joint and motor defaults, a tilted root, a rotated box, a slanted
    ``fromto`` capsule, geom and floor friction, no ``<option>`` and an
    ignored site: every field to 1e-6."""
    jm = jmjcf.parse_mjcf(xml)
    tm = tmjcf.parse_mjcf(xml, device="cpu")
    _assert_models_equal(tm, jm)
    assert tm.integrator == "euler"
    if xml is PENDULUM:
        assert (tm.nq, tm.nv, tm.nu, tm.dt) == (8, 7, 1, 0.01)
        assert float(tm.body_mass.sum()) == pytest.approx(2.5)
    else:
        assert tm.dt == 0.002 and tm.hinge_limited.tolist() == [True, False]
        np.testing.assert_allclose(tm.ctrl_range.numpy(),
                                   [[-1, 1], [-0.3, 0.3]], atol=1e-7)


def test_load_mjcf_reads_a_file(tmp_path):
    path = tmp_path / "pendulum.xml"
    path.write_text(PENDULUM)
    tm = tmjcf.load_mjcf(str(path), device="cpu")
    _assert_models_equal(tm, jmjcf.load_mjcf(str(path)))


_REFUSED = {
    "ball joint": ("""<mujoco><worldbody><body name="b">
        <joint type="ball"/><geom type="sphere" size="0.1" mass="1"/>
        </body></worldbody></mujoco>""", "unsupported joint type"),
    "slide joint": ("""<mujoco><worldbody><body name="b">
        <joint type="free"/><geom type="sphere" size="0.1" mass="1"/>
        <body name="c"><joint type="slide"/>
        <geom type="sphere" size="0.1" mass="1"/></body>
        </body></worldbody></mujoco>""", "unsupported joint type"),
    "non-origin hinge": ("""<mujoco><worldbody>
        <body name="root" pos="0 0 1"><joint type="free"/>
        <geom type="sphere" size="0.1" mass="1"/>
        <body name="arm" pos="0 0 -0.2">
        <joint name="j" type="hinge" pos="0 0.1 0" axis="0 1 0"/>
        <geom type="sphere" size="0.05" mass="0.2"/>
        </body></body></worldbody></mujoco>""", "non-origin pos"),
    "free joint below the root": ("""<mujoco><worldbody>
        <body name="root"><joint type="free"/>
        <geom type="sphere" size="0.1" mass="1"/>
        <body name="c"><joint type="free"/>
        <geom type="sphere" size="0.1" mass="1"/></body>
        </body></worldbody></mujoco>""", "free joint only supported"),
    "two roots": ("""<mujoco><worldbody>
        <body name="a"><geom type="sphere" size="0.1" mass="1"/></body>
        <body name="b"><geom type="sphere" size="0.1" mass="1"/></body>
        </worldbody></mujoco>""", "exactly one root"),
    "no worldbody": ("<mujoco/>", "no <worldbody>"),
}


@pytest.mark.parametrize("case", sorted(_REFUSED))
def test_refusals_match_jax(case):
    """The models JAX refuses, the port refuses with the same message."""
    xml, msg = _REFUSED[case]
    with pytest.raises(ValueError, match=msg) as ref:
        jmjcf.parse_mjcf(xml)
    with pytest.raises(ValueError, match=msg) as out:
        tmjcf.parse_mjcf(xml, device="cpu")
    assert str(out.value) == str(ref.value)


# ---------------------------------------------------------------------------
# the DeepMimic character importer


def test_load_shipped_character_matches_jax_and_build_humanoid():
    """``assets/characters/humanoid3d.json`` with its controller file:
    every field equals JAX's ``load_character`` to 1e-6 (16/16 caps, rk4,
    'ns'), and the dynamical fields ``build_humanoid()``'s."""
    jm = jchar.load_character(CHAR, CTRL)
    tm = tchar.load_character(CHAR, CTRL, device="cpu")
    _assert_models_equal(tm, jm)
    ref = thum.build_humanoid(device="cpu")
    for f in ("body_mass", "body_pos", "hinge_range", "actuator_gear",
              "qpos0"):
        np.testing.assert_allclose(getattr(tm, f).numpy(),
                                   getattr(ref, f).numpy(), atol=1e-6,
                                   err_msg=f)
    assert (tm.max_contacts, tm.max_limits, tm.minv_mode) == (16, 16, "ns")


def test_export_character_equals_jax_and_the_shipped_assets():
    character, controller = tchar.export_character()
    assert (character, controller) == jchar.export_character()
    with open(CHAR) as f:
        assert json.load(f) == character
    with open(CTRL) as f:
        assert json.load(f) == controller
    gears = dict(thum._GEARS, neck=10)
    assert tchar.export_character(gears) == jchar.export_character(gears)


def test_character_round_trip_through_files(tmp_path):
    """export → JSON files → load reproduces ``build_humanoid()``; without
    a controller file the default gears apply, as in JAX."""
    character, controller = tchar.export_character()
    cpath, kpath = tmp_path / "c.json", tmp_path / "k.json"
    cpath.write_text(json.dumps(character))
    kpath.write_text(json.dumps(controller))
    tm = tchar.load_character(str(cpath), str(kpath), device="cpu")
    ref = thum.build_humanoid(device="cpu")
    for f in ("body_pos", "body_mass", "hinge_range", "actuator_gear"):
        np.testing.assert_allclose(getattr(tm, f).numpy(),
                                   getattr(ref, f).numpy(), atol=1e-6)
    bare = tchar.load_character(str(cpath), integrator="euler", dt=0.002,
                                contact_cap=8, limit_cap=8, device="cpu")
    _assert_models_equal(bare, jchar.load_character(
        str(cpath), integrator="euler", dt=0.002, contact_cap=8,
        limit_cap=8))
