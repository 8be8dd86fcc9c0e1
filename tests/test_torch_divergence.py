"""The divergence checks of ``deepmimic_mujoco_torch/utils/divergence.py``
on the CPU: the one-step check between two devices, run here with the CPU
on both sides, agrees exactly and catches planted faults (a moved state, a
selection that keeps another set); the one-ulp starts, the curves and the
verdict rule on small inputs.  No JAX: these test the instrument that
holds the card against the CPU (``chip_smoke.py``'s one-step check and
``--divergence``)."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from deepmimic_mujoco_torch.envs.dp_env_v3 import DPEnvV3
from deepmimic_mujoco_torch.physics import solver
from deepmimic_mujoco_torch.physics.humanoid import build_humanoid
from deepmimic_mujoco_torch.utils import divergence

torch.set_num_threads(1)

RECIPE = dict(clip="walk", reward_mode="imitation_dm",
              control_mode="pd_residual", n_substeps=2,
              max_episode_steps=300)
FRAMES = [0, 9, 21, 33]


def _env():
    return DPEnvV3(model=build_humanoid(device="cpu"), **RECIPE)


@pytest.fixture(scope="module")
def inputs():
    env = _env()
    gen = torch.Generator().manual_seed(0)
    action = 0.1 * torch.randn((len(FRAMES), 28), generator=gen)
    return env.reset_at(FRAMES), action


def test_one_step_check_of_a_device_against_itself_is_exact(inputs):
    state, action = inputs
    rec = divergence.one_step_check(_env(), _env(), state, action)
    assert rec["ok"] and rec["done_equal"]
    assert all(rec[k] == 0.0 for k in ("qpos", "qvel", "obs", "reward"))
    # 2 substeps, contacts and limits: 4 selections of every env
    assert rec["selections"] == 4 * len(FRAMES)
    assert rec["sets_differ"] == rec["bad"] == 0


def test_one_step_check_catches_a_moved_state(inputs):
    state, action = inputs
    env_b = _env()
    step = env_b.step

    def moved(s, a):
        nxt = step(s, a)
        return dataclasses.replace(nxt, qpos=nxt.qpos + 2e-4)
    env_b.step = moved
    rec = divergence.one_step_check(_env(), env_b, state, action)
    assert not rec["ok"] and rec["qpos"] > divergence.STEP_TOL
    assert rec["bad"] == 0


def _swap_at_cut(pos, k):
    """Keeps the (k+1)-th deepest in place of the k-th: another set."""
    full = torch.sort(pos, dim=1, stable=True).indices
    if k >= pos.shape[1]:
        return full[:, :k]
    return torch.cat([full[:, :k - 1], full[:, k:k + 1]], dim=1)


def test_one_step_check_catches_another_selected_set(inputs, monkeypatch):
    """A selection fault on one side only: the swapped candidate is
    inactive, so the physics agrees, and only the set check fails."""
    state, action = inputs
    env_a, env_b = _env(), _env()
    real = divergence.step_recorded

    def faulty(env, st, ac):
        if env is env_b:
            with monkeypatch.context() as m:
                m.setattr(solver, "select_deepest", _swap_at_cut)
                return real(env, st, ac)
        return real(env, st, ac)
    monkeypatch.setattr(divergence, "step_recorded", faulty)
    rec = divergence.one_step_check(env_a, env_b, state, action)
    assert rec["qpos"] <= divergence.STEP_TOL
    assert rec["sets_differ"] == rec["bad"] == rec["selections"]
    assert not rec["ok"]


def test_selection_diff_spares_near_ties_only():
    """k = 3: a different set is spared at a near-tie (the 3rd and 4th
    depths 1e-7 apart, the rows not equal), not at an exact tie of equal
    rows, nor across a clear gap."""
    pos_a = torch.tensor([[-0.3, -0.2, -0.1000001, -0.1, 0.5],
                          [-0.3, -0.2, -0.1, -0.1, 0.5],
                          [-0.3, -0.2, -0.15, -0.1, 0.5]])
    pos_b = pos_a.clone()
    pos_b[0, 2:4] = torch.tensor([-0.1, -0.1000001])
    ia = torch.tensor([[0, 1, 2]] * 3)
    ib = torch.tensor([[0, 1, 3]] * 3)
    d = divergence.selection_diff([(pos_a, ia)], [(pos_b, ib)])
    assert d == {"selections": 3, "exact_ties": 1, "near_ties": 1,
                 "sets_differ": 3, "bad": 2}
    assert divergence.selection_diff([(pos_a, ia)], [(pos_b, ia)])["bad"] == 0


def test_ulp_starts_move_every_entry_by_one_ulp():
    env = _env()
    s = divergence.ulp_starts(env, FRAMES, 3, seed=5)
    base = env.reset_at(FRAMES)
    n = len(FRAMES)
    assert s.qpos.shape == (3 * n, base.qpos.shape[1])
    assert torch.equal(s.qpos[:n], base.qpos)
    assert torch.equal(s.obs[:n], base.obs)
    up = divergence.ulp_directions(base.qpos.shape, 2, seed=5)
    for j in (1, 2):
        q = s.qpos[j * n:(j + 1) * n]
        want = torch.nextafter(base.qpos, torch.where(
            up[j - 1], torch.tensor(math.inf), torch.tensor(-math.inf)))
        assert torch.equal(q, want) and bool((q != base.qpos).all())
        assert torch.equal(s.mocap_idx[j * n:(j + 1) * n], base.mocap_idx)
    assert torch.equal(s.qpos, divergence.ulp_starts(env, FRAMES, 3,
                                                     seed=5).qpos)


def test_curves_split_step_and_spread():
    T, B = 6, 4
    dist = torch.zeros(T, B, dtype=torch.float64)
    dist[3, :2] = 0.5
    dist[4:, :3] = 1.0
    c = divergence.curves(dist, steps=(1, 3, 5))
    assert c["split_step"] == 3
    assert c["median"] == {1: 0.0, 3: 0.25, 5: 1.0}
    assert c["max"] == {1: 0.0, 3: 0.5, 5: 1.0}
    assert divergence.curves(torch.zeros(T, B))["split_step"] is None

    ep_len = torch.tensor([300, 100, 300, 300, 200, 200])
    ep_ret = torch.tensor([30.0, 10.0, 60.0, 30.0, 20.0, 40.0])
    sp = divergence.episode_spread(ep_len, ep_ret, 3)
    np.testing.assert_allclose(sp["ep_len"], [200.0, 300.0, 200.0])
    np.testing.assert_allclose(sp["reward_per_step"], [0.1, 0.15, 0.15])
    np.testing.assert_allclose(sp["ep_len_s"], np.std([200, 300, 200],
                                                      ddof=1))
    assert sp["ep_len_mean"] == pytest.approx(700 / 3)


def _pairs(cc, ulp):
    return {"card_cpu": {"median": {1: cc}}, "card_ulp": {"median": {1: ulp}},
            "cpu_ulp": {"median": {1: ulp / 2}}}


def _spread(mean, s, k=8):
    return {"k": k, "ep_len_mean": mean, "ep_len_s": s,
            "reward_per_step_mean": 0.17, "reward_per_step_s": 0.01}


def test_verdict_rule():
    chaos = divergence.verdict(True, _pairs(1e-6, 2e-7),
                               {"card": _spread(292.0, 4.0),
                                "cpu": _spread(296.0, 4.0)})
    assert chaos["verdict"] == "chaos"
    # 4 apart against 3·sqrt(2·16/8) = 6: inside; 7 apart: outside
    assert chaos["means"]["ep_len"]["bound"] == pytest.approx(6.0)
    for one_step, pairs, gap in ((False, _pairs(1e-6, 2e-7), 4.0),
                                 (True, _pairs(3e-6, 2e-7), 4.0),
                                 (True, _pairs(1e-6, 2e-7), 7.0)):
        v = divergence.verdict(one_step, pairs,
                               {"card": _spread(292.0, 4.0),
                                "cpu": _spread(292.0 + gap, 4.0)})
        assert v["verdict"] == "bias"


def test_localize_names_the_module_that_differs(inputs):
    """Against itself every module agrees; with the other side's body
    masses 0.1% off, FK still agrees and M is the first module that
    differs, and one ulp at the inputs moves the step by rounding alone."""
    state, action = inputs
    same = divergence.localize(_env(), _env(), state, action)
    assert all(float(d.max()) == 0.0 for d in same["modules"].values())
    assert int(same["a_bf16_flips"].sum()) == 0
    # 2 substeps of FK, M, M⁻¹, contacts, limits, 2 selections, A, 4
    # solves and 5 integrations; then the env's FK and contacts
    assert same["calls"] == 2 * 15 + 2 + 2

    off = _env()
    off.model = dataclasses.replace(off.model,
                                    body_mass=off.model.body_mass * 1.001)
    rec = divergence.localize(off, _env(), state, action)
    first = next(k for k, d in rec["modules"].items() if float(d.max()) > 0)
    assert first == "M" and float(rec["modules"]["FK"].max()) == 0.0
    assert bool((rec["modules"]["M"] > 0).all())
    ulp = divergence.ulp_sensitivity(_env(), state, action, seed=0)
    assert ulp.shape == (len(FRAMES),) and bool((ulp > 0).all())
    assert float(ulp.max()) < 1e-4
