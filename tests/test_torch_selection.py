"""The solver's deepest-first selection of contacts and limits
(``deepmimic_mujoco_torch/physics/solver.py:select_deepest``, used by
``assemble_system``) against ``jax.lax.top_k(-pos, k)`` on the CPU, on
depths with exact ties at and across the k-th place.

``top_k`` puts the lower index first among equal values.  Where equal
depths straddle the cut, an order-free rule (``torch.topk``) may keep
another *set* of constraints than JAX, and another set on the card than on
the CPU: other physics, not another summation order.  The port must keep
JAX's indices, in JAX's order, at the default 8/8 caps, at 16/16 and
uncapped.  No JAX physics program is compiled: ``top_k`` runs eagerly."""

import numpy as np
import pytest
import torch

import jax

from deepmimic_mujoco_torch.physics import solver
from deepmimic_mujoco_torch.physics.collision import Contacts, Limits
from deepmimic_mujoco_torch.physics.humanoid import build_humanoid
from tests.torch_selection_cases import CASES, depths

torch.set_num_threads(1)

CAPS = {"8/8": (8, 8), "16/16": (16, 16), "uncapped": (1000, 1000)}


def _jax_top_k(pos: np.ndarray, k: int) -> np.ndarray:
    return np.asarray(jax.lax.top_k(-jax.numpy.asarray(pos), k)[1])


def _system(model, c_pos: np.ndarray, l_pos: np.ndarray, seed: int):
    """``assemble_system`` on these depths, with random Jacobians and
    M⁻¹ = I: only the selection matters here."""
    gen = torch.Generator().manual_seed(seed)
    B, nc_full = c_pos.shape
    cp = torch.from_numpy(c_pos)
    lp = torch.from_numpy(l_pos)
    contacts = Contacts(
        pos=cp, active=cp < 0,
        jac=torch.randn((B, nc_full, 3, model.nv), generator=gen),
        mu=model.cand_mu)
    limits = Limits(pos=lp, active=lp < 0,
                    sign=torch.where(lp < 0, 1.0, -1.0))
    return solver.assemble_system(model, lambda x: x, contacts, limits)


@pytest.fixture(scope="module", params=list(CAPS))
def model(request):
    cc, lc = CAPS[request.param]
    return build_humanoid(contact_cap=cc, limit_cap=lc, device="cpu")


@pytest.mark.parametrize("case", CASES)
def test_selection_keeps_jax_top_k_sets_on_ties(model, case):
    nc, nl, nc_full, nl_full = solver._caps(model)
    c_pos = depths(case, nc_full, nc, seed=1)
    l_pos = depths(case, nl_full, nl, seed=2)
    c_ref, l_ref = _jax_top_k(c_pos, nc), _jax_top_k(l_pos, nl)

    system = _system(model, c_pos, l_pos, seed=3)
    c_sel = system.c_rows[:, ::3].numpy() // 3
    l_sel = system.lim_dof.numpy()
    for sel, ref in ((c_sel, c_ref), (l_sel, l_ref)):
        assert [set(r) for r in sel] == [set(r) for r in ref], (sel, ref)
        np.testing.assert_array_equal(sel, ref)
    np.testing.assert_array_equal(
        solver.select_deepest(torch.from_numpy(c_pos), nc).numpy(), c_ref)


def test_selected_depths_are_the_deepest(model):
    """On seeded random depths with frequent ties, every kept depth is at
    most every dropped one, and the kept depths come deepest first."""
    nc, _, nc_full, _ = solver._caps(model)
    pos = torch.from_numpy(depths("random_integers", nc_full, nc, seed=4))
    sel = solver.select_deepest(pos, nc)
    kept = pos.gather(1, sel)
    assert bool((kept[:, 1:] >= kept[:, :-1]).all())
    if nc < nc_full:
        dropped = torch.ones_like(pos, dtype=torch.bool).scatter(
            1, sel, False)
        worst_kept = kept[:, -1]
        best_dropped = torch.where(dropped, pos,
                                   torch.full_like(pos, np.inf)).min(1).values
        assert bool((worst_kept <= best_dropped).all())
