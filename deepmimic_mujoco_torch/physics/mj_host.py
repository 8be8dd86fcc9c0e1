"""Host-MuJoCo dynamics: the installed MuJoCo C engine as a drop-in for
``engine.step`` (port of ``deepmimic_mujoco_tpu/physics/mj_host.py``).

``MJHostDynamics(model).step(qpos, qvel, ctrl)`` has ``engine.step``'s
contract on a batch (B, ·).  The tensors go to the host, MuJoCo steps each
env in float64 (``min(8, B)`` threads: ``mj_step`` releases the GIL), and
the float32 results come back on the input's device, at every call — the
JAX package's ``pure_callback``.  For A/B runs that tell the engine's
fidelity apart from the trainer's correctness, and for golden trajectories;
never a hot path.  MuJoCo is imported inside the functions that use it, so
the rest of the port runs where MuJoCo is absent (the card's machine)."""

from __future__ import annotations

import functools

import numpy as np
import torch

from deepmimic_mujoco_torch.physics.model import PhysicsModel


@functools.lru_cache(maxsize=8)
def _mj_model(xml: str):
    import mujoco

    return mujoco.MjModel.from_xml_string(xml)


@functools.lru_cache(maxsize=8)
def _mj_pool(xml: str, n_threads: int):
    """A thread pool and one ``MjData`` per thread for a model.  The datas
    persist across calls, as the JAX package's do (MuJoCo's solver warm
    start carries from one call to the next)."""
    from concurrent.futures import ThreadPoolExecutor

    import mujoco

    m = _mj_model(xml)
    return (ThreadPoolExecutor(max_workers=n_threads),
            [mujoco.MjData(m) for _ in range(n_threads)])


# the tables MuJoCo reads from the humanoid's MJCF, checked against the model
_XML_FIELDS = ("body_pos", "body_quat", "body_mass", "hinge_axis",
               "hinge_range", "hinge_limited", "armature", "damping",
               "actuator_gear", "ctrl_range", "geom_size")


def _check_default_xml(model: PhysicsModel, xml: str) -> None:
    """Refuse a model that the humanoid's MJCF does not describe: that XML
    is written from the tables of ``physics/humanoid.py``, never from the
    model, so an imported or edited model (``--joint-limits mocap``'s
    ranges, say) would otherwise be stepped as another system."""
    from deepmimic_mujoco_torch.physics.mjcf import parse_mjcf

    ref = parse_mjcf(xml, device="cpu")
    for name in _XML_FIELDS:
        a = getattr(model, name).cpu()
        b = getattr(ref, name)
        if a.shape != b.shape or not torch.allclose(
                a.double(), b.double(), rtol=1e-6, atol=1e-6):
            raise ValueError(
                f"the model's {name} differs from the humanoid MJCF that "
                "host MuJoCo would simulate; pass the MJCF that describes "
                "this model as xml=")


class MJHostDynamics:
    """MuJoCo stepping as a batched function.  ``xml`` defaults to
    ``to_mjcf(timestep=model.dt)`` (``physics/humanoid.py``), the humanoid
    of ``build_humanoid``: a model whose bodies, hinges, gears or geoms
    differ from it raises.  Pass another MJCF string to simulate another
    system (its nq and nv must be the model's)."""

    def __init__(self, model: PhysicsModel, xml: str | None = None):
        if xml is None:
            from deepmimic_mujoco_torch.physics.humanoid import to_mjcf

            xml = to_mjcf(model, timestep=float(model.dt))
            _check_default_xml(model, xml)
        self.xml = xml
        self.model = model
        m = _mj_model(xml)
        if (m.nq, m.nv) != (model.nq, model.nv):
            raise ValueError(f"MJCF/model mismatch: nq {m.nq} vs {model.nq}, "
                             f"nv {m.nv} vs {model.nv}")

    def _host_step(self, qpos: np.ndarray, qvel: np.ndarray,
                   ctrl: np.ndarray, n_substeps: int):
        import mujoco

        m = _mj_model(self.xml)
        qp = np.asarray(qpos, np.float64).reshape(-1, m.nq)
        qv = np.asarray(qvel, np.float64).reshape(-1, m.nv)
        ct = np.asarray(ctrl, np.float64).reshape(-1, m.nu)
        out_qp = np.empty_like(qp)
        out_qv = np.empty_like(qv)
        B = qp.shape[0]
        n_threads = min(8, B) if B > 1 else 1
        pool, datas = _mj_pool(self.xml, n_threads)

        def run_slice(t):
            dd = datas[t]
            for i in range(t, B, n_threads):
                dd.qpos[:] = qp[i]
                dd.qvel[:] = qv[i]
                dd.ctrl[:] = ct[i]
                mujoco.mj_step(m, dd, nstep=n_substeps)
                out_qp[i] = dd.qpos
                out_qv[i] = dd.qvel

        if n_threads == 1:
            run_slice(0)
        else:
            list(pool.map(run_slice, range(n_threads)))
        return (out_qp.reshape(np.shape(qpos)).astype(np.float32),
                out_qv.reshape(np.shape(qvel)).astype(np.float32))

    def step(self, qpos: torch.Tensor, qvel: torch.Tensor, ctrl: torch.Tensor,
             n_substeps: int = 1):
        """``engine.step``'s contract: (qpos, qvel) after ``n_substeps``
        MuJoCo steps under ``ctrl``, float32 on the input's device."""
        qp, qv = self._host_step(qpos.detach().cpu().numpy(),
                                 qvel.detach().cpu().numpy(),
                                 ctrl.detach().cpu().numpy(), n_substeps)
        return (torch.from_numpy(qp).to(qpos.device),
                torch.from_numpy(qv).to(qvel.device))
