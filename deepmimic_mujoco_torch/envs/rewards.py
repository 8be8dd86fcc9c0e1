"""DeepMimic imitation rewards, batched over envs (port of
``deepmimic_mujoco_tpu/envs/rewards.py``).  Every function takes a leading
env axis ``(B, ...)`` and returns ``(B,)``.

* ``imitation_reward``: the reference's weighted L1 terms (pose, velocity,
  root, optional end effectors and COM) as Σ wᵢ·exp(−scaleᵢ·errᵢ);
* ``deepmimic_reward``: the original DeepMimic reward — squared errors,
  root-relative heading-normalized end effectors, COM velocity."""

from __future__ import annotations

import functools

import numpy as np
import torch

from deepmimic_mujoco_torch.mocap.constants import (
    BODY_JOINTS,
    DOF_DEF,
    JOINT_WEIGHT,
)
from deepmimic_mujoco_torch.utils import quaternion as quat

WEIGHT_POSE, WEIGHT_VEL, WEIGHT_ROOT = 0.5, 0.05, 0.2
WEIGHT_END_EFF, WEIGHT_COM = 0.15, 0.1
SCALE_POSE, SCALE_VEL, SCALE_ROOT = 2.0, 0.1, 5.0
SCALE_END_EFF, SCALE_COM = 40.0, 10.0
SCALE_ERR = 1.0

# offsets into qpos[7:] (and qvel[6:]) of the spherical joints' hinge
# triples and of the 1-dof joints, in BODY_JOINTS order
_SPH_SLICES = []
_ONE_SLICES = []
_off = 0
for _j in BODY_JOINTS:
    if DOF_DEF[_j] == 3:
        _SPH_SLICES.append((_j, _off))
        _off += 3
    else:
        _ONE_SLICES.append((_j, _off))
        _off += 1

_SPH_W = np.asarray([JOINT_WEIGHT[j] for j, _ in _SPH_SLICES], np.float32)
_ONE_W = np.asarray([JOINT_WEIGHT[j] for j, _ in _ONE_SLICES], np.float32)
_SPH_OFF = np.asarray([o for _, o in _SPH_SLICES], np.int64)
_ONE_OFF = np.asarray([o for _, o in _ONE_SLICES], np.int64)
_SPH_IDX = _SPH_OFF[:, None] + np.arange(3)[None, :]   # (8, 3)
_W_ROOT = 1.0  # JOINT_WEIGHT["root"]


@functools.lru_cache(maxsize=None)
def _on(device: torch.device) -> dict:
    """The index and weight tables as tensors on ``device``, made once per
    device (read only)."""
    return {k: torch.as_tensor(v, device=device) for k, v in (
        ("sph_idx", _SPH_IDX), ("one", _ONE_OFF), ("sph_w", _SPH_W),
        ("one_w", _ONE_W))}


def _t(name: str, like: torch.Tensor) -> torch.Tensor:
    return _on(like.device)[name]


def config_l1_error(joints: torch.Tensor, ref_joints: torch.Tensor
                    ) -> torch.Tensor:
    """Σ|Δq| over qpos[7:]."""
    return torch.sum(torch.abs(joints - ref_joints), dim=-1)


def _sph_angles(joints: torch.Tensor, ref_joints: torch.Tensor
                ) -> torch.Tensor:
    """Rotation angle between the two poses of each spherical joint
    (B, 8), from the euler-rxyz hinge triples."""
    idx = _t("sph_idx", joints)
    return quat.angle_between(quat.quat_from_euler_rxyz(joints[..., idx]),
                              quat.quat_from_euler_rxyz(ref_joints[..., idx]))


def weighted_pose_error(joints: torch.Tensor, ref_joints: torch.Tensor
                        ) -> torch.Tensor:
    """JOINT_WEIGHT-weighted pose error over qpos[7:]: |quaternion angle|
    for the spherical joints, |Δq| for the 1-dof joints; root excluded."""
    ang = torch.abs(_sph_angles(joints, ref_joints))
    err = torch.sum(_t("sph_w", joints) * ang, dim=-1)
    one = _t("one", joints)
    d1 = torch.abs(joints[..., one] - ref_joints[..., one])
    return err + torch.sum(_t("one_w", joints) * d1, dim=-1)


def velocity_l1_error(qvel: torch.Tensor, ref_qvel: torch.Tensor
                      ) -> torch.Tensor:
    """Σ|Δqvel|."""
    return torch.sum(torch.abs(qvel - ref_qvel), dim=-1)


def root_l1_error(root_pos: torch.Tensor, ref_root_pos: torch.Tensor
                  ) -> torch.Tensor:
    """Σ|Δroot_pos|."""
    return torch.sum(torch.abs(root_pos - ref_root_pos), dim=-1)


def end_effector_error(ee_pos: torch.Tensor, ref_ee_pos: torch.Tensor
                       ) -> torch.Tensor:
    """Σ‖Δp‖ over the 4 end effectors (ee_pos (B, 4, 3))."""
    return torch.sum(torch.linalg.vector_norm(ee_pos - ref_ee_pos, dim=-1),
                     dim=-1)


def com_error(com: torch.Tensor, ref_com: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(com - ref_com, dim=-1)


def deepmimic_reward(qpos, qvel, ref_qpos, ref_qvel, ee_pos, ref_ee_pos,
                     com_vel, ref_com_vel, return_terms: bool = False):
    """The original DeepMimic imitation reward (B,):

    * pose: w_root·θ_root² + Σ wⱼ·θⱼ² + Σ wⱼ·Δqⱼ² (1-dof joints);
    * velocity: w_root·‖Δω_root‖² + Σ wⱼ·‖Δq̇ⱼ‖²;
    * end effectors: the mean over the 4 of ‖Δp‖², p root-relative with
      the absolute height, rotated by the root's heading inverse;
    * root: ‖Δpos‖² + 0.1·θ_root² + 0.01·‖Δv‖² + 0.001·‖Δω‖²;
    * com: 0.1·‖Δcom_velocity‖²;

    combined as Σ wᵢ·exp(−scaleᵢ·errᵢ).  ``return_terms`` also returns the
    dict of the five exp terms."""
    joints, ref_joints = qpos[:, 7:], ref_qpos[:, 7:]
    sph_w, one_w = _t("sph_w", qpos), _t("one_w", qpos)
    one = _t("one", qpos)
    ang = _sph_angles(joints, ref_joints)
    th_root = quat.angle_between(qpos[:, 3:7], ref_qpos[:, 3:7])
    d1 = joints[:, one] - ref_joints[:, one]
    pose_err = (_W_ROOT * th_root ** 2 + torch.sum(sph_w * ang ** 2, dim=-1)
                + torch.sum(one_w * d1 ** 2, dim=-1))

    dv = qvel[:, 6:] - ref_qvel[:, 6:]
    dv_sph = dv[:, _t("sph_idx", qvel)]
    d_root_w = qvel[:, 3:6] - ref_qvel[:, 3:6]
    vel_err = (_W_ROOT * torch.sum(d_root_w ** 2, dim=-1)
               + torch.sum(sph_w * torch.sum(dv_sph ** 2, dim=-1), dim=-1)
               + torch.sum(one_w * dv[:, one] ** 2, dim=-1))

    # the relative height is overwritten by the absolute one BEFORE the
    # rotation by the heading inverse (as in JAX)
    hq0 = quat.heading_inverse(qpos[:, 3:7])[:, None]
    hq1 = quat.heading_inverse(ref_qpos[:, 3:7])[:, None]
    rel0 = torch.cat([ee_pos[..., :2] - qpos[:, None, 0:2],
                      ee_pos[..., 2:]], dim=-1)
    rel1 = torch.cat([ref_ee_pos[..., :2] - ref_qpos[:, None, 0:2],
                      ref_ee_pos[..., 2:]], dim=-1)
    rel0 = quat.rotate(hq0, rel0)
    rel1 = quat.rotate(hq1, rel1)
    ee_err = torch.mean(torch.sum((rel1 - rel0) ** 2, dim=-1), dim=-1)

    root_err = (torch.sum((qpos[:, 0:3] - ref_qpos[:, 0:3]) ** 2, dim=-1)
                + 0.1 * th_root ** 2
                + 0.01 * torch.sum((qvel[:, 0:3] - ref_qvel[:, 0:3]) ** 2,
                                   dim=-1)
                + 0.001 * torch.sum(d_root_w ** 2, dim=-1))

    com_err = 0.1 * torch.sum((com_vel - ref_com_vel) ** 2, dim=-1)

    terms = {
        "pose": torch.exp(-SCALE_ERR * SCALE_POSE * pose_err),
        "vel": torch.exp(-SCALE_ERR * SCALE_VEL * vel_err),
        "ee": torch.exp(-SCALE_ERR * SCALE_END_EFF * ee_err),
        "root": torch.exp(-SCALE_ERR * SCALE_ROOT * root_err),
        "com": torch.exp(-SCALE_ERR * SCALE_COM * com_err),
    }
    r = (WEIGHT_POSE * terms["pose"] + WEIGHT_VEL * terms["vel"]
         + WEIGHT_END_EFF * terms["ee"] + WEIGHT_ROOT * terms["root"]
         + WEIGHT_COM * terms["com"])
    if return_terms:
        return r, terms
    return r


def imitation_reward(joints, ref_joints, qvel, ref_qvel, root_pos,
                     ref_root_pos, ee_pos=None, ref_ee_pos=None, com=None,
                     ref_com=None) -> torch.Tensor:
    """Weighted L1 imitation reward (B,): pose, velocity and root terms, and
    the end-effector and COM terms where their inputs are given."""
    r = WEIGHT_POSE * torch.exp(
        -SCALE_ERR * SCALE_POSE * weighted_pose_error(joints, ref_joints))
    r = r + WEIGHT_VEL * torch.exp(
        -SCALE_ERR * SCALE_VEL * velocity_l1_error(qvel, ref_qvel))
    r = r + WEIGHT_ROOT * torch.exp(
        -SCALE_ERR * SCALE_ROOT * root_l1_error(root_pos, ref_root_pos))
    if ee_pos is not None:
        r = r + WEIGHT_END_EFF * torch.exp(
            -SCALE_ERR * SCALE_END_EFF * end_effector_error(ee_pos,
                                                            ref_ee_pos))
    if com is not None:
        r = r + WEIGHT_COM * torch.exp(
            -SCALE_ERR * SCALE_COM * com_error(com, ref_com))
    return r
