"""Humanoid3d joint layout, PD gains and pose-reward weights (numpy copy of
``deepmimic_mujoco_tpu/mocap/constants.py``)."""

from __future__ import annotations

import numpy as np

# MuJoCo qpos ordering of actuated joints (after the free root):
BODY_JOINTS = [
    "chest", "neck", "right_shoulder", "right_elbow",
    "left_shoulder", "left_elbow", "right_hip", "right_knee",
    "right_ankle", "left_hip", "left_knee", "left_ankle",
]

# Ordering of joints inside a DeepMimic motion-clip frame:
BODY_JOINTS_IN_DP_ORDER = [
    "chest", "neck", "right_hip", "right_knee",
    "right_ankle", "right_shoulder", "right_elbow", "left_hip",
    "left_knee", "left_ankle", "left_shoulder", "left_elbow",
]

# Degrees of freedom per joint (3 = spherical → x,y,z hinge stack; 1 = hinge;
# 0 = fixed end effector).
DOF_DEF = {
    "root": 3, "chest": 3, "neck": 3, "right_shoulder": 3,
    "right_elbow": 1, "right_wrist": 0, "left_shoulder": 3, "left_elbow": 1,
    "left_wrist": 0, "right_hip": 3, "right_knee": 1, "right_ankle": 3,
    "left_hip": 3, "left_knee": 1, "left_ankle": 3,
}

# DeepMimic body list (includes the fixed wrists).
BODY_DEFS = [
    "root", "chest", "neck", "right_hip", "right_knee",
    "right_ankle", "right_shoulder", "right_elbow", "right_wrist", "left_hip",
    "left_knee", "left_ankle", "left_shoulder", "left_elbow", "left_wrist",
]

# Stable PD gains [kp, kd] per joint (data/controllers/humanoid3d_ctrl.txt).
PARAMS_KP_KD = {
    "chest": [1000, 100], "neck": [100, 10],
    "right_shoulder": [400, 40], "right_elbow": [300, 30],
    "left_shoulder": [400, 40], "left_elbow": [300, 30],
    "right_hip": [500, 50], "right_knee": [500, 50],
    "right_ankle": [400, 40], "left_hip": [500, 50],
    "left_knee": [500, 50], "left_ankle": [400, 40],
}

# DeepMimic pose-error weights per body.
JOINT_WEIGHT = {
    "root": 1, "chest": 0.5, "neck": 0.3, "right_hip": 0.5,
    "right_knee": 0.3, "right_ankle": 0.2, "right_shoulder": 0.3,
    "right_elbow": 0.2, "right_wrist": 0.0, "left_hip": 0.5,
    "left_knee": 0.3, "left_ankle": 0.2, "left_shoulder": 0.3,
    "left_elbow": 0.2, "left_wrist": 0.0,
}

# End effectors used by the DeepMimic end-effector reward term.
END_EFFECTORS = ["right_wrist", "left_wrist", "right_ankle", "left_ankle"]

# qpos layout: [root_pos(3), root_quat(4)] + per BODY_JOINTS (3 euler or 1 angle)
NQ = 7 + sum(3 if DOF_DEF[j] == 3 else 1 for j in BODY_JOINTS)  # = 35
# qvel layout: [root_lin(3), root_ang(3)] + per BODY_JOINTS dofs
NV = 6 + sum(DOF_DEF[j] for j in BODY_JOINTS)  # = 34


def kp_kd_vectors() -> tuple[np.ndarray, np.ndarray]:
    """Per-actuated-dof kp and kd (28,) in MuJoCo joint order, float32 (the
    JAX env casts the float64 vectors to float32 before use)."""
    kp, kd = [], []
    for j in BODY_JOINTS:
        kp += [PARAMS_KP_KD[j][0]] * DOF_DEF[j]
        kd += [PARAMS_KP_KD[j][1]] * DOF_DEF[j]
    return np.asarray(kp, np.float32), np.asarray(kd, np.float32)
