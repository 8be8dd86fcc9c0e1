"""Humanoid3d joint layout (numpy copy of ``deepmimic_mujoco_tpu/mocap/
constants.py``, limited to what the walk evaluation needs)."""

from __future__ import annotations

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

# End effectors used by the DeepMimic end-effector reward term.
END_EFFECTORS = ["right_wrist", "left_wrist", "right_ankle", "left_ankle"]

# qpos layout: [root_pos(3), root_quat(4)] + per BODY_JOINTS (3 euler or 1 angle)
NQ = 7 + sum(3 if DOF_DEF[j] == 3 else 1 for j in BODY_JOINTS)  # = 35
# qvel layout: [root_lin(3), root_ang(3)] + per BODY_JOINTS dofs
NV = 6 + sum(DOF_DEF[j] for j in BODY_JOINTS)  # = 34
