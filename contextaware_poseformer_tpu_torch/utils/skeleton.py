"""Skeleton roots, flip permutations, action names and the 3DHP test
sequences: the port's copy of
what it uses from ``contextaware_poseformer_tpu/utils/skeleton.py``.

Index tables match the reference exactly:
- H36M left/right joints: ContextPose/mvn/datasets/utils.py:11-12, train.py:26-27
- 3DHP left/right joints: ContextPose_mpi/run_3dhp.py:45-46
- action names: ContextPose/mvn/datasets/human36m.py:18-33
"""

from __future__ import annotations

import numpy as np

NUM_JOINTS = 17

# Human3.6M (root = pelvis, index 0)
H36M_ROOT = 0
H36M_JOINTS_LEFT = (4, 5, 6, 11, 12, 13)
H36M_JOINTS_RIGHT = (1, 2, 3, 14, 15, 16)
# the 17-joint subset of the 32 raw joints
# (H36M-Toolbox/generate_labels_h36m.py:57)
H36M_RAW_JOINT_SUBSET = (0, 1, 2, 3, 6, 7, 8, 12, 16, 14, 15, 17, 18, 19, 25, 26, 27)

# MPI-INF-3DHP (root = joint 14; ContextPose_mpi/run_3dhp.py:66)
MPI3DHP_ROOT = 14
MPI3DHP_JOINTS_LEFT = (5, 6, 7, 11, 12, 13)
MPI3DHP_JOINTS_RIGHT = (2, 3, 4, 8, 9, 10)

H36M_ACTION_NAMES = tuple(
    f"{name}-{trial}"
    for name in (
        "Directions", "Discussion", "Eating", "Greeting", "Phoning",
        "Posing", "Purchases", "Sitting", "SittingDown", "Smoking",
        "TakingPhoto", "Waiting", "Walking", "WalkingDog", "WalkingTogether",
    )
    for trial in (1, 2)
)

H36M_SUBJECT_NAMES = ("S1", "S5", "S6", "S7", "S8", "S9", "S11")
H36M_TRAIN_SUBJECTS = (1, 5, 6, 7, 8)
H36M_TEST_SUBJECTS = (9, 11)

MPI3DHP_TEST_SEQUENCES = ("TS1", "TS2", "TS3", "TS4", "TS5", "TS6")
# Frame counts per test sequence used for scene-setting aggregation
# (ContextPose_mpi/3dhp_test/README.txt:20-24).
MPI3DHP_SCENE_SETTINGS = {
    "studio_green_screen": (("TS1", 603), ("TS2", 540)),
    "studio_no_green_screen": (("TS3", 505), ("TS4", 553)),
    "outdoor": (("TS5", 276), ("TS6", 452)),
}


def flip_permutation(joints_left, joints_right, num_joints: int = NUM_JOINTS):
    """Joint permutation for horizontal flip: swap left<->right, rest fixed
    (the reference's ``x[..., left+right, :] = x[..., right+left, :]``,
    ContextPose/mvn/datasets/utils.py:58)."""
    perm = np.arange(num_joints)
    perm[list(joints_left)] = list(joints_right)
    perm[list(joints_right)] = list(joints_left)
    return perm


H36M_FLIP_PERM = flip_permutation(H36M_JOINTS_LEFT, H36M_JOINTS_RIGHT)
MPI3DHP_FLIP_PERM = flip_permutation(MPI3DHP_JOINTS_LEFT, MPI3DHP_JOINTS_RIGHT)
