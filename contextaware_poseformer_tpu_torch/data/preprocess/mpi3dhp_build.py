"""Offline MPI-INF-3DHP builders: raw annot .mat files -> training/test npz.

Re-implementation of ContextPose_mpi/dataset/data_util/data_to_npz_3dhp.py
(:265-333) and data_to_npz_3dhp_test.py (:260-325), producing the exact npz
layouts data/mpi3dhp.py consumes:

  train: {"S{s} Seq{q}": [{cam: {data_2d, data_2d_crop, data_3d}}, fps]}
  test:  {"TS{i}": {data_2d, data_2d_crop, data_3d, valid}}

Constants reproduced from the reference (they are public dataset facts):
- camera set [0,1,2,4,5,6,7,8] and 17-of-28 joint subset (:268-270);
- per-(subject, sequence) frame counts / fps (mpii_get_sequence_info, :7-27);
- the 14 training-camera intrinsics + the TS5/6 test intrinsics (:114-265);
- bbox from root joint 14 +-(1000,900/1100)mm weak projection, affine crop to
  192x256 (:30-55, :310-318).

The port's copy of ``contextaware_poseformer_tpu/data/preprocess/mpi3dhp_build.py``
(held to it by ``tests/test_torch_copies.py``).
"""

from __future__ import annotations

import os
from typing import Mapping

import numpy as np

from contextaware_poseformer_tpu_torch.utils import geometry

CAM_SET = (0, 1, 2, 4, 5, 6, 7, 8)
JOINT_SET = (7, 5, 14, 15, 16, 9, 10, 11, 23, 24, 25, 18, 19, 20, 4, 3, 6)
CROP_SIZE = (192, 256)
ROOT_IDX = 14

# (frames, fps) per "subject sequence" (data_to_npz_3dhp.py:7-27)
SEQUENCE_INFO = {
    "1 1": (6416, 25), "1 2": (12430, 50),
    "2 1": (6502, 25), "2 2": (6081, 25),
    "3 1": (12488, 50), "3 2": (12283, 50),
    "4 1": (6171, 25), "4 2": (6675, 25),
    "5 1": (12820, 50), "5 2": (12312, 50),
    "6 1": (6188, 25), "6 2": (6145, 25),
    "7 1": (6239, 25), "7 2": (6320, 25),
    "8 1": (6468, 25), "8 2": (6054, 25),
}

# training camera intrinsics (data_to_npz_3dhp.py:114-265), indexed by raw
# camera id; index 14 is the shared TS5/TS6 test camera.
CAMERA_INTRINSICS = (
    {"center": (1024.704, 1051.394), "focal_length": (1497.693, 1497.103)},
    {"center": (1030.519, 1052.626), "focal_length": (1495.217, 1495.520)},
    {"center": (983.8873, 987.5902), "focal_length": (1495.587, 1497.828)},
    {"center": (1029.060, 1041.409), "focal_length": (1495.886, 1496.033)},
    {"center": (987.6075, 1019.069), "focal_length": (1490.952, 1491.108)},
    {"center": (1012.331, 998.5009), "focal_length": (1500.414, 1499.971)},
    {"center": (999.7319, 1010.251), "focal_length": (1498.471, 1498.800)},
    {"center": (987.2716, 976.8773), "focal_length": (1498.831, 1499.674)},
    {"center": (1017.387, 1043.032), "focal_length": (1500.172, 1500.837)},
    {"center": (1010.423, 1037.096), "focal_length": (1501.554, 1501.900)},
    {"center": (1041.614, 997.0433), "focal_length": (1498.423, 1498.585)},
    {"center": (1009.802, 999.9984), "focal_length": (1495.779, 1493.703)},
    {"center": (1000.560, 1014.975), "focal_length": (1501.326, 1501.491)},
    {"center": (1005.702, 1004.214), "focal_length": (1496.961, 1497.378)},
    {"center": (939.85754016, 560.140743168),
     "focal_length": (1683.98345952, 1672.59370772)},  # TS5/TS6
)


def _cam_fx_fy_cx_cy(cam: Mapping) -> dict:
    return {
        "fx": cam["focal_length"][0], "fy": cam["focal_length"][1],
        "cx": cam["center"][0], "cy": cam["center"][1],
    }


def crop_coordinates(pose2d: np.ndarray, pose3d: np.ndarray, cam: Mapping
                     ) -> np.ndarray:
    """Per-frame affine-crop 2D coords from the root-14 weak-projection bbox."""
    out = np.copy(pose2d)
    c4 = _cam_fx_fy_cx_cy(cam)
    for i in range(len(pose2d)):
        box = geometry.infer_bbox(pose3d[i], c4, ROOT_IDX)
        center = (0.5 * (box[0] + box[2]), 0.5 * (box[1] + box[3]))
        scale = ((box[2] - box[0]) / 200.0, (box[3] - box[1]) / 200.0)
        trans = geometry.get_affine_transform(center, scale, CROP_SIZE)
        out[i] = geometry.affine_transform(pose2d[i], trans)
    return out


def build_train_npz(data_root: str, out_path: str) -> dict:
    """Walk S*/Seq*/annot.mat under `data_root` and emit data_train_3dhp.npz."""
    import scipy.io as scio

    dic_seq: dict = {}
    for root, _dirs, files in os.walk(data_root):
        for file in files:
            if not file.endswith("annot.mat"):
                continue
            parts = os.path.normpath(root).split(os.sep)
            subject, seq = parts[-2][1:], parts[-1][3:]
            frames, fps = SEQUENCE_INFO[f"{subject} {seq}"]
            data = scio.loadmat(os.path.join(root, file))
            data_2d_all = data["annot2"][list(CAM_SET)]
            data_3d_all = data["univ_annot3"][list(CAM_SET)]

            dic_cam = {}
            for ci, raw_cam in enumerate(CAM_SET):
                d2 = data_2d_all[ci][0].reshape(-1, 28, 2)[:frames, list(JOINT_SET)]
                d3 = data_3d_all[ci][0].reshape(-1, 28, 3)[:frames, list(JOINT_SET)]
                dic_cam[str(raw_cam)] = {
                    "data_2d": d2,
                    "data_2d_crop": crop_coordinates(
                        d2, d3, CAMERA_INTRINSICS[raw_cam]
                    ),
                    "data_3d": d3,
                }
            dic_seq[f"S{subject} Seq{seq}"] = [dic_cam, fps]
    np.savez_compressed(out_path, data=np.asarray(dic_seq, dtype=object))
    return dic_seq


def build_test_npz(data_root: str, out_path: str) -> dict:
    """Walk TS*/annot_data.mat under `data_root` and emit data_test_3dhp.npz."""
    import h5py

    dic_seq: dict = {}
    for root, _dirs, files in os.walk(data_root):
        for file in files:
            if not file.endswith("annot_data.mat"):
                continue
            seq = os.path.normpath(root).split(os.sep)[-1]  # TS1..TS6
            with h5py.File(os.path.join(root, file), "r") as data:
                valid = np.squeeze(np.asarray(data["valid_frame"]))
                d2 = np.squeeze(np.asarray(data["annot2"]))
                d3 = np.squeeze(np.asarray(data["univ_annot3"]))
            cam = CAMERA_INTRINSICS[14 if seq in ("TS5", "TS6") else 8]
            dic_seq[seq] = {
                "data_2d": d2,
                "data_2d_crop": crop_coordinates(d2, d3, cam),
                "data_3d": d3,
                "valid": valid,
            }
    np.savez_compressed(out_path, data=np.asarray(dic_seq, dtype=object))
    return dic_seq
