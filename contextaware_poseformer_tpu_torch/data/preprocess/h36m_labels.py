"""Offline H36M label builder: raw pose/camera sources -> train/val pickles.

Re-implementation of H36M-Toolbox/generate_labels_h36m.py:48-200 producing
byte-compatible `h36m_train.pkl` / `h36m_validation.pkl` lists consumed by the
dataset layer (data/h36m.py). Per (subject, action 2..16, subaction 1..2,
camera 1..4) and frame:

  - bbox from the root joint's +-(1000,900/1100)mm weak projection
    (generate_labels_h36m.py:21-46, utils/geometry.infer_bbox)
  - center/scale from the bbox (/200, :162-167)
  - crop keypoints via the 192x256 affine (:176-183)
  - full-frame keypoints normalized to [-1, 1] (:185-186)
  - joints_3d in meters (/1000, :187)
  - subjects S1,5,6,7,8 -> train; S9,11 -> validation (:54-55,189-192)

The raw-data reader is pluggable (`PoseSource`) because cdflib is not part of
this image: point `CdfPoseSource` at an extracted H36M tree when cdflib is
available, or feed arrays directly (tests do this).

The port's copy of ``contextaware_poseformer_tpu/data/preprocess/h36m_labels.py``
(held to it by ``tests/test_torch_copies.py``).
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass
from typing import Callable, Iterable, Mapping

import numpy as np

from contextaware_poseformer_tpu_torch.utils import geometry, skeleton

TRAIN_SUBJECTS = skeleton.H36M_TRAIN_SUBJECTS
TEST_SUBJECTS = skeleton.H36M_TEST_SUBJECTS
JOINT_SUBSET = list(skeleton.H36M_RAW_JOINT_SUBSET)
CROP_SIZE = (192, 256)  # (W, H)


@dataclass
class SequenceData:
    """Raw per-(subject, action, subaction, camera) sequence."""

    pose3d_camera_mm: np.ndarray  # (F, 32, 3) or (F, 17, 3) camera-space mm
    pose2d_gt: np.ndarray  # (F, 32, 2) or (F, 17, 2) full-frame pixels
    pose2d_cpn: np.ndarray  # (F, 17, 2) CPN-detected full-frame pixels
    camera: Mapping[str, float]  # fx, fy, cx, cy (+ distortion, unused here)
    image_wh: tuple[int, int]  # (width, height) of the full frame


PoseSource = Callable[[int, int, int, int], SequenceData | None]


def _select_joints(arr: np.ndarray) -> np.ndarray:
    if arr.shape[1] == len(JOINT_SUBSET):
        return arr
    return arr[:, JOINT_SUBSET]


def build_labels(
    source: PoseSource,
    out_train: str | None = None,
    out_val: str | None = None,
    subjects: Iterable[int] = (1, 5, 6, 7, 8, 9, 11),
    actions: Iterable[int] = range(2, 17),
    subactions: Iterable[int] = (1, 2),
    cameras: Iterable[int] = (1, 2, 3, 4),
) -> tuple[list[dict], list[dict]]:
    train_db: list[dict] = []
    test_db: list[dict] = []
    cnt = 0
    for s in subjects:
        for a in actions:
            for sa in subactions:
                for c in cameras:
                    seq = source(s, a, sa, c)
                    if seq is None:
                        continue
                    _append_sequence(seq, s, a, sa, c, cnt,
                                     train_db if s in TRAIN_SUBJECTS else test_db)
                    cnt += 1
    if out_train:
        with open(out_train, "wb") as f:
            pickle.dump(train_db, f)
    if out_val:
        with open(out_val, "wb") as f:
            pickle.dump(test_db, f)
    return train_db, test_db


def _append_sequence(seq: SequenceData, s, a, sa, c, video_id, db) -> None:
    pose3d = _select_joints(np.asarray(seq.pose3d_camera_mm, np.float64))
    pose2d_gt = _select_joints(np.asarray(seq.pose2d_gt, np.float64))
    pose2d_cpn = np.asarray(seq.pose2d_cpn, np.float64)
    n = min(len(pose3d), len(pose2d_gt), len(pose2d_cpn))
    w, h = seq.image_wh
    cam = dict(seq.camera)

    for i in range(n):
        box = geometry.infer_bbox(pose3d[i], cam, root_idx=0)
        center = (0.5 * (box[0] + box[2]), 0.5 * (box[1] + box[3]))
        scale = ((box[2] - box[0]) / 200.0, (box[3] - box[1]) / 200.0)
        trans = geometry.get_affine_transform(center, scale, CROP_SIZE)

        datum = {
            "image": None,  # path filled by the image extractor stage
            "joints_2d_gt": geometry.normalize_screen_coordinates(
                pose2d_gt[i], w=w, h=h
            ),
            "joints_2d_cpn": geometry.normalize_screen_coordinates(
                pose2d_cpn[i], w=w, h=h
            ),
            "joints_2d_gt_crop": geometry.affine_transform(
                pose2d_gt[i], trans
            ).astype("float32"),
            "joints_2d_cpn_crop": geometry.affine_transform(
                pose2d_cpn[i], trans
            ).astype("float32"),
            "joints_3d": pose3d[i] / 1000.0,
            "joints_vis": np.ones((17, 3)),
            "video_id": video_id,
            "image_id": i + 1,
            "subject": s,
            "action": a,
            "subaction": sa,
            "camera_id": c - 1,
            "source": "h36m",
            "camera": cam,
            "nposes": n,
            "center": center,
            "scale": scale,
            "box": box,
        }
        db.append(datum)


def make_cdf_source(
    extracted_root: str, cpn_npz_path: str, camera_pickle_path: str
) -> PoseSource:
    """PoseSource over an extracted H36M tree (requires cdflib).

    Mirrors the reference wiring: camera pickle (generate_labels_h36m.py:66-86),
    D3_Positions_mono + D2_Positions CDFs (:111-127), CPN keypoints from
    data_2d_h36m_cpn_ft_h36m_dbb.npz (:59-64,128), TakingPhoto/WalkingDog and
    Directions-S11 fixups (:96-122).
    """
    import cdflib  # gated: not in this image

    with open(camera_pickle_path, "rb") as f:
        camera_data = pickle.load(f)
    cpn = np.load(cpn_npz_path, allow_pickle=True)
    cpn_kps = cpn["positions_2d"].item()

    from contextaware_poseformer_tpu_torch.data.preprocess.h36m_metadata import (
        load_metadata,
    )

    metadata = load_metadata()

    def source(s, a, sa, c):
        base = metadata.get_base_filename(f"S{s}", str(a), str(sa),
                                          metadata.camera_ids[c - 1])
        # reference name fixups (:115-122)
        action_name = base.split(".")[0]
        subject = f"S{s}"
        if s == 11 and a == 2 and sa == 2:
            return None  # damaged Directions-2 S11 (reference skips it)
        cdf_3d = os.path.join(
            extracted_root, subject, "MyPoseFeatures", "D3_Positions_mono",
            f"{base}.cdf",
        )
        cdf_2d = os.path.join(
            extracted_root, subject, "MyPoseFeatures", "D2_Positions",
            f"{base}.cdf",
        )
        if not (os.path.exists(cdf_3d) and os.path.exists(cdf_2d)):
            return None
        p3 = cdflib.CDF(cdf_3d)["Pose"][0].reshape(-1, 32, 3)
        p2 = cdflib.CDF(cdf_2d)["Pose"][0].reshape(-1, 32, 2)
        cam = camera_data[(s, c)]
        cam_dict = {
            "R": cam[0], "T": cam[1], "fx": cam[2][0, 0], "fy": cam[2][1, 0],
            "cx": cam[3][0, 0], "cy": cam[3][1, 0], "k": cam[4], "p": cam[5],
        }
        name_map = {"TakingPhoto": "Photo", "WalkingDog": "WalkDog"}
        act = name_map.get(action_name.split(" ")[0], action_name)
        kps = cpn_kps[subject][act][c - 1]
        return SequenceData(
            pose3d_camera_mm=p3,
            pose2d_gt=p2,
            pose2d_cpn=kps,
            camera=cam_dict,
            image_wh=(1000, 1000),  # per-camera true size read from frames
        )

    return source
