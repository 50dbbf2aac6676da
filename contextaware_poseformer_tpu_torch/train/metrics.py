"""Human3.6M and MPI-INF-3DHP evaluation protocols.

Port of ``contextaware_poseformer_tpu/train/metrics.py:30-206``:
``h36m_evaluate`` and ``h36m_summary`` over the port's losses (per-action
P1 (MPJPE), P2 (Procrustes) and MPJVE with the -1/-2 trial merging of
Human36MMultiViewDataset.evaluate_using_pred, human36m.py:358-422), and the
numpy-only 3DHP tables (``joint_errors_mm``, ``pck_auc``,
``mpi3dhp_evaluate``), copied as they are. The 2D PCKh comes with the COCO
slice.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from contextaware_poseformer_tpu_torch.train import losses
from contextaware_poseformer_tpu_torch.utils import skeleton


def h36m_evaluate(
    keypoints_gt: np.ndarray,  # (N, J, 3) root-relative meters
    keypoints_pred: np.ndarray,  # (N, J, 3)
    action_idx: np.ndarray,  # (N,) into skeleton.H36M_ACTION_NAMES
) -> dict[str, dict[str, float]]:
    """Per-action scores with -1/-2 trial merging; values in input units
    (the driver multiplies by 1000 for mm, train.py:421-431)."""
    gt = np.asarray(keypoints_gt, np.float32)
    pred = np.asarray(keypoints_pred, np.float32)
    action_idx = np.asarray(action_idx)
    names = skeleton.H36M_ACTION_NAMES

    scores: dict[str, dict[str, float]] = {}
    for idx, name in enumerate(names):
        mask = action_idx == idx
        n = int(np.count_nonzero(mask))
        if n == 0:
            scores[name] = {"MPJPE": 0.0, "P_MPJPE": 0.0, "MPJVE": 0.0,
                            "frame_count": 0}
            continue
        p, g = pred[mask], gt[mask]
        scores[name] = {
            "MPJPE": n * float(np.mean(np.linalg.norm(p - g, axis=-1))),
            "P_MPJPE": n * losses.p_mpjpe(p, g),
            "MPJVE": n * losses.mpjve(p, g),
            "frame_count": n,
        }

    merged: dict[str, dict[str, float]] = {}
    for base in sorted({n[:-2] for n in names}):
        tot = {"MPJPE": 0.0, "P_MPJPE": 0.0, "MPJVE": 0.0, "frame_count": 0}
        for trial in (1, 2):
            s = scores[f"{base}-{trial}"]
            for k in tot:
                tot[k] += s[k]
        n = max(tot["frame_count"], 1)
        merged[base] = {
            "MPJPE": tot["MPJPE"] / n,
            "P_MPJPE": tot["P_MPJPE"] / n,
            "MPJVE": tot["MPJVE"] / n,
            "frame_count": tot["frame_count"],
        }
    return merged


def h36m_summary(
        action_scores: Mapping[str, Mapping[str, float]]) -> dict[str, float]:
    """Headline numbers in mm: unweighted mean over the actions that have
    frames, x1000 (train.py:385-395, 421-437)."""
    present = [v for v in action_scores.values()
               if v.get("frame_count", 1) > 0]
    if not present:
        return {"p1_mm": float("nan"), "p2_mm": float("nan"),
                "mpjve_mm": float("nan")}
    return {
        "p1_mm": float(np.mean([v["MPJPE"] * 1000 for v in present])),
        "p2_mm": float(np.mean([v["P_MPJPE"] * 1000 for v in present])),
        "mpjve_mm": float(np.mean([v["MPJVE"] * 1000 for v in present])),
    }


# ---------------------------------------------------------------------------
# MPI-INF-3DHP PCK / AUC (native replacement of the MATLAB scripts)
# ---------------------------------------------------------------------------

# mpii_get_pck_auc_joint_groups.m, converted to 0-based indices
MPI3DHP_JOINT_GROUPS: tuple[tuple[str, tuple[int, ...]], ...] = (
    ("Head", (0,)),
    ("Neck", (1,)),
    ("Shou", (2, 5)),
    ("Elbow", (3, 6)),
    ("Wrist", (4, 7)),
    ("Hip", (8, 11)),
    ("Knee", (9, 12)),
    ("Ankle", (10, 13)),
)

PCK_THRESHOLD_MM = 150.0
AUC_THRESHOLDS_MM = tuple(float(t) for t in range(0, 151, 5))

MPI3DHP_ACTIVITY_NAMES = (
    "Stand/Walk", "Exercise", "Sit on Chair", "Reach/Crouch", "On the Floor",
    "Sports", "Misc.",
)


def joint_errors_mm(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """(N, 17, 3) mm -> (N, 17) per-joint euclidean errors
    (mpii_test_predictions_py.m:49-52)."""
    return np.linalg.norm(np.asarray(pred) - np.asarray(gt), axis=-1)


def pck_auc(errors: np.ndarray) -> dict[str, float]:
    """PCK@150 and AUC over thresholds 0:5:150, group-weighted total
    (mpii_compute_3d_pck.m:18-50). `errors` is (N, 17) in mm."""
    out: dict[str, float] = {}
    total_pck = 0.0
    total_auc = 0.0
    joint_count = 0
    ths = np.asarray(AUC_THRESHOLDS_MM)
    for name, joints in MPI3DHP_JOINT_GROUPS:
        e = errors[:, list(joints)]
        # strict '<' as in the MATLAB code
        curve = (e[None] < ths[:, None, None]).mean(axis=(1, 2))
        pck = float((e < PCK_THRESHOLD_MM).mean() * 100.0)
        auc = float(curve.mean() * 100.0)
        out[f"pck_{name}"] = pck
        out[f"auc_{name}"] = auc
        total_pck += pck * len(joints)
        total_auc += auc * len(joints)
        joint_count += len(joints)
    out["pck"] = total_pck / joint_count
    out["auc"] = total_auc / joint_count
    return out


def mpi3dhp_evaluate(
    seq_errors: Mapping[str, np.ndarray],  # TS name -> (nf, 17) mm errors
    seq_activities: Mapping[str, np.ndarray] | None = None,  # TS -> (nf,) 1..7
) -> dict[str, dict[str, float]]:
    """Sequencewise + activitywise + overall + scene-setting tables
    (mpii_evaluate_errors.m; scene weighting 3dhp_test/README.txt:20-24)."""
    result: dict[str, dict[str, float]] = {}
    all_err = []
    all_act = []
    for seq in skeleton.MPI3DHP_TEST_SEQUENCES:
        if seq not in seq_errors:
            continue
        e = np.asarray(seq_errors[seq])
        all_err.append(e)
        if seq_activities is not None and seq in seq_activities:
            all_act.append(np.asarray(seq_activities[seq]))
        result[seq] = {"mpjpe": float(e.mean()), **pck_auc(e)}

    if not all_err:
        return result
    cat = np.concatenate(all_err, axis=0)
    result["All"] = {"mpjpe": float(cat.mean()), **pck_auc(cat)}

    if all_act and len(all_act) == len(all_err):
        acts = np.concatenate(all_act, axis=0)
        for a in range(1, 8):
            mask = acts == a
            if mask.any():
                result[MPI3DHP_ACTIVITY_NAMES[a - 1]] = {
                    "mpjpe": float(cat[mask].mean()),
                    **pck_auc(cat[mask]),
                }

    # scene-setting aggregation: frame-count weighted means of sequencewise
    # numbers (README.txt:20-24)
    for setting, seq_weights in skeleton.MPI3DHP_SCENE_SETTINGS.items():
        entries = [(result[s], w) for s, w in seq_weights if s in result]
        if not entries:
            continue
        wsum = sum(w for _, w in entries)
        result[setting] = {
            k: sum(r[k] * w for r, w in entries) / wsum
            for k in entries[0][0]
        }
    return result
