"""Human3.6M evaluation protocol.

Port of ``contextaware_poseformer_tpu/train/metrics.py:30-98``
(``h36m_evaluate``, ``h36m_summary``) over the port's losses: per-action P1
(MPJPE), P2 (Procrustes) and MPJVE with the -1/-2 trial merging of
Human36MMultiViewDataset.evaluate_using_pred (human36m.py:358-422). The
MPI-INF-3DHP PCK/AUC tables come with the 3DHP slice.
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
