"""CPN COCO test-time decode + native OKS average-precision evaluation.

The port's copy of ``contextaware_poseformer_tpu/train/coco_eval.py``
(which imports no JAX), held to it bit for bit, with cv2 and without it
(the separable reflect-101 blur), by ``tests/test_torch_copies.py``.

Decode reproduces ContextPose/mvn/models/cpn/test.py:74-117 step for step:
peak-normalize each joint map, 10px border pad, 21x21 gaussian blur, take
the top TWO peaks and shift the first a quarter pixel toward the second,
then map heatmap coords back to original-image pixels through the crop
window ((4x+2)/data_shape linear map, test.py:106-107). The instance score
is det_score * mean(per-joint confidence r0 = map/255 + 0.5) (test.py:80-116).

The OKS AP evaluator is a native reimplementation of pycocotools'
COCOeval(iouType='keypoints') protocol (test.py:126-132 runs that; the
package is not available here): per-gt-area-scaled OKS with the published
17 COCO keypoint sigmas, greedy score-ordered matching per image at 10
thresholds .50:.05:.95, 101-point interpolated precision, areas
all/medium/large, maxDets=20. Protocol subtleties reproduced: real-first /
ignored-last gt visit order with the real-match break rule, crowd gts as
multiply-matchable ignores, the bbox-fallback OKS for gts with no labeled
joints, keypoint-extent detection areas, and the unmatched-detection
area-range ignore. Exact-value golden fixtures with hand-derivable AP/AR
pin the protocol in tests/test_coco_eval_golden.py (pycocotools cannot be
installed in this environment, so the oracle is arithmetic, not the
canonical binary — residual risk is limited to rules not exercised by
those fixtures).
"""

from __future__ import annotations

import numpy as np

from contextaware_poseformer_tpu_torch.data.coco import (
    DATA_SHAPE,
    NUM_JOINTS,
    OUTPUT_SHAPE,
    SYMMETRY,
    gaussian_kernel_1d,
)

BORDER = 10
BLUR_KSIZE = 21
PEAK_SHIFT = 0.25

# pycocotools cocoeval.py COCOeval.computeOks sigmas (public constants)
OKS_SIGMAS = np.array(
    [.26, .25, .25, .35, .35, .79, .79, .72, .72,
     .62, .62, 1.07, 1.07, .87, .87, .89, .89], np.float64) / 10.0
OKS_THRESHOLDS = np.arange(0.5, 1.0, 0.05)
RECALL_THRESHOLDS = np.linspace(0.0, 1.0, 101)
MAX_DETS = 20
AREA_RANGES = {
    "all": (0.0, 1e10),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}


def _blur(img: np.ndarray) -> np.ndarray:
    """GaussianBlur((21,21), sigma=0) with reflect-101 borders — cv2 when
    present, exact separable numpy otherwise."""
    try:
        import cv2

        return cv2.GaussianBlur(img, (BLUR_KSIZE, BLUR_KSIZE), 0)
    except Exception:  # pragma: no cover
        k = gaussian_kernel_1d(BLUR_KSIZE).astype(np.float64)
        r = BLUR_KSIZE // 2
        p = np.pad(img, r, mode="reflect")
        p = np.apply_along_axis(lambda m: np.convolve(m, k, "valid"), 0, p)
        return np.apply_along_axis(lambda m: np.convolve(m, k, "valid"), 1, p)


def flip_merge(score_map: np.ndarray, flip_map: np.ndarray) -> np.ndarray:
    """Average direct and flipped-input heatmaps (test.py:57-70): mirror the
    flipped maps horizontally, swap symmetric joint channels.
    Maps are NHWC (N, 64, 48, 17)."""
    f = flip_map[:, :, ::-1, :].copy()
    for a, b in SYMMETRY:
        f[..., [a, b]] = f[..., [b, a]]
    return (score_map + f) / 2.0


def decode_batch(score_map: np.ndarray, details: np.ndarray,
                 det_scores: np.ndarray, image_ids: np.ndarray):
    """NHWC refine maps -> list of COCO keypoint result dicts
    (test.py:74-117)."""
    oh, ow = OUTPUT_SHAPE
    assert score_map.shape[1:] == (oh, ow, NUM_JOINTS), score_map.shape
    results = []
    for b in range(score_map.shape[0]):
        single = np.transpose(score_map[b], (2, 0, 1)).astype(np.float64)
        r0 = single.copy() / 255.0 + 0.5
        x0, y0, x1, y1 = [float(v) for v in details[b]]
        kps, v_score = [], np.zeros(NUM_JOINTS)
        for p in range(NUM_JOINTS):
            m = single[p] / max(np.amax(single[p]), 1e-12)
            dr = np.zeros((oh + 2 * BORDER, ow + 2 * BORDER))
            dr[BORDER:-BORDER, BORDER:-BORDER] = m
            dr = _blur(dr)
            y, x = np.unravel_index(dr.argmax(), dr.shape)
            dr[y, x] = 0
            py, px = np.unravel_index(dr.argmax(), dr.shape)
            y, x = y - BORDER, x - BORDER
            py, px = py - BORDER - y, px - BORDER - x
            ln = (px**2 + py**2) ** 0.5
            if ln > 1e-3:
                x += PEAK_SHIFT * px / ln
                y += PEAK_SHIFT * py / ln
            x = max(0, min(x, ow - 1))
            y = max(0, min(y, oh - 1))
            resy = (4 * y + 2) / DATA_SHAPE[0] * (y1 - y0) + y0
            resx = (4 * x + 2) / DATA_SHAPE[1] * (x1 - x0) + x0
            v_score[p] = r0[p, int(round(y) + 1e-10), int(round(x) + 1e-10)]
            kps += [float(resx), float(resy), 1.0]
        results.append({
            "image_id": int(image_ids[b]),
            "category_id": 1,
            "keypoints": kps,
            "score": float(det_scores[b]) * float(v_score.mean()),
        })
    return results


# ---------------------------------------------------------------------------
# native OKS AP (pycocotools COCOeval keypoints protocol)
# ---------------------------------------------------------------------------


def compute_oks(
    dt_kps: np.ndarray,
    gt_kps: np.ndarray,
    gt_area: float,
    gt_bbox: np.ndarray | None = None,
) -> float:
    """Single-pair OKS (cocoeval computeOks): mean over LABELED gt joints of
    exp(-d^2 / (2 * area * (2*sigma)^2)).

    For gts with NO labeled joints (crowd/unlabeled people), the canonical
    protocol measures each detection joint's distance to a bbox inflated by
    one box size on every side and averages over ALL joints — so detections
    sitting on an unlabeled person can still match (and be ignored with) it
    instead of counting as false positives.
    """
    var = (2 * OKS_SIGMAS) ** 2
    v = gt_kps[:, 2]
    mask = v > 0
    if mask.any():
        d2 = np.sum((dt_kps[:, :2] - gt_kps[:, :2]) ** 2, axis=1)
        e = d2 / var / (gt_area + np.spacing(1)) / 2.0
        return float(np.mean(np.exp(-e[mask])))
    if gt_bbox is None:
        return 0.0
    bx, by, bw, bh = [float(t) for t in gt_bbox]
    x0, x1 = bx - bw, bx + 2 * bw
    y0, y1 = by - bh, by + 2 * bh
    z = np.zeros(NUM_JOINTS)
    dx = np.maximum(z, x0 - dt_kps[:, 0]) + np.maximum(z, dt_kps[:, 0] - x1)
    dy = np.maximum(z, y0 - dt_kps[:, 1]) + np.maximum(z, dt_kps[:, 1] - y1)
    e = (dx**2 + dy**2) / var / (gt_area + np.spacing(1)) / 2.0
    return float(np.mean(np.exp(-e)))


def _match_image(dts, gts, thr: float, area_rng) -> tuple[list, list]:
    """Greedy score-ordered matching for one image at one OKS threshold.
    Returns (dt_matched flags aligned with dts, dt_ignore flags).

    Canonical-protocol details reproduced here:
    - gts are visited real-first / ignored-last (the reference sorts by the
      ignore flag with a stable sort before matching);
    - once a detection holds a real match, the scan BREAKS when it reaches
      the ignored tail (a real match is never traded for an ignored one);
    - crowd gts are always ignored and may absorb multiple detections;
    - an UNMATCHED detection whose own keypoint-extent area falls outside
      the evaluated area range is ignored rather than counted as a false
      positive.
    """
    gt_ignore = [
        g["crowd"]
        or not (area_rng[0] <= g["area"] <= area_rng[1])
        or g["num_keypoints"] == 0
        for g in gts
    ]
    order = sorted(range(len(gts)), key=lambda gi: gt_ignore[gi])
    gt_taken = [False] * len(gts)
    dt_matched, dt_ignore = [], []
    for dt in dts:
        best, best_oks = -1, min(thr, 1 - 1e-10)
        for gi in order:
            g = gts[gi]
            if gt_taken[gi] and not g["crowd"]:
                continue
            if best > -1 and not gt_ignore[best] and gt_ignore[gi]:
                break
            oks = compute_oks(dt["kps"], g["kps"], g["area"], g.get("bbox"))
            if oks > best_oks:
                best, best_oks = gi, oks
        if best == -1:
            # closed upper bound: pycocotools ignores when area > aRng[1],
            # so area == aRng[1] is IN range (both bounds inclusive)
            out_of_range = not (area_rng[0] <= dt["area"] <= area_rng[1])
            dt_matched.append(False)
            dt_ignore.append(out_of_range)
        else:
            gt_taken[best] = True
            dt_matched.append(not gt_ignore[best])
            dt_ignore.append(gt_ignore[best])
    return dt_matched, dt_ignore


def oks_ap(results: list[dict], gt_annotations: list[dict]) -> dict[str, float]:
    """COCO keypoint AP summary from result dicts + gt annotation dicts
    (standard schema rows: image_id, keypoints, area or bbox, num_keypoints).

    Returns {AP, AP50, AP75, AP_medium, AP_large, AR}.
    """
    by_img_dt: dict[int, list] = {}
    for r in results:
        kps = np.asarray(r["keypoints"], np.float64).reshape(NUM_JOINTS, 3)
        # canonical loadRes assigns each keypoint result its keypoint-extent
        # bbox area — the area the unmatched-detection range-ignore rule uses
        ext = (kps[:, 0].max() - kps[:, 0].min()) * (
            kps[:, 1].max() - kps[:, 1].min())
        by_img_dt.setdefault(int(r["image_id"]), []).append(
            {"kps": kps, "score": float(r["score"]), "area": float(ext)})
    by_img_gt: dict[int, list] = {}
    for g in gt_annotations:
        kps = np.asarray(g["keypoints"], np.float64).reshape(NUM_JOINTS, 3)
        area = float(g.get("area") or g["bbox"][2] * g["bbox"][3])
        by_img_gt.setdefault(int(g["image_id"]), []).append(
            {"kps": kps, "area": area,
             "crowd": bool(g.get("iscrowd", 0)),
             "bbox": (np.asarray(g["bbox"], np.float64)
                      if g.get("bbox") is not None else None),
             "num_keypoints": int(g.get(
                 "num_keypoints", int((kps[:, 2] > 0).sum())))})

    img_ids = sorted(set(by_img_gt) | set(by_img_dt))

    def _ap_for(area_name: str) -> tuple[float, dict[float, float], float]:
        rng = AREA_RANGES[area_name]
        precisions, recalls_at_thr = [], {}
        for thr in OKS_THRESHOLDS:
            scores, matched, ignored = [], [], []
            n_gt = 0
            for iid in img_ids:
                gts = by_img_gt.get(iid, [])
                dts = sorted(by_img_dt.get(iid, []),
                             key=lambda d: -d["score"])[:MAX_DETS]
                n_gt += sum(
                    rng[0] <= g["area"] <= rng[1] and g["num_keypoints"] > 0
                    and not g["crowd"]
                    for g in gts)
                m, ig = _match_image(dts, gts, float(thr), rng)
                scores += [d["score"] for d in dts]
                matched += m
                ignored += ig
            if n_gt == 0:
                precisions.append(None)
                recalls_at_thr[float(thr)] = float("nan")
                continue
            order = np.argsort(-np.asarray(scores, np.float64), kind="mergesort")
            m = np.asarray(matched)[order]
            ig = np.asarray(ignored)[order]
            keep = ~ig
            tp = np.cumsum(m[keep])
            fp = np.cumsum(~m[keep])
            rc = tp / n_gt
            pr = tp / np.maximum(tp + fp, np.spacing(1))
            # monotone-from-the-right interpolation, sample at 101 recalls
            for i in range(len(pr) - 1, 0, -1):
                pr[i - 1] = max(pr[i - 1], pr[i])
            q = np.zeros(len(RECALL_THRESHOLDS))
            inds = np.searchsorted(rc, RECALL_THRESHOLDS, side="left")
            for ri, pi in enumerate(inds):
                if pi < len(pr):
                    q[ri] = pr[pi]
            precisions.append(q)
            recalls_at_thr[float(thr)] = float(rc[-1]) if len(rc) else 0.0
        valid = [p for p in precisions if p is not None]
        ap = float(np.mean(valid)) if valid else float("nan")
        rec = [v for v in recalls_at_thr.values() if not np.isnan(v)]
        ar = float(np.mean(rec)) if rec else float("nan")
        # round the float keys: np.arange(0.5, 1.0, 0.05) lands on
        # 0.7500000000000001, which a literal .get(0.75) would miss
        # (caught by tests/test_coco_eval_golden.py — AP75 was NaN)
        per_thr = {
            round(float(thr), 2): (
                float(np.mean(p)) if p is not None else float("nan"))
            for thr, p in zip(OKS_THRESHOLDS, precisions)
        }
        return ap, per_thr, ar

    ap_all, per_thr, ar_all = _ap_for("all")
    ap_med, _, _ = _ap_for("medium")
    ap_lrg, _, _ = _ap_for("large")
    return {
        "AP": ap_all,
        "AP50": per_thr.get(0.5, float("nan")),
        "AP75": per_thr.get(0.75, float("nan")),
        "AP_medium": ap_med,
        "AP_large": ap_lrg,
        "AR": ar_all,
    }
