"""COCO keypoint dataset for the CPN 2D-detector trainer (models/cpn_coco.py).

The port's copy of ``contextaware_poseformer_tpu/data/coco.py`` (which
imports no JAX), held to it bit for bit, with cv2 and without it (the
numpy warp), by ``tests/test_torch_copies.py``.

The reference ships a CPN COCO train/test harness
(ContextPose/mvn/models/cpn/{train,test}.py) whose dataloader
(`dataloader.mscocoMulti`) is NOT vendored there; only its contract is
visible in the shipped drivers:

- train batch: (inputs, (target15, target11, target9, target7), valid, meta)
  (cpn/train.py:103-107) — four per-joint heatmap sets of DECREASING
  gaussian kernel (config.py:38-41 gk15/11/9/7), the sharpest (gk7) doubling
  as the refineNet target; `valid` gates the losses at >1.1 (globalNet) and
  >0.1 (refineNet), which with raw COCO visibility flags (0 = unlabeled,
  1 = occluded, 2 = visible) means: global heads train on visible joints
  only, the refine head on every labeled joint.
- test batch: (inputs, meta) with meta['imgID'], meta['det_scores'] and
  meta['augmentation_details'] = the [x0, y0, x1, y1] crop window in
  original-image pixels; cpn/test.py:106-107 maps heatmap peaks back with
  resx = (4*x + 2) / data_shape[1] * (x1 - x0) + x0.
- heatmap value scale: peak 255 (cpn/test.py:81 divides the refine map by
  255 to form a confidence in ~[0, 1]).

This module implements that contract: host-side numpy/cv2
produces packed (inputs, targets, valid) arrays; staging/device transfer
reuses data/pipeline.device_prefetch like every other dataset here.

Annotation input is the STANDARD `person_keypoints_*.json` schema (the
reference's preprocessed 'COCO_2017_train.json' is an undocumented private
rework of the same fields); detection input for test mode is the standard
COCO results list [{image_id, bbox, score}, ...].
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Iterator, Sequence

import numpy as np

from contextaware_poseformer_tpu_torch.utils.geometry import warp_affine_bilinear

# cpn/config.py:26-41
SYMMETRY = ((1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12), (13, 14), (15, 16))
PIXEL_MEANS_RGB = np.array([122.7717, 115.9465, 102.9801], dtype=np.float32)
DATA_SHAPE = (256, 192)  # (H, W)
OUTPUT_SHAPE = (64, 48)
GAUSS_KERNELS = (15, 11, 9, 7)
BBOX_EXTEND = (0.1, 0.15)  # (x, y)
SCALE_FACTOR = (0.7, 1.35)
ROT_FACTOR = 45.0
NUM_JOINTS = 17


def _cv2():
    try:
        import cv2

        return cv2
    except Exception:  # pragma: no cover - cv2 is present in this image
        return None


def gaussian_kernel_1d(ksize: int) -> np.ndarray:
    """cv2.getGaussianKernel(ksize, 0): sigma = 0.3*((ksize-1)*0.5 - 1) + 0.8,
    normalized to sum 1. Blurring a one-hot delta with GaussianBlur(k, 0)
    (the public CPN target generator) equals placing the outer product of
    this kernel at the point — we place it directly."""
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    xs = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(xs**2) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def place_gaussian(heatmap: np.ndarray, x: int, y: int, ksize: int) -> None:
    """Add a peak-255 truncated gaussian bump of kernel `ksize` at integer
    heatmap coords (x, y), in place. Out-of-map centers are skipped."""
    h, w = heatmap.shape
    if not (0 <= x < w and 0 <= y < h):
        return
    k1 = gaussian_kernel_1d(ksize)
    r = ksize // 2
    bump = np.outer(k1, k1)
    bump = bump / bump.max() * 255.0
    y0, y1 = max(0, y - r), min(h, y + r + 1)
    x0, x1 = max(0, x - r), min(w, x + r + 1)
    heatmap[y0:y1, x0:x1] = np.maximum(
        heatmap[y0:y1, x0:x1],
        bump[y0 - (y - r) : y1 - (y - r), x0 - (x - r) : x1 - (x - r)],
    )


def extend_bbox(bbox, img_w: float, img_h: float) -> np.ndarray:
    """[x, y, w, h] -> clipped [x0, y0, x1, y1] extended by BBOX_EXTEND
    (cpn/config.py:27 bbox_extend_factor)."""
    x, y, w, h = [float(v) for v in bbox]
    fx, fy = BBOX_EXTEND
    x0 = max(0.0, x - w * fx)
    y0 = max(0.0, y - h * fy)
    x1 = min(img_w, x + w * (1.0 + fx))
    y1 = min(img_h, y + h * (1.0 + fy))
    return np.array([x0, y0, x1, y1], dtype=np.float32)


def crop_affine(details: np.ndarray, rot_deg: float = 0.0,
                scale: float = 1.0) -> np.ndarray:
    """2x3 affine mapping the [x0,y0,x1,y1] window onto DATA_SHAPE pixels
    (anisotropic stretch — the harness does NOT preserve aspect; the decode
    formula in cpn/test.py:106-107 inverts exactly this linear map).
    Optional train-time rotation/scale about the window center."""
    x0, y0, x1, y1 = [float(v) for v in details]
    dh, dw = DATA_SHAPE
    sx = dw / max(x1 - x0, 1e-6) * scale
    sy = dh / max(y1 - y0, 1e-6) * scale
    cx, cy = (x0 + x1) * 0.5, (y0 + y1) * 0.5
    th = np.deg2rad(rot_deg)
    cos, sin = np.cos(th), np.sin(th)
    # source point p: shift to window center, rotate, scale, shift to output
    # center. trans = T(out_c) @ S @ R @ T(-src_c)
    a = np.array([[sx * cos, -sx * sin], [sy * sin, sy * cos]])
    t = np.array([dw * 0.5, dh * 0.5]) - a @ np.array([cx, cy])
    return np.concatenate([a, t[:, None]], axis=1).astype(np.float64)


def _warp(image: np.ndarray, trans: np.ndarray) -> np.ndarray:
    cv2 = _cv2()
    dh, dw = DATA_SHAPE
    if cv2 is not None:
        return cv2.warpAffine(image, trans[:2].astype(np.float64), (dw, dh),
                              flags=cv2.INTER_LINEAR)
    return warp_affine_bilinear(image, trans, (dw, dh))


@dataclass
class CocoRecord:
    image_id: int
    file_name: str
    details: np.ndarray  # [x0, y0, x1, y1] extended crop window
    keypoints: np.ndarray | None = None  # (17, 3) x, y, vis — train only
    det_score: float = 1.0


@dataclass
class CocoKeypointDataset:
    """Person-crop COCO keypoint dataset.

    train=True items: (image (256,192,3) float32 normalized, targets tuple of
    4 x (64,48,17) float32, valid (17,) float32).
    train=False items: (image, meta dict with image_id/det_score/details).
    """

    image_dir: str
    records: list[CocoRecord] = field(default_factory=list)
    train: bool = True

    @classmethod
    def from_annotations(cls, ann_path: str, image_dir: str, train: bool = True,
                         min_keypoints: int = 1) -> "CocoKeypointDataset":
        with open(ann_path) as f:
            coco = json.load(f)
        images = {im["id"]: im for im in coco["images"]}
        records = []
        for ann in coco["annotations"]:
            if ann.get("num_keypoints", 0) < min_keypoints or ann.get("iscrowd", 0):
                continue
            im = images[ann["image_id"]]
            kps = np.asarray(ann["keypoints"], np.float32).reshape(NUM_JOINTS, 3)
            records.append(CocoRecord(
                image_id=ann["image_id"],
                file_name=im["file_name"],
                details=extend_bbox(ann["bbox"], im["width"], im["height"]),
                keypoints=kps,
            ))
        return cls(image_dir=image_dir, records=records, train=train)

    @classmethod
    def from_detections(cls, det_path: str, ann_path: str, image_dir: str,
                        ) -> "CocoKeypointDataset":
        """Test-mode dataset from a COCO detection-results list (the
        reference evaluates on person detections, cpn/test.py:25-28)."""
        with open(ann_path) as f:
            coco = json.load(f)
        images = {im["id"]: im for im in coco["images"]}
        with open(det_path) as f:
            dets = json.load(f)
        records = []
        for d in dets:
            im = images[d["image_id"]]
            records.append(CocoRecord(
                image_id=d["image_id"],
                file_name=im["file_name"],
                details=extend_bbox(d["bbox"], im["width"], im["height"]),
                det_score=float(d.get("score", 1.0)),
            ))
        return cls(image_dir=image_dir, records=records, train=False)

    def __len__(self) -> int:
        return len(self.records)

    def _load_image(self, rec: CocoRecord) -> np.ndarray:
        path = os.path.join(self.image_dir, rec.file_name)
        cv2 = _cv2()
        if cv2 is not None:
            bgr = cv2.imread(path, cv2.IMREAD_COLOR)
            if bgr is None:
                raise FileNotFoundError(path)
            return bgr[..., ::-1].astype(np.float32)
        from PIL import Image  # pragma: no cover

        return np.asarray(Image.open(path).convert("RGB"), np.float32)

    def make_targets(self, kps_out: np.ndarray, valid: np.ndarray):
        """4 heatmap sets (64,48,17), kernels gk15/11/9/7, peak 255, for
        joints with valid > 0 whose (rounded) output coords are in-map."""
        oh, ow = OUTPUT_SHAPE
        targets = []
        for k in GAUSS_KERNELS:
            t = np.zeros((oh, ow, NUM_JOINTS), np.float32)
            for j in range(NUM_JOINTS):
                if valid[j] > 0:
                    x = int(round(float(kps_out[j, 0])))
                    y = int(round(float(kps_out[j, 1])))
                    place_gaussian(t[..., j], x, y, k)
            targets.append(t)
        return tuple(targets)

    def example(self, idx: int, rng: np.random.RandomState | None = None,
                augment: bool = False):
        rec = self.records[idx]
        image = self._load_image(rec)
        rot, scale, flip = 0.0, 1.0, False
        if augment and rng is not None:
            scale = float(rng.uniform(*SCALE_FACTOR))
            rot = float(rng.uniform(-ROT_FACTOR, ROT_FACTOR))
            flip = bool(rng.rand() < 0.5)
        trans = crop_affine(rec.details, rot, scale)
        img = _warp(image, trans)
        if flip:
            img = img[:, ::-1]
        x = (img - PIXEL_MEANS_RGB) / 255.0

        if not self.train:
            meta = {"image_id": rec.image_id, "det_score": rec.det_score,
                    "details": rec.details}
            return x.astype(np.float32), meta

        kps = rec.keypoints.copy()
        pts = kps[:, :2] @ trans[:, :2].T + trans[:, 2]
        valid = kps[:, 2].copy()
        if flip:
            pts[:, 0] = DATA_SHAPE[1] - 1 - pts[:, 0]
            for a, b in SYMMETRY:
                pts[[a, b]] = pts[[b, a]]
                valid[[a, b]] = valid[[b, a]]
        # joints warped outside the crop are unlabeled for this example
        oob = ((pts[:, 0] < 0) | (pts[:, 0] >= DATA_SHAPE[1])
               | (pts[:, 1] < 0) | (pts[:, 1] >= DATA_SHAPE[0]))
        valid = np.where(oob, 0.0, valid).astype(np.float32)
        targets = self.make_targets(pts / 4.0, valid)
        return x.astype(np.float32), targets, valid

    def batches(self, batch_size: int, rng: np.random.RandomState | None = None,
                augment: bool | None = None, drop_last: bool = True,
                ) -> Iterator[dict[str, Any]]:
        """Packed numpy batches. Train: {image, targets (4,B,64,48,17),
        valid}; test: {image, image_id, det_score, details}."""
        augment = self.train if augment is None else augment
        order = np.arange(len(self.records))
        if rng is not None and self.train:
            rng.shuffle(order)
        n = len(order)
        step = batch_size
        for s in range(0, n if not drop_last else n - step + 1, step):
            idxs = order[s : s + step]
            if len(idxs) < step and drop_last:
                return
            if self.train:
                ims, tgts, vals = [], [], []
                for i in idxs:
                    x, t, v = self.example(int(i), rng, augment)
                    ims.append(x), tgts.append(t), vals.append(v)
                yield {
                    "image": np.stack(ims),
                    "targets": tuple(
                        np.stack([t[k] for t in tgts]) for k in range(4)
                    ),
                    "valid": np.stack(vals),
                }
            else:
                ims, metas = [], []
                for i in idxs:
                    x, m = self.example(int(i))
                    ims.append(x), metas.append(m)
                yield {
                    "image": np.stack(ims),
                    "image_id": np.array([m["image_id"] for m in metas]),
                    "det_score": np.array([m["det_score"] for m in metas]),
                    "details": np.stack([m["details"] for m in metas]),
                }
