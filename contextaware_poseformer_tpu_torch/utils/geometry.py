"""Affine crop transforms and screen coordinates: the port's copy of
``get_affine_transform``, ``affine_transform``,
``get_affine_transform_batch``, ``affine_transform_batch``,
``bbox_center_scale``, ``warp_affine_bilinear``,
``normalize_screen_coordinates``, ``image_coordinates``, ``weak_project``
and ``infer_bbox`` from ``contextaware_poseformer_tpu/utils/geometry.py``.

- ``get_affine_transform``: center/scale*200 with `(w-1)*0.5` centering
  (ContextPose/mvn/utils/img.py:16-48); the cv2.getAffineTransform call is
  an exact 3-point linear solve. ``get_affine_transform_batch`` is the same
  solve over (N, 3, 3) stacked systems, for streaming's per-chunk crops.
- ``warp_affine_bilinear``: cv2.warpAffine(INTER_LINEAR, zero border) in
  numpy, for hosts without cv2.
- ``infer_bbox``: root joint +-(1000, 900/1100) mm weak projection
  (H36M-Toolbox/generate_labels_h36m.py:21-46), for the label builders of
  ``data/preprocess``.
"""

from __future__ import annotations

import numpy as np


def _third_point(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    # Completes an orthogonal triangle: rotate (a-b) by 90deg around b.
    direct = a - b
    return b + np.array([-direct[1], direct[0]], dtype=np.float32)


def get_affine_transform(
    center,
    scale,
    output_size,
    shift=(0.0, 0.0),
    inv: bool = False,
) -> np.ndarray:
    """2x3 affine mapping the scale*200 box around `center` onto `output_size`.

    `output_size` is (width, height). Matches mvn/utils/img.py:16-48 (rot=0
    path) including the (w-1)*0.5 center convention.
    """
    center = np.asarray(center, dtype=np.float32)
    scale = np.asarray(scale, dtype=np.float32)
    shift = np.asarray(shift, dtype=np.float32)

    scale_tmp = scale * 200.0
    src_w = scale_tmp[0]
    dst_w, dst_h = float(output_size[0]), float(output_size[1])

    src_dir = np.array([0.0, (src_w - 1) * -0.5], dtype=np.float32)
    dst_dir = np.array([0.0, (dst_w - 1) * -0.5], dtype=np.float32)

    src = np.zeros((3, 2), dtype=np.float32)
    dst = np.zeros((3, 2), dtype=np.float32)
    src[0] = center + scale_tmp * shift
    src[1] = center + src_dir + scale_tmp * shift
    dst[0] = [(dst_w - 1) * 0.5, (dst_h - 1) * 0.5]
    dst[1] = dst[0] + dst_dir
    src[2] = _third_point(src[0], src[1])
    dst[2] = _third_point(dst[0], dst[1])

    if inv:
        src, dst = dst, src

    # Solve for A (2x3) with A @ [x, y, 1]^T = dst over the 3 point pairs
    ones = np.ones((3, 1), dtype=np.float64)
    lhs = np.concatenate([src.astype(np.float64), ones], axis=1)  # (3,3)
    trans = np.linalg.solve(lhs, dst.astype(np.float64)).T  # (2,3)
    return trans.astype(np.float64)


def affine_transform(points: np.ndarray, trans: np.ndarray) -> np.ndarray:
    """Apply a 2x3 affine to (..., 2) points."""
    pts = np.asarray(points, dtype=np.float64)
    return pts @ trans[:, :2].T + trans[:, 2]


def get_affine_transform_batch(
    centers: np.ndarray,  # (N, 2)
    scales: np.ndarray,  # (N, 2)
    output_size,
    inv: bool = False,
) -> np.ndarray:
    """Batched get_affine_transform -> (N, 2, 3), bit-identical per row:
    one stacked (N, 3, 3) solve instead of a per-frame loop."""
    centers = np.asarray(centers, dtype=np.float32).reshape(-1, 2)
    scales = np.asarray(scales, dtype=np.float32).reshape(-1, 2)
    n = len(centers)
    scale_tmp = scales * 200.0
    src_w = scale_tmp[:, 0]  # (N,)
    dst_w, dst_h = float(output_size[0]), float(output_size[1])

    src = np.zeros((n, 3, 2), dtype=np.float32)
    dst = np.zeros((n, 3, 2), dtype=np.float32)
    src[:, 0] = centers
    src[:, 1] = centers + np.stack(
        [np.zeros(n, np.float32), (src_w - 1) * -0.5], axis=1
    )
    dst[:, 0] = [(dst_w - 1) * 0.5, (dst_h - 1) * 0.5]
    dst[:, 1] = dst[:, 0] + np.array([0.0, (dst_w - 1) * -0.5], np.float32)
    # third point: rotate (p0 - p1) by 90deg around p1
    for pts in (src, dst):
        d = pts[:, 0] - pts[:, 1]
        pts[:, 2, 0] = pts[:, 1, 0] - d[:, 1]
        pts[:, 2, 1] = pts[:, 1, 1] + d[:, 0]

    if inv:
        src, dst = dst, src
    ones = np.ones((n, 3, 1), dtype=np.float64)
    lhs = np.concatenate([src.astype(np.float64), ones], axis=2)  # (N,3,3)
    sol = np.linalg.solve(lhs, dst.astype(np.float64))  # (N,3,2)
    return np.transpose(sol, (0, 2, 1))  # (N,2,3)


def affine_transform_batch(points: np.ndarray,
                           trans: np.ndarray) -> np.ndarray:
    """Apply per-item 2x3 affines: (N, ..., 2) @ (N, 2, 3)."""
    pts = np.asarray(points, dtype=np.float64)
    lin = np.einsum("n...j,nij->n...i", pts, trans[:, :, :2])
    offs = trans[:, :, 2].reshape((len(trans),) + (1,) * (pts.ndim - 2) + (2,))
    return lin + offs


def bbox_center_scale(box, aspect_ratio: float, pixel_std: float = 200.0):
    """(x1,y1,x2,y2) -> (center, scale): width or height grown to match
    ``aspect_ratio`` (w/h), scale = size / pixel_std."""
    box = np.asarray(box, dtype=np.float32)
    center = np.array(
        [(box[0] + box[2]) * 0.5, (box[1] + box[3]) * 0.5], dtype=np.float32
    )
    w, h = box[2] - box[0], box[3] - box[1]
    if w > aspect_ratio * h:
        h = w / aspect_ratio
    elif w < aspect_ratio * h:
        w = h * aspect_ratio
    scale = np.array([w / pixel_std, h / pixel_std], dtype=np.float32)
    return center, scale


def warp_affine_bilinear(image: np.ndarray, trans: np.ndarray,
                         output_size) -> np.ndarray:
    """cv2.warpAffine(INTER_LINEAR, zero border) replacement in numpy.

    `trans` maps source -> destination (as produced by get_affine_transform);
    it is inverted and the source sampled bilinearly. Matches crop_image
    (mvn/utils/img.py:51-69) for the no-rotation transforms used here.
    """
    out_w, out_h = int(output_size[0]), int(output_size[1])
    full = np.eye(3, dtype=np.float64)
    full[:2] = trans
    inv = np.linalg.inv(full)

    ys, xs = np.mgrid[0:out_h, 0:out_w].astype(np.float64)
    src_x = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    src_y = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]

    h, w = image.shape[:2]
    x0 = np.floor(src_x).astype(np.int64)
    y0 = np.floor(src_y).astype(np.int64)
    wx = src_x - x0
    wy = src_y - y0

    img = image.astype(np.float64)
    if img.ndim == 2:
        img = img[..., None]

    def fetch(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        yc = np.clip(yi, 0, h - 1)
        xc = np.clip(xi, 0, w - 1)
        vals = img[yc, xc]
        vals[~valid] = 0.0
        return vals

    out = (
        fetch(y0, x0) * ((1 - wy) * (1 - wx))[..., None]
        + fetch(y0, x0 + 1) * ((1 - wy) * wx)[..., None]
        + fetch(y0 + 1, x0) * (wy * (1 - wx))[..., None]
        + fetch(y0 + 1, x0 + 1) * (wy * wx)[..., None]
    )
    if image.ndim == 2:
        out = out[..., 0]
    if np.issubdtype(image.dtype, np.integer):
        out = np.clip(np.round(out), 0, 255)
    return out.astype(image.dtype)


def normalize_screen_coordinates(x: np.ndarray, w: float, h: float) -> np.ndarray:
    """Map [0,w]x[0,h] pixels to [-1,1] x-range preserving aspect ratio."""
    x = np.asarray(x)
    assert x.shape[-1] == 2
    return x / w * 2.0 - np.array([1.0, h / w])


def image_coordinates(x: np.ndarray, w: float, h: float) -> np.ndarray:
    """Inverse of normalize_screen_coordinates."""
    x = np.asarray(x)
    assert x.shape[-1] == 2
    return (x + np.array([1.0, h / w])) * w / 2.0


def weak_project(pose3d: np.ndarray, fx, fy, cx, cy) -> np.ndarray:
    """Pinhole projection without distortion (generate_labels_h36m.py:40-46)."""
    pose2d = pose3d[..., :2] / pose3d[..., 2:3]
    return pose2d * np.array([fx, fy]) + np.array([cx, cy])


def infer_bbox(pose3d_camspace: np.ndarray, camera: dict, root_idx: int) -> np.ndarray:
    """Person bbox from the root joint's weak projection: the reference pads
    the root by (-1000,-900) / (+1000,+1100) mm before projecting
    (generate_labels_h36m.py:21-38; same constants in
    ContextPose_mpi/dataset/data_util/data_to_npz_3dhp.py:30-55)."""
    root = pose3d_camspace[root_idx]
    tl = root + np.array([-1000.0, -900.0, 0.0])
    br = root + np.array([1000.0, 1100.0, 0.0])
    tl2d = weak_project(tl[None], camera["fx"], camera["fy"], camera["cx"], camera["cy"])[0]
    br2d = weak_project(br[None], camera["fx"], camera["fy"], camera["cx"], camera["cy"])[0]
    return np.array([tl2d[0], tl2d[1], br2d[0], br2d[1]])
