"""Packed raw-frame store: the port's copy of ``open_store`` from
``contextaware_poseformer_tpu/data/frame_store.py``.

A store is ONE standard .npy of shape (N, H, W, 3) uint8 (BGR, dataset item
order) opened with np.load(mmap_mode="r"); a batch read is a page-cache
memcpy: no JPEG decode, no warp, no thread pool. Stores are written by the
JAX package's ``build_store`` (or any ``np.save`` of such an array).
"""

from __future__ import annotations

import numpy as np


def open_store(path: str, image_shape) -> np.ndarray:
    """mmap an existing store and validate its geometry (not its length —
    the caller matches N against its own label count)."""
    arr = np.load(path, mmap_mode="r")
    h, w = image_shape
    if arr.dtype != np.uint8 or arr.ndim != 4 or arr.shape[1:] != (h, w, 3):
        raise ValueError(
            f"frame store {path}: shape {arr.shape} dtype {arr.dtype}, "
            f"expected (N, {h}, {w}, 3) uint8"
        )
    return arr
