"""Packed raw-frame store: the port's copy of ``build_store`` and
``open_store`` from ``contextaware_poseformer_tpu/data/frame_store.py``.

A store is ONE standard .npy of shape (N, H, W, 3) uint8 (BGR, dataset item
order) opened with np.load(mmap_mode="r"); a batch read is a page-cache
memcpy: no JPEG decode, no warp, no thread pool. ``build_store`` writes one
by replaying a dataset's own decode and crop
(``python -m contextaware_poseformer_tpu_torch.tools.build_frame_store``);
any ``np.save`` of such an array also serves.
"""

from __future__ import annotations

import numpy as np


def build_store(ds, out_path: str, *, batch_size: int = 256,
                log_every: int = 50, log=print) -> str:
    """Write `ds`'s frames (dataset item order) to a memmap-able .npy.

    `ds` needs __len__, image_shape, load_image(i) and optionally
    load_batch(idxs) (used when it returns non-None — the native/cv2
    whole-batch path). The store replays the PRODUCTION decode+crop, so a
    store-backed dataset feeds byte-identical batches."""
    h, w = ds.image_shape
    n = len(ds)
    out = np.lib.format.open_memmap(
        out_path, mode="w+", dtype=np.uint8, shape=(n, h, w, 3)
    )
    for step, lo in enumerate(range(0, n, batch_size)):
        idxs = np.arange(lo, min(lo + batch_size, n))
        batch = getattr(ds, "load_batch", lambda _i: None)(idxs)
        if batch is None:
            batch = np.stack([ds.load_image(int(i)) for i in idxs])
        out[lo:lo + len(idxs)] = batch
        if log and step % log_every == 0:
            log(f"frame_store: {lo + len(idxs)}/{n} frames")
    out.flush()
    del out
    return out_path


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
