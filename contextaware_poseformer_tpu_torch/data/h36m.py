"""Human3.6M dataset: the port's copy of
``contextaware_poseformer_tpu/data/h36m.py``.

Consumes the `h36m_{train,validation}.pkl` label files the reference builds
(H36M-Toolbox/generate_labels_h36m.py:137-200: per-frame dicts with
joints_3d [meters, camera space], joints_2d_cpn [full-frame normalized],
joints_2d_cpn_crop [192x256 crop pixels], center/scale bbox, subject/action/
subaction/camera ids) and serves the item of
Human36MSingleViewDataset.__getitem__ (ContextPose/mvn/datasets/human36m.py:
554-584): cropped uint8 BGR image + labels.

All scalar labels are packed into contiguous numpy arrays at load time; only
the jpeg decode + affine crop remains per-item work (data/pipeline.py), or
none with a packed frame store. Augmentation and normalization run on the
device (data/augment.py), so items here stay raw uint8.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass

import numpy as np

from contextaware_poseformer_tpu_torch.utils import geometry

try:  # cv2 when present; a numpy warp otherwise
    import cv2
except Exception:  # pragma: no cover
    cv2 = None


@dataclass
class H36MDataset:
    root: str  # images root (subdirs s_XX_act_XX_subact_XX_ca_XX/)
    joints_3d: np.ndarray  # (N, 17, 3) float32 meters, camera space
    joints_2d: np.ndarray  # (N, 17, 2) float32 full-frame normalized (CPN)
    joints_2d_crop: np.ndarray  # (N, 17, 2) float32 crop pixels (CPN)
    center: np.ndarray  # (N, 2)
    scale: np.ndarray  # (N, 2)
    action_idx: np.ndarray  # (N,) 0..29 (action-2)*2 + (subaction-1)
    subject_idx: np.ndarray  # (N,)
    video_idx: np.ndarray  # (N,)
    image_paths: np.ndarray  # (N,) relative jpeg paths
    image_shape: tuple[int, int] = (256, 192)  # (H, W)
    precropped: bool = False  # images on disk already 192x256 crops
    # packed raw-frame store (data/frame_store.py): (N, H, W, 3) uint8
    # memmap + the original-label index of each retained item
    frame_store: np.ndarray | None = None
    store_idx: np.ndarray | None = None

    @staticmethod
    def from_pickle(
        labels_path: str,
        root: str,
        image_shape: tuple[int, int] = (256, 192),
        precropped: bool = False,
        retain_every_n: int = 1,
        frame_store: str | None = None,
    ) -> "H36MDataset":
        """retain_every_n mirrors val.retain_every_n_frames_in_test
        (human36m.yaml:86, human36m.py:129). frame_store: path to a packed
        raw-frame .npy; accepts a store built over the FULL pickle (retain
        mapping applied here) or over this exact retained view."""
        with open(labels_path, "rb") as f:
            labels = pickle.load(f)
        full_n = len(labels)
        if retain_every_n > 1:
            labels = labels[::retain_every_n]
        n = len(labels)
        store, store_idx = None, None
        if frame_store:
            from contextaware_poseformer_tpu_torch.data import frame_store as fs

            store = fs.open_store(frame_store, image_shape)
            if store.shape[0] == full_n:
                store_idx = np.arange(full_n, dtype=np.int64)[::retain_every_n]
            elif store.shape[0] == n:
                store_idx = np.arange(n, dtype=np.int64)
            else:
                raise ValueError(
                    f"frame store has {store.shape[0]} frames; labels have "
                    f"{full_n} (retained: {n})"
                )
        get = lambda key, shape, dt=np.float32: np.asarray(  # noqa: E731
            [l[key] for l in labels], dtype=dt
        ).reshape(n, *shape)

        subdir_fmt = "s_{:02d}_act_{:02d}_subact_{:02d}_ca_{:02d}"
        img_fmt = "s_{:02d}_act_{:02d}_subact_{:02d}_ca_{:02d}_{:06d}.jpg"
        paths = np.asarray(
            [
                os.path.join(
                    subdir_fmt.format(
                        l["subject"], l["action"], l["subaction"],
                        l["camera_id"] + 1,
                    ),
                    img_fmt.format(
                        l["subject"], l["action"], l["subaction"],
                        l["camera_id"] + 1, l["image_id"],
                    ),
                )
                for l in labels
            ]
        )
        actions = np.asarray([l["action"] for l in labels])
        subactions = np.asarray([l["subaction"] for l in labels])
        return H36MDataset(
            root=root,
            joints_3d=get("joints_3d", (17, 3)),
            joints_2d=get("joints_2d_cpn", (17, 2)),
            joints_2d_crop=get("joints_2d_cpn_crop", (17, 2)),
            center=get("center", (2,)),
            scale=get("scale", (2,)),
            # (action-2)*2 + (subaction-1), human36m.py:529-530
            action_idx=((actions - 2) * 2 + (subactions - 1)).astype(np.int32),
            subject_idx=np.asarray([l["subject"] for l in labels], np.int32),
            video_idx=np.asarray([l["video_id"] for l in labels], np.int64),
            image_paths=paths,
            image_shape=image_shape,
            precropped=precropped,
            frame_store=store,
            store_idx=store_idx,
        )

    def __len__(self) -> int:
        return len(self.image_paths)

    def shard(self, rank: int, world_size: int) -> list[int]:
        """Contiguous per-rank label sharding with dist_size bookkeeping
        (human36m.py:536-552). Mutates this dataset to the rank's slice."""
        n = len(self) // world_size
        dist_size = [
            n if i < world_size - 1 else len(self) - n * (world_size - 1)
            for i in range(world_size)
        ]
        start = n * rank
        end = len(self) if rank == world_size - 1 else start + n
        for name in (
            "joints_3d", "joints_2d", "joints_2d_crop", "center", "scale",
            "action_idx", "subject_idx", "video_idx", "image_paths",
            "store_idx",
        ):
            if getattr(self, name) is not None:
                setattr(self, name, getattr(self, name)[start:end])
        return dist_size

    def load_batch(self, idxs: np.ndarray) -> np.ndarray | None:
        """Whole-batch load: packed raw-frame store when configured (one
        mmap fancy-index — zero decode), else decode+crop via the native
        C++ loader (one GIL-free call over a thread pool); None if neither
        is available and the pipeline should take per-item load_image."""
        if self.frame_store is not None:
            return np.ascontiguousarray(
                self.frame_store[self.store_idx[np.asarray(idxs)]]
            )
        from contextaware_poseformer_tpu_torch.data import native_loader

        if not native_loader.available():
            return None
        h, w = self.image_shape
        paths = [os.path.join(self.root, str(self.image_paths[i])) for i in idxs]
        if self.precropped:
            return native_loader.load_crop_batch(
                paths, None, (h, w), precropped=True
            )
        trans = np.stack([
            geometry.get_affine_transform(self.center[i], self.scale[i], (w, h))
            for i in idxs
        ])
        return native_loader.load_crop_batch(paths, trans, (h, w))

    def load_image(self, idx: int) -> np.ndarray:
        """Cropped (H, W, 3) uint8 BGR frame (human36m.py:569-571)."""
        if self.frame_store is not None:
            return np.asarray(self.frame_store[int(self.store_idx[idx])])
        path = os.path.join(self.root, str(self.image_paths[idx]))
        h, w = self.image_shape
        if cv2 is not None:
            img = cv2.imread(path, cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
        else:  # pragma: no cover
            from PIL import Image

            img = np.asarray(Image.open(path))[..., ::-1]  # RGB->BGR
        if img is None:
            raise FileNotFoundError(path)
        if self.precropped and img.shape[:2] == (h, w):
            return img
        trans = geometry.get_affine_transform(
            self.center[idx], self.scale[idx], (w, h)
        )
        if cv2 is not None:
            return cv2.warpAffine(img, trans, (w, h), flags=cv2.INTER_LINEAR)
        return geometry.warp_affine_bilinear(img, trans, (w, h))
