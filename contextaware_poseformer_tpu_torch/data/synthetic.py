"""Synthetic dataset with geometrically-consistent labels: the port's copy of
``contextaware_poseformer_tpu/data/synthetic.py``.

Serves two purposes:
1. data-free smoke training (no H36M frames needed);
2. a learnability oracle: the 3D pose is a deterministic function of the 2D
   inputs plus structure painted into the image at the keypoint locations, so
   a working model+pipeline must drive MPJPE far below the trivial optimum.

Shapes/semantics exactly mirror H36MDataset, so everything downstream
(pipeline, steps, eval) is exercised unchanged. The same seed gives the same
arrays as the JAX package's class.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class SyntheticPoseDataset:
    size: int = 256
    image_shape: tuple[int, int] = (256, 192)
    num_joints: int = 17
    seed: int = 0
    root_idx: int = 0  # 14 for the 3DHP flavor
    num_seqs: int = 1  # >1 adds seq bookkeeping (3DHP-style)
    # filled in __post_init__
    joints_3d: np.ndarray = field(init=False)
    joints_2d: np.ndarray = field(init=False)
    joints_2d_crop: np.ndarray = field(init=False)
    action_idx: np.ndarray = field(init=False)
    seq_idx: np.ndarray = field(init=False)
    seq_names: tuple = field(init=False)
    _images: np.ndarray = field(init=False)

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        n, j = self.size, self.num_joints
        h, w = self.image_shape

        crop = rng.uniform(
            [w * 0.1, h * 0.1], [w * 0.9, h * 0.9], size=(n, j, 2)
        ).astype(np.float32)
        kp2d = (crop / [w / 2, h / 2] - 1.0).astype(np.float32)

        # 3D = fixed linear map of 2D + small noise; root-relative afterwards
        mix = np.random.RandomState(1234).randn(2, 3).astype(np.float32) * 0.1
        kp3d = kp2d @ mix + 0.005 * rng.randn(n, j, 3).astype(np.float32)
        kp3d[:, self.root_idx] = 0.0  # root

        images = rng.randint(0, 40, size=(n, h, w, 3)).astype(np.uint8)
        # paint bright disks at keypoints so image context carries signal
        yy, xx = np.mgrid[0:h, 0:w]
        for i in range(n):
            for q in range(0, j, 4):
                cx, cy = crop[i, q]
                mask = (xx - cx) ** 2 + (yy - cy) ** 2 < 9.0
                images[i][mask] = 255
        self.joints_3d = kp3d.astype(np.float32)
        self.joints_2d = kp2d
        self.joints_2d_crop = crop
        self.action_idx = np.random.RandomState(self.seed + 1).randint(
            0, 30, size=n
        ).astype(np.int32)
        self.seq_names = tuple(f"TS{i + 1}" for i in range(self.num_seqs))
        self.seq_idx = (np.arange(n) * self.num_seqs // max(n, 1)).astype(np.int32)
        self._images = images

    def __len__(self):
        return self.size

    def shard(self, rank: int, world_size: int) -> list[int]:
        """Contiguous per-rank slice (same contract as H36MDataset.shard)."""
        n = len(self) // world_size
        dist_size = [
            n if i < world_size - 1 else len(self) - n * (world_size - 1)
            for i in range(world_size)
        ]
        start = n * rank
        end = len(self) if rank == world_size - 1 else start + n
        for name in (
            "joints_3d", "joints_2d", "joints_2d_crop", "action_idx",
            "seq_idx", "_images",
        ):
            setattr(self, name, getattr(self, name)[start:end])
        self.size = end - start
        return dist_size

    def load_image(self, idx: int) -> np.ndarray:
        return self._images[idx]
