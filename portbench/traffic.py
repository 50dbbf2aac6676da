"""The one generator of the benchmark's inputs, driven by a traffic file.

Everything is drawn on the device from ``--seed`` (a separate stream from
the weights'): smooth uint8 BGR crops (a coarse random image upsampled,
plus fine noise), full-frame normalized 2D keypoints in [-0.9, 0.9], crop
keypoints inside the crop, and, for training, camera-space 3D joints. The
same seed gives the same inputs; no two seeds differ in sizes or counts.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F

from portbench.weights import generator

INPUT_STREAM = 0x5EED  # added to the seed: the inputs' generator


def frames(g, n, hw, device, chunk=256):
    """(n, H, W, 3) uint8 smooth random frames, made in chunks."""
    h, w = hw
    out = torch.empty((n, h, w, 3), dtype=torch.uint8, device=device)
    for i in range(0, n, chunk):
        m = min(chunk, n - i)
        coarse = torch.rand((m, 3, h // 16, w // 16), generator=g,
                            device=device)
        img = F.interpolate(coarse, size=(h, w), mode="bilinear",
                            align_corners=False)
        img = img * 200.0 + 28.0 + 24.0 * torch.rand(
            (m, 3, h, w), generator=g, device=device) - 12.0
        out[i:i + m] = img.clamp(0, 255).round().to(torch.uint8).permute(
            0, 2, 3, 1)
    return out


def keypoints(g, n, joints, hw, device):
    """(kp2d (n, J, 2) normalized, kp2d_crop (n, J, 2) crop pixels)."""
    h, w = hw
    kp2d = torch.rand((n, joints, 2), generator=g, device=device) * 1.8 - 0.9
    margin = torch.tensor([8.0, 8.0], device=device)
    span = torch.tensor([w - 17.0, h - 17.0], device=device)
    crop = torch.rand((n, joints, 2), generator=g, device=device) * span \
        + margin
    return kp2d, crop


class ServingPool:
    """``requests`` requests of ``batch`` distinct frames each, with their
    keypoints, in pinned host memory; and ``calibration`` frames on the
    device."""

    def __init__(self, cfg, traffic, seed, device):
        g = generator(device, seed + INPUT_STREAM)
        hw = tuple(cfg["image_shape"])
        joints = cfg["lifter"]["num_joints"]
        r, b = traffic["pool_requests"], traffic["batch"]
        self.batch = b
        self.calibration = frames(g, cfg["calibration"]["frames"], hw,
                                  device)
        f = frames(g, r * b, hw, device)
        kp2d, crop = keypoints(g, r * b, joints, hw, device)

        def pinned(t):
            t = t.reshape(r, b, *t.shape[1:]).cpu()
            return t.pin_memory() if t.device != f.device else t

        self.frames, self.kp2d, self.crop = pinned(f), pinned(kp2d), \
            pinned(crop)

    def __len__(self):
        return self.frames.shape[0]


class WindowClosed(Exception):
    """Raised by ``Epochs.load_batch`` once the window's deadline has
    passed: the program's pipeline hands it to the training loop after the
    batches already made, and the epoch ends there."""


class TrainingSet:
    """``samples`` seeded training samples in host memory: ``images``
    (uint8), ``joints_2d``, ``joints_2d_crop`` and ``joints_3d``, indexed
    by row."""

    def __init__(self, cfg, traffic, seed, device):
        g = generator(device, seed + INPUT_STREAM)
        hw = tuple(cfg["image_shape"])
        joints = cfg["lifter"]["num_joints"]
        n = traffic["samples"]
        self.image_shape = hw
        self.images = frames(g, n, hw, device).cpu().numpy()
        kp2d, crop = keypoints(g, n, joints, hw, device)
        depth = torch.tensor([0.0, 0.0, 5.0], device=device)
        kp3d = torch.randn((n, joints, 3), generator=g, device=device) \
            * 0.3 + depth
        self.joints_2d = kp2d.cpu().numpy()
        self.joints_2d_crop = crop.cpu().numpy()
        self.joints_3d = kp3d.cpu().numpy()

    def __len__(self):
        return self.images.shape[0]


class _Rows:
    """An array of a ``TrainingSet`` read through the epochs' index map."""

    def __init__(self, base, rows):
        self.base, self.rows = base, rows

    def __getitem__(self, idxs):
        return self.base[self.rows[idxs]]


class Epochs:
    """``data`` cycled into epochs of ``epoch_samples`` rows, in the shape
    of the program's item datasets (``load_image``, ``load_batch``, the
    joints arrays, ``image_shape``), so that an epoch runs as many steps as
    a real one and the window sees no restart of the input pipeline.

    Index ``i`` reads row ``rows[i]``: the rank of ``i`` in the program's
    order of epoch 0 (``RandomState(seed).permutation``), modulo the rows,
    so that epoch 0 walks the rows in turn and its first batches are
    distinct rows. ``load_batch`` logs the rows of every batch asked for,
    in order, counts them (``served``), and raises ``WindowClosed`` once
    ``deadline`` (``time.perf_counter``) has passed."""

    def __init__(self, data: TrainingSet, epoch_samples: int, seed: int):
        n = len(data)
        self.rows = np.empty(epoch_samples, np.int64)
        self.rows[np.random.RandomState(seed).permutation(epoch_samples)] = \
            np.arange(epoch_samples) % n
        self.image_shape = data.image_shape
        self.images = _Rows(data.images, self.rows)
        self.joints_2d = _Rows(data.joints_2d, self.rows)
        self.joints_2d_crop = _Rows(data.joints_2d_crop, self.rows)
        self.joints_3d = _Rows(data.joints_3d, self.rows)
        self.log: list[np.ndarray] = []
        self.served = 0
        self.deadline = None

    def __len__(self):
        return self.rows.shape[0]

    def load_image(self, idx):
        return self.images[idx]

    def load_batch(self, idxs):
        if self.deadline is not None and time.perf_counter() >= \
                self.deadline:
            raise WindowClosed
        rows = self.rows[np.asarray(idxs)]
        self.log.append(rows)
        self.served += 1
        return self.images.base[rows]
