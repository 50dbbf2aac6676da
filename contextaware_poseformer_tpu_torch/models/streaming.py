"""Streaming deployment: multi-camera frames -> 3D poses, batch by batch.

Port of ``contextaware_poseformer_tpu/models/streaming.py`` (BASELINE.md
configuration 5: "video frames -> 2D detector -> context sampling -> 3D
lifting, batched multi-camera"). The unit of work is one fixed-size batch
of (cameras x time) frames through ``serve.lift``:

  uint8 BGR crops + upstream 2D detections (full-frame pixels) + crop boxes
  -> host: the detections normalized to the screen and mapped into crop
     pixels through each frame's affine (one batched solve, numpy)
  -> device: normalization, backbone, context sampling, lifter -> (N, 17, 3)

The last partial batch is padded by repeating its last row: a repeated row
keeps a batch's max|x|, which the dynamic int8 wide convs quantize with, so
padding changes no real row (zero rows would). ``lift_batch``
double-buffers, as the JAX package's does through async dispatch: the next
chunk's copy and compute are enqueued before the current chunk's result is
fetched. On a card each chunk is staged in pinned memory and copied
``non_blocking``, and its result comes back ``non_blocking`` into pinned
memory, read once its copy's event has completed. An optional exponential
moving average per camera smooths poses on the host.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from contextaware_poseformer_tpu_torch import serve
from contextaware_poseformer_tpu_torch.config import ModelConfig
from contextaware_poseformer_tpu_torch.utils import geometry

LATENCY_WINDOW = 4096  # lift_batch calls latency_stats covers


@dataclass
class StreamingConfig:
    batch_size: int = 64  # cameras x time slots a step
    use_bf16: bool = True  # the backbone's compute dtype
    ema_alpha: float = 0.0  # 0 disables temporal smoothing


class StreamingLifter:
    """A served model (``serve.lift``) with the stream's host plumbing.

    ``variables`` are the JAX package's flax variables with numpy leaves
    (``params``, optionally ``calib``/``qweights``), loaded through
    ``models/bridge.py``; ``device`` is where the model runs (the card
    unless the caller names another). With ``use_bf16`` the backbone
    computes in bf16 and every 4-D backbone parameter holds a bf16 value,
    as the JAX package casts them (an int8 conv keeps them in an fp32
    tensor). Without it the backbone computes in fp32, the int8 graphs
    included: K10, K10q and K10p run their fp32 forms on the card (an
    HRNet needs ``layer1_impl="xla"``, the per-conv chain, as
    ``config.deploy`` sets it: K9 is bf16 only). The lifter keeps the
    configuration's compute dtype."""

    def __init__(self, model_cfg: ModelConfig, variables,
                 cfg: StreamingConfig = StreamingConfig(), device="cuda"):
        self.model_cfg = model_cfg
        self.cfg = cfg
        self.device = torch.device(device)
        dtype = torch.bfloat16 if cfg.use_bf16 else torch.float32
        self.model = serve.build_model(model_cfg, dtype, self.device,
                                       variables=variables)
        if cfg.use_bf16:
            with torch.no_grad():
                for p in self.model.backbone.parameters():
                    if p.dim() == 4:
                        p.copy_(p.to(torch.bfloat16))
        self._hw = tuple(model_cfg.image_shape)
        self._ema: dict[int, np.ndarray] = {}
        # (ms, frames) pairs, trimmed together: frames/s is taken over the
        # same window as the latencies
        self._latencies: list[tuple[float, int]] = []
        # quantize "serve"/"static" needs calibrated activation scales
        # before the first lift (``prepare``); "c128" serves without
        self._needs_prepare = model_cfg.backbone.quantize in ("serve",
                                                              "static")

    def prepare(self, frames_u8: np.ndarray, keypoints_2d_full: np.ndarray,
                image_wh, centers: np.ndarray, scales: np.ndarray) -> None:
        """One-time serving preparation from a batch of real frames
        (``serve.prepare``: the int8 weights and, for "serve"/"static",
        the calibration in chunks of 16 frames). Required before
        ``lift_batch``/``stream`` under "serve" and "static"."""
        serve.prepare(self.model, [torch.from_numpy(
            np.ascontiguousarray(frames_u8)).to(self.device)])
        self._needs_prepare = False

    def _preprocess(self, keypoints_2d_full, image_wh, centers, scales):
        """Full-frame detections -> (screen-normalized, crop pixels), fp32,
        through the batched affine."""
        h, w = self._hw
        kp_norm = geometry.normalize_screen_coordinates(
            keypoints_2d_full, image_wh[0], image_wh[1]).astype(np.float32)
        trans = geometry.get_affine_transform_batch(centers, scales, (w, h))
        crop = geometry.affine_transform_batch(
            keypoints_2d_full, trans).astype(np.float32)
        return kp_norm, crop

    @staticmethod
    def pad(a: np.ndarray, bs: int) -> np.ndarray:
        """``a`` grown to ``bs`` rows by repeating its last row."""
        if len(a) == bs:
            return a
        return np.concatenate([a, np.repeat(a[-1:], bs - len(a), axis=0)])

    def lift_batch(self, frames_u8: np.ndarray,
                   keypoints_2d_full: np.ndarray, image_wh,
                   centers: np.ndarray, scales: np.ndarray) -> np.ndarray:
        """frames (N, H, W, 3) uint8 BGR crops, keypoints (N, J, 2)
        full-frame pixels, ``image_wh`` the full frame's size, centers and
        scales (N, 2) the crop boxes (/200 convention) -> (N, J, 3) fp32
        poses, in chunks of ``batch_size``."""
        if self._needs_prepare:
            raise ValueError(
                f'quantize="{self.model_cfg.backbone.quantize}" needs '
                "calibration: call prepare() with a real frame batch first")
        n = len(frames_u8)
        t0 = time.perf_counter()
        kp_norm, crop = self._preprocess(keypoints_2d_full, image_wh,
                                         centers, scales)
        bs = self.cfg.batch_size
        out = np.empty((n, keypoints_2d_full.shape[1], 3), np.float32)
        cuda = self.device.type == "cuda"
        # (rows, the result on the host, the event of its copy there)
        inflight: list[tuple[slice, torch.Tensor, object]] = []

        def drain():
            idx, res, done = inflight.pop(0)
            if done is not None:
                done.synchronize()
            out[idx] = res[:idx.stop - idx.start].numpy()

        for start in range(0, n, bs):
            idx = slice(start, min(start + bs, n))
            res = serve.lift(self.model, *(
                self._to_device(self.pad(a[idx], bs))
                for a in (frames_u8, kp_norm, crop)))
            done = None
            res = res.to("cpu", non_blocking=True)
            if cuda:
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.device))
            inflight.append((idx, res, done))
            if len(inflight) > 1:
                drain()
        while inflight:
            drain()
        self._record_latency((time.perf_counter() - t0) * 1e3, n)
        return out

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """A host chunk on the device: staged in pinned memory and copied
        ``non_blocking`` on a card. The caching host allocator hands a
        pinned block out again only after the copies that read it have
        completed, so no staging buffer is written while its copy runs."""
        src = torch.from_numpy(np.ascontiguousarray(a))
        host = torch.empty_like(src, pin_memory=self.device.type == "cuda")
        return host.copy_(src).to(self.device, non_blocking=True)

    def _record_latency(self, ms: float, n_frames: int) -> None:
        self._latencies.append((ms, n_frames))
        if len(self._latencies) > LATENCY_WINDOW:
            del self._latencies[:len(self._latencies) - LATENCY_WINDOW]

    def latency_stats(self) -> dict[str, float]:
        """p50/p90/p99/mean ``lift_batch`` wall latency (ms, on the host:
        preprocessing, copies, device time and the fetch) over the last
        ``LATENCY_WINDOW`` calls, and frames/s over the same calls."""
        if not self._latencies:
            return {"n": 0}
        lat = np.asarray([ms for ms, _ in self._latencies])
        frames = sum(n for _, n in self._latencies)
        return {
            "n": len(lat),
            "p50_ms": float(np.percentile(lat, 50)),
            "p90_ms": float(np.percentile(lat, 90)),
            "p99_ms": float(np.percentile(lat, 99)),
            "mean_ms": float(lat.mean()),
            "frames_per_sec": float(frames / (lat.sum() / 1e3)),
        }

    def stream(self, frames: Iterator[tuple[int, np.ndarray, np.ndarray]],
               image_wh, centers_scales) -> Iterator[tuple[int, np.ndarray]]:
        """Consume (camera_id, frame, detections) items in batches of
        ``batch_size``; yield (camera_id, pose (J, 3)) in order, each
        camera's poses smoothed by its own EMA when ``ema_alpha`` > 0.
        ``centers_scales(camera_id)`` gives the camera's crop box."""
        buf: list[tuple[int, np.ndarray, np.ndarray]] = []

        def flush():
            cams = [c for c, _, _ in buf]
            fr = np.stack([f for _, f, _ in buf])
            kp = np.stack([k for _, _, k in buf])
            cs = np.stack([centers_scales(c)[0] for c in cams])
            sc = np.stack([centers_scales(c)[1] for c in cams])
            poses = self.lift_batch(fr, kp, image_wh, cs, sc)
            for cam, pose in zip(cams, poses):
                if self.cfg.ema_alpha > 0:
                    prev = self._ema.get(cam)
                    if prev is not None:
                        pose = (self.cfg.ema_alpha * prev
                                + (1 - self.cfg.ema_alpha) * pose)
                    self._ema[cam] = pose
                yield cam, pose

        for item in frames:
            buf.append(item)
            if len(buf) == self.cfg.batch_size:
                yield from flush()
                buf.clear()
        if buf:
            yield from flush()
