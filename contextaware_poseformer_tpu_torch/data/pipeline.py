"""Host-side batch pipeline: threaded image loading into fixed-shape numpy
batches, then a copy to the device.

Port of ``contextaware_poseformer_tpu/data/pipeline.py:28-126`` without its
JAX import: ``RawBatch`` (numpy leaves here), ``_assemble``,
``batch_iterator`` and ``device_prefetch``. Datasets are the port's copies
(``data/synthetic.py``, ``data/h36m.py``, ``data/mpi3dhp.py``).

Fixed shapes always: train drops the remainder (shuffled anyway); eval pads
the final batch and reports ``valid``, which the evaluator trims.
``to_device`` stages a batch through pinned host memory with a
``non_blocking`` copy; ``device_prefetch`` runs the assembly and that copy
ahead of the consumer, on a thread and a CUDA side stream.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, NamedTuple, Protocol

import numpy as np
import torch

from contextaware_poseformer_tpu_torch.utils.profiling import span


class RawBatch(NamedTuple):
    """Raw images + labels with fixed shapes (numpy on the host, tensors
    after ``to_device``)."""

    images_u8: np.ndarray  # (b, H, W, 3) uint8 BGR, pre-cropped
    keypoints_3d: np.ndarray  # (b, J, 3) camera-space, not root-centered
    keypoints_2d: np.ndarray  # (b, J, 2) full-frame normalized
    keypoints_2d_crop: np.ndarray  # (b, J, 2) crop pixels


class ItemDataset(Protocol):
    def __len__(self) -> int: ...
    def load_image(self, idx: int) -> np.ndarray: ...

    joints_3d: np.ndarray
    joints_2d: np.ndarray
    joints_2d_crop: np.ndarray
    image_shape: tuple[int, int]


def _assemble(ds: ItemDataset, idxs: np.ndarray, pool: ThreadPoolExecutor,
              pad_to: int | None = None) -> tuple[RawBatch, int]:
    h, w = ds.image_shape
    n = len(idxs)
    total = pad_to or n
    batch_imgs = getattr(ds, "load_batch", lambda _i: None)(idxs)
    if batch_imgs is not None:  # native C++ loader: one GIL-free call
        if total == n:
            images = batch_imgs
        else:
            images = np.zeros((total, h, w, 3), np.uint8)
            images[:n] = batch_imgs
    else:
        images = np.zeros((total, h, w, 3), np.uint8)
        for i, img in zip(range(n), pool.map(ds.load_image, idxs)):
            images[i] = img

    def pad(a):
        if total == n:
            return a
        out = np.zeros((total, *a.shape[1:]), a.dtype)
        out[:n] = a
        return out

    batch = RawBatch(
        images_u8=images,
        keypoints_3d=pad(ds.joints_3d[idxs].astype(np.float32)),
        keypoints_2d=pad(ds.joints_2d[idxs].astype(np.float32)),
        keypoints_2d_crop=pad(ds.joints_2d_crop[idxs].astype(np.float32)),
    )
    return batch, n


def batch_iterator(
    ds: ItemDataset,
    batch_size: int,
    *,
    shuffle: bool,
    seed: int = 0,
    epoch: int = 0,
    drop_remainder: bool = True,
    num_workers: int = 8,
) -> Iterator[tuple[RawBatch, int]]:
    """Yields (host RawBatch, valid_count); the order of an epoch is a
    function of ``seed + epoch``."""
    n = len(ds)
    order = np.arange(n)
    if shuffle:
        order = np.random.RandomState(seed + epoch).permutation(n)
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        for start in range(0, n, batch_size):
            idxs = order[start:start + batch_size]
            if len(idxs) < batch_size:
                if drop_remainder:
                    return
                yield _assemble(ds, idxs, pool, pad_to=batch_size)
                return
            yield _assemble(ds, idxs, pool)


def to_device(batch, device):
    """Copy a host batch (a ``RawBatch``, or another named tuple of numpy
    arrays) to ``device``, as the same named tuple of tensors: through
    pinned memory and a ``non_blocking`` copy for a CUDA device (the copy
    overlaps work already queued on the stream)."""
    device = torch.device(device)
    if device.type != "cuda":
        return type(batch)(*(torch.from_numpy(np.ascontiguousarray(a))
                             .to(device) for a in batch))
    return type(batch)(*(torch.from_numpy(np.ascontiguousarray(a))
                         .pin_memory().to(device, non_blocking=True)
                         for a in batch))


_DONE = object()  # the producer's last item


def device_prefetch(host_iter: Iterator[tuple[RawBatch, int]],
                    put: Callable[[RawBatch], RawBatch],
                    depth: int = 2) -> Iterator[tuple[RawBatch, int]]:
    """Yield ``(put(batch), valid)`` for each item of ``host_iter``, in
    order, with up to ``depth`` batches assembled and copied ahead of the
    consumer (the JAX package's ``device_prefetch``, ``pipeline.py:97-126``;
    the reference's prefetcher, ``datasets/utils.py:18,39-41,86-88``).

    A daemon thread draws the host batches and calls ``put`` (such as
    ``to_device``, which stages the batch in pinned memory and copies it
    ``non_blocking``). Where CUDA is available it does so on a side stream
    of its own and records an event after each batch; the consumer's
    current stream waits for that event before the batch is handed over,
    and each device tensor is marked as used by that stream
    (``record_stream``), so the caching allocator does not hand its memory
    to the side stream while a step still reads it. A CPU batch is a plain
    copy. An error in the producer is raised in the consumer. Closing the
    generator (the consumer stopped early) stops the producer: it never
    blocks on a full queue, and it closes ``host_iter``."""
    side = torch.cuda.Stream() if torch.cuda.is_available() else None
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    err: list[BaseException] = []

    def offer(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for batch, valid in host_iter:
                if side is None:
                    item = (put(batch), valid, None)
                else:
                    with torch.cuda.stream(side):
                        dev = put(batch)
                        event = torch.cuda.Event()
                        event.record(side)
                    item = (dev, valid, event)
                if not offer(item):
                    return
        except BaseException as e:  # re-raised in the consumer
            err.append(e)
        finally:
            close = getattr(host_iter, "close", None)
            if close is not None:
                close()
            offer(_DONE)

    thread = threading.Thread(target=produce, daemon=True,
                              name="device_prefetch")
    thread.start()
    try:
        while True:
            with span("capf.data.wait"):
                item = q.get()
                if item is not _DONE:
                    batch, valid, event = item
                    if event is not None:
                        stream = torch.cuda.current_stream()
                        stream.wait_event(event)
                        for t in batch:
                            if isinstance(t, torch.Tensor) and t.is_cuda:
                                t.record_stream(stream)
            if item is _DONE:
                if err:
                    raise err[0]
                return
            yield batch, valid
    finally:
        stop.set()
        thread.join()
