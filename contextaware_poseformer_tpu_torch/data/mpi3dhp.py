"""MPI-INF-3DHP dataset over the reference npz artifacts: the port's copy of
``contextaware_poseformer_tpu/data/mpi3dhp.py`` (it imports the port's own
``utils/geometry``, ``data/native_loader`` and ``data/frame_store``).

Consumes `data_train_3dhp.npz` / `data_test_3dhp.npz` exactly as produced by
ContextPose_mpi/dataset/data_util/data_to_npz_3dhp{,_test}.py and consumed by
Fusion/ChunkedGenerator (common/load_data_3dhp_mae.py:46-105,
common/generator_3dhp.py:6-236):

- train: data[seq][0][cam] -> {data_2d [px in 2048x2048], data_2d_crop
  [192x256 px], data_3d [univ mm]}; images pre-cropped on disk at
  s_{subj:02d}_seq_{seq:02d}_ca_{cam}/..._{frame+1:06d}.jpg
  (generator_3dhp.py:126-143; crops by convert_to_small.py:282-289);
- test: data[seq] -> {..., valid}; TS5/TS6 are 1920x1080, others 2048x2048
  (load_data_3dhp_mae.py:93-99); only valid frames are evaluated
  (generator_3dhp.py:45-48).

3D stays in UNIVERSAL MILLIMETERS with the root (joint 14) kept absolute in
storage but zeroed in every loss/metric (run_3dhp.py:66,109,118) — our
root_center(root=14) at batch-prep time is numerically equivalent.

TPU-first: sequences flattened into contiguous arrays + one path per frame.
The live model is single-frame (chunk_length=stride=1, pad=0), where chunking
degenerates to frame indexing; the reference's `-f > 1` window slicing
(generator_3dhp.py:41-59 pair building, :147-207 edge-padded 2D/3D windows)
is `window_pairs` + `window_indices` below — edge-padding a slice equals
gathering with CLIPPED indices, so a window is one fixed-shape gather into
the packed arrays (no per-item np.pad copies, jit/batch friendly).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from contextaware_poseformer_tpu_torch.utils.geometry import (
    normalize_screen_coordinates,
)

try:
    import cv2
except Exception:  # pragma: no cover
    cv2 = None


@dataclass
class Mpi3dhpDataset:
    root: str  # images root
    joints_3d: np.ndarray  # (N, 17, 3) float32 mm (univ), root-centered
    joints_2d: np.ndarray  # (N, 17, 2) float32 normalized full-frame GT
    joints_2d_crop: np.ndarray  # (N, 17, 2) float32 crop pixels
    image_paths: np.ndarray  # (N,)
    seq_idx: np.ndarray  # (N,) index into seq_names
    seq_names: tuple[str, ...]
    image_shape: tuple[int, int] = (256, 192)
    # kept for pipeline protocol compatibility (H36M action bucketing)
    action_idx: np.ndarray | None = None
    # per-frame validity aligned with the packed arrays; only set by
    # load_test(keep_invalid=True), which retains invalid frames so that
    # multi-frame test windows can gather 2D context across them exactly as
    # the reference does (generator_3dhp.py:46 filters chunk CENTERS only)
    valid_mask: np.ndarray | None = None
    # packed raw-frame store (data/frame_store.py): built in THIS dataset's
    # item order (same loader args), validated by length at open
    frame_store: np.ndarray | None = None
    store_idx: np.ndarray | None = None

    def __post_init__(self):
        if self.action_idx is None:
            self.action_idx = np.zeros(len(self.image_paths), np.int32)

    def __len__(self):
        return len(self.image_paths)

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
            "joints_3d", "joints_2d", "joints_2d_crop", "image_paths",
            "seq_idx", "action_idx", "store_idx",
        ):
            if getattr(self, name) is not None:
                setattr(self, name, getattr(self, name)[start:end])
        return dist_size

    def load_batch(self, idxs: np.ndarray) -> np.ndarray | None:
        """Whole-batch load: packed raw-frame store when configured (mmap
        fancy-index, zero decode), else native whole-batch decode (frames
        are pre-cropped on disk, convert_to_small.py:282-289); None ->
        per-item fallback."""
        if self.frame_store is not None:
            return np.ascontiguousarray(
                self.frame_store[self.store_idx[np.asarray(idxs)]]
            )
        from contextaware_poseformer_tpu_torch.data import native_loader

        if not native_loader.available():
            return None
        paths = [os.path.join(self.root, str(self.image_paths[i])) for i in idxs]
        return native_loader.load_crop_batch(
            paths, None, self.image_shape, precropped=True
        )

    def load_image(self, idx: int) -> np.ndarray:
        if self.frame_store is not None:
            return np.asarray(self.frame_store[int(self.store_idx[idx])])
        path = os.path.join(self.root, str(self.image_paths[idx]))
        img = cv2.imread(path, cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
        if img is None:
            raise FileNotFoundError(path)
        return img


def _center_3d(data_3d: np.ndarray) -> np.ndarray:
    """Root-center all joints except 14 (load_data_3dhp_mae.py:64-66,86-87);
    we also zero the root itself, matching what every consumer does at use."""
    out = data_3d.astype(np.float32).copy()
    root = out[:, 14:15].copy()
    out -= root
    out[:, 14] = 0.0
    return out


def _open_store(frame_store, image_shape, n: int):
    if not frame_store:
        return None, None
    from contextaware_poseformer_tpu_torch.data import frame_store as fs

    store = fs.open_store(frame_store, image_shape)
    if store.shape[0] != n:
        raise ValueError(
            f"frame store has {store.shape[0]} frames; dataset has {n} "
            "(build it with the same loader arguments)"
        )
    return store, np.arange(n, dtype=np.int64)


def load_train(npz_path: str, img_root: str,
               frame_store: str | None = None) -> Mpi3dhpDataset:
    data = np.load(npz_path, allow_pickle=True)["data"].item()
    j3, j2, j2c, paths, seqi, names = [], [], [], [], [], []
    for seq in sorted(data.keys()):
        subject_name, seq_name = seq.split(" ")
        for cam in sorted(data[seq][0].keys()):
            anim = data[seq][0][cam]
            n = anim["data_3d"].shape[0]
            j3.append(_center_3d(anim["data_3d"]))
            j2.append(
                normalize_screen_coordinates(
                    anim["data_2d"][..., :2].astype(np.float32), 2048, 2048
                ).astype(np.float32)
            )
            j2c.append(anim["data_2d_crop"][..., :2].astype(np.float32))
            # generator_3dhp.py:130-139: s_{subj}_seq_{seq}_ca_{cam}/..._{i+1}.jpg
            subdir = f"s_{int(subject_name[1]):02d}_seq_{int(seq_name[3]):02d}_ca_{int(cam):02d}"
            paths.extend(
                os.path.join(subdir, f"{subdir}_{i + 1:06d}.jpg")
                for i in range(n)
            )
            key = f"{subject_name} {seq_name} {cam}"
            names.append(key)
            seqi.extend([len(names) - 1] * n)
    store, store_idx = _open_store(frame_store, (256, 192), len(paths))
    return Mpi3dhpDataset(
        root=img_root,
        joints_3d=np.concatenate(j3),
        joints_2d=np.concatenate(j2),
        joints_2d_crop=np.concatenate(j2c),
        image_paths=np.asarray(paths),
        seq_idx=np.asarray(seqi, np.int32),
        seq_names=tuple(names),
        frame_store=store,
        store_idx=store_idx,
    )


def load_test(
    npz_path: str, img_root: str, *, keep_invalid: bool = False,
    frame_store: str | None = None,
) -> Mpi3dhpDataset:
    """Test split. keep_invalid=False (live single-frame path) drops invalid
    frames outright — identical to filtering chunk centers at frames=1.
    keep_invalid=True retains every frame (with `valid_mask` set) so that
    `make_windows(frames>1)` can gather 2D context across invalid neighbors
    exactly like the reference (generator_3dhp.py:46,147-161)."""
    data = np.load(npz_path, allow_pickle=True)["data"].item()
    j3, j2, j2c, paths, seqi, names, vmask = [], [], [], [], [], [], []
    for seq in sorted(data.keys()):  # TS1..TS6
        anim = data[seq]
        valid = np.asarray(anim["valid"]).astype(bool).reshape(-1)
        keep = np.ones_like(valid) if keep_invalid else valid
        w, h = (1920, 1080) if seq in ("TS5", "TS6") else (2048, 2048)
        j3.append(_center_3d(anim["data_3d"])[keep])
        j2.append(
            normalize_screen_coordinates(
                anim["data_2d"][..., :2].astype(np.float32), w, h
            ).astype(np.float32)[keep]
        )
        j2c.append(anim["data_2d_crop"][..., :2].astype(np.float32)[keep])
        frame_ids = np.nonzero(keep)[0]
        paths.extend(
            os.path.join(seq, f"{seq}_{i + 1:06d}.jpg") for i in frame_ids
        )
        names.append(seq)
        seqi.extend([len(names) - 1] * int(keep.sum()))
        vmask.append(valid[keep])
    return Mpi3dhpDataset(
        root=img_root,
        joints_3d=np.concatenate(j3),
        joints_2d=np.concatenate(j2),
        joints_2d_crop=np.concatenate(j2c),
        image_paths=np.asarray(paths),
        seq_idx=np.asarray(seqi, np.int32),
        seq_names=tuple(names),
        valid_mask=np.concatenate(vmask) if keep_invalid else None,
        **dict(zip(("frame_store", "store_idx"),
                   _open_store(frame_store, (256, 192), len(paths)))),
    )


def window_pairs(
    seq_lengths: Sequence[int],
    *,
    train: bool,
    chunk_length: int = 1,
    reverse_aug: bool = False,
    flip_aug: bool = False,
    valid_frames: Sequence[np.ndarray] | None = None,
) -> np.ndarray:
    """(seq_id, start, end, flip, reverse) chunk pairs, int32 (P, 5).

    Reproduces the reference pair construction exactly
    (generator_3dhp.py:19-63): train chunks tile each sequence with a
    centered offset `(n_chunks*chunk_length - T) // 2` (starts can be
    negative / ends past T — the window gather edge-pads); test chunks are
    single frames filtered by `valid_frame`. Augmented copies append in the
    reference's order: base, reverse, flip(+reverse).
    """
    pairs = []
    for sid, T in enumerate(seq_lengths):
        T = int(T)
        n_chunks = (T + chunk_length - 1) // chunk_length
        offset = (n_chunks * chunk_length - T) // 2
        if train:
            bounds = np.arange(n_chunks + 1) * chunk_length - offset
            lo, hi = bounds[:-1], bounds[1:]
        else:
            lo = np.arange(n_chunks) * chunk_length - offset
            if valid_frames is not None:
                mask = np.asarray(valid_frames[sid]).astype(bool).reshape(-1)
                lo = lo[mask]
            hi = lo + 1
        variants = [(False, False)]
        if reverse_aug:
            variants.append((False, True))
        if flip_aug:
            variants.append((True, True) if reverse_aug else (True, False))
        for flip, reverse in variants:
            block = np.empty((len(lo), 5), np.int32)
            block[:, 0] = sid
            block[:, 1] = lo
            block[:, 2] = hi
            block[:, 3] = int(flip)
            block[:, 4] = int(reverse)
            pairs.append(block)
    if not pairs:
        return np.zeros((0, 5), np.int32)
    return np.concatenate(pairs)


def window_indices(
    pair: np.ndarray,
    seq_length: int,
    *,
    pad: int = 0,
    causal_shift: int = 0,
    out_all: bool = True,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Per-pair (idx_2d, idx_2d_crop, idx_3d, image_frame) local indices.

    The reference edge-pads the slice `[start-pad-shift, end+pad-shift)`
    (generator_3dhp.py:147-207); clipping the index range to [0, T-1] is
    numerically identical and keeps the window a single fixed-shape gather.
    `out_all=True` (opt default) makes the 3D window equal the 2D window;
    otherwise 3D covers just [start, end). `reverse` flips batch_2d and
    batch_3d (:179-180,206-207) but NOT batch_2d_crop — the crop window
    stays forward in the reference, so idx_2d_crop is the unreversed
    idx_2d. The image is always the single frame at `start` (:140-141) —
    the model is single-frame even with temporal label windows.
    """
    _, start, end, _flip, reverse = (int(v) for v in pair)
    idx_2d = np.clip(
        np.arange(start - pad - causal_shift, end + pad - causal_shift),
        0, seq_length - 1,
    )
    idx_2d_crop = idx_2d
    if out_all:
        idx_3d = idx_2d.copy()
    else:
        idx_3d = np.clip(np.arange(start, end), 0, seq_length - 1)
    if reverse:
        idx_2d = idx_2d[::-1].copy()
        idx_3d = idx_3d[::-1].copy()
    return idx_2d, idx_2d_crop, idx_3d, int(np.clip(start, 0, seq_length - 1))


@dataclass
class Mpi3dhpWindows:
    """Multi-frame chunk view over a packed Mpi3dhpDataset (`-f > 1`).

    Each item is one reference chunk: edge-padded 2D/3D label windows of
    `chunk_length + 2*pad` / `chunk_length` frames plus the single image at
    the chunk start. Windows are gathers with clipped GLOBAL indices into
    the dataset's packed arrays (seq_starts offsets each sequence).
    """

    ds: Mpi3dhpDataset
    pairs: np.ndarray  # (P, 5) int32 from window_pairs
    seq_starts: np.ndarray  # (S,) global offset of each sequence
    seq_lengths: np.ndarray  # (S,)
    pad: int = 0
    causal_shift: int = 0
    out_all: bool = True

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, i: int) -> dict:
        pair = self.pairs[i]
        sid = int(pair[0])
        T = int(self.seq_lengths[sid])
        idx_2d, idx_2d_crop, idx_3d, img_frame = window_indices(
            pair, T, pad=self.pad, causal_shift=self.causal_shift,
            out_all=self.out_all,
        )
        base = int(self.seq_starts[sid])
        return {
            "seq_id": sid,
            "flip": bool(pair[3]),
            "joints_2d": self.ds.joints_2d[base + idx_2d],
            "joints_2d_crop": self.ds.joints_2d_crop[base + idx_2d_crop],
            "joints_3d": self.ds.joints_3d[base + idx_3d],
            "image_index": base + img_frame,
        }


def make_windows(
    ds: Mpi3dhpDataset,
    *,
    frames: int = 1,
    train: bool,
    chunk_length: int = 1,
    reverse_aug: bool = False,
    flip_aug: bool = False,
    out_all: bool = True,
) -> Mpi3dhpWindows:
    """Reference `-f` semantics: pad = (frames-1)//2 (opt.py:69); pairs and
    windows as generator_3dhp.py.

    Test-split validity: with `load_test(keep_invalid=False)` (the live
    frames=1 path) invalid frames are already dropped from the packed
    arrays, so every remaining frame is one chunk — identical to the
    reference's bounds[valid] filter at frames=1. For frames > 1 the
    reference gathers 2D context across INVALID neighbors too, so the
    dataset must retain them: build it with keep_invalid=True (then
    `valid_mask` filters chunk centers here)."""
    seq_ids = np.asarray(ds.seq_idx)
    n_seq = len(ds.seq_names)
    seq_lengths = np.bincount(seq_ids, minlength=n_seq)
    seq_starts = np.concatenate([[0], np.cumsum(seq_lengths)[:-1]])
    # packed arrays are sequence-contiguous by construction (load_train/
    # load_test append per sequence); guard the gather's precondition
    assert (np.sort(seq_ids) == seq_ids).all(), "seq_idx must be contiguous"
    valid_frames = None
    if not train:
        if ds.valid_mask is not None:
            valid_frames = [
                ds.valid_mask[s:s + n]
                for s, n in zip(seq_starts, seq_lengths)
            ]
        elif frames > 1:
            raise ValueError(
                "multi-frame test windows need the full sequences: build "
                "the dataset with load_test(..., keep_invalid=True)"
            )
    pairs = window_pairs(
        seq_lengths, train=train, chunk_length=chunk_length,
        reverse_aug=reverse_aug, flip_aug=flip_aug,
        valid_frames=valid_frames,
    )
    return Mpi3dhpWindows(
        ds=ds, pairs=pairs, seq_starts=seq_starts, seq_lengths=seq_lengths,
        pad=(frames - 1) // 2, out_all=out_all,
    )


def export_inference_mat(
    path: str,
    preds_mm: np.ndarray,  # (N, 17, 3) root-zeroed predictions in mm
    seq_idx: np.ndarray,
    seq_names: tuple[str, ...],
) -> None:
    """Write `inference_data.mat` in the layout the vendored MATLAB scripts
    expect: per-seq (3, 17, 1, nf) arrays (run_3dhp.py:123-148 transposes each
    (17,3) pose to (3,17) and stacks on the last axis)."""
    import scipy.io as scio

    out = {}
    for i, name in enumerate(seq_names):
        p = preds_mm[seq_idx == i]  # (nf, 17, 3)
        out[name] = np.ascontiguousarray(
            p.transpose(2, 1, 0)[:, :, None, :]
        )
    scio.savemat(path, out)
