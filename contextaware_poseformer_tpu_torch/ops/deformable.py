"""Multi-level bilinear point sampling (K1): CUDA kernel wrapper, plain
version and dispatcher.

Port of ``contextaware_poseformer_tpu/ops/deformable.py``:
``kernel_can_preproject`` (396-406), ``sample_points_multi`` /
``sample_project_points_multi`` and their ``_multi_fwd_impl`` (475-605,
874-894), and the ``sample_points_levels`` dispatcher (1210-1270).

The TPU kernel's one-hot/triangle matmul formulation, its batch chunking and
its VMEM level grouping are TPU workarounds and are not carried over: the
CUDA kernel (``csrc/sampler.cu``) gathers the four taps of each point and
covers every level of a call in one launch. An optional per-level projection
``W (C, hd)``, ``b (hd,)`` is fused as sample-then-project, which equals the
JAX package's sample(F @ W + b) only in border mode, where the bilinear
weights sum to one; both versions here refuse a projection in zeros mode.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from contextaware_poseformer_tpu_torch.ops import _build
from contextaware_poseformer_tpu_torch.ops.grid_sample import (
    sample_points_fp32,
)

launches = 0  # kernel launches made by sample_points_multi

MAX_LEVELS = 8
_TILE = 32  # points per block in csrc/sampler.cu


def kernel_can_preproject(h: int, w: int, c: int, hd: int) -> bool:
    """True when a level's embed_proj runs inside the sampler (C -> hd).

    The JAX version also excludes its separable two-stage levels unless a TPU
    switch is set; the CUDA kernel has one body for every level, so only the
    width condition is left: projecting pays when it narrows the samples."""
    del h, w
    return c > hd


def _per_level(values, levels):
    return (None,) * levels if values is None else tuple(values)


def _check_projection(padding_mode, projs, features):
    if any(p is not None for p in projs) and padding_mode != "border":
        raise ValueError(
            "a fused projection is exact only in border mode (the bilinear "
            "weights sum to 1 there); got padding_mode="
            f"{padding_mode!r}"
        )
    for f, p in zip(features, projs):
        if p is not None and (p.dim() != 2 or p.shape[0] != f.shape[-1]):
            raise ValueError(f"projection of shape {tuple(p.shape)} does not "
                             f"match {f.shape[-1]} channels")


def sample_points_multi_reference(
    features: Sequence[torch.Tensor],
    points: torch.Tensor,
    padding_mode: str = "zeros",
    align_corners: bool = True,
    projs=None,
    biases=None,
) -> tuple:
    """Plain version of ``sample_points_multi``: per-level gathers in fp32,
    then the optional projection in fp32, rounded once to the map dtype."""
    levels = len(features)
    projs = _per_level(projs, levels)
    biases = _per_level(biases, levels)
    _check_projection(padding_mode, projs, features)
    outs = []
    for l, f in enumerate(features):
        s = sample_points_fp32(f, points[:, l], padding_mode=padding_mode,
                               align_corners=align_corners)
        if projs[l] is not None:
            s = s @ projs[l].float()
            if biases[l] is not None:
                s = s + biases[l].float()
        outs.append(s.to(f.dtype))
    return tuple(outs)


class _Level(ctypes.Structure):
    _fields_ = [
        ("feat", ctypes.c_void_p),
        ("proj_w", ctypes.c_void_p),
        ("proj_b", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("h", ctypes.c_int),
        ("w", ctypes.c_int),
        ("c", ctypes.c_int),
        ("cout", ctypes.c_int),
    ]


class _Args(ctypes.Structure):
    _fields_ = [
        ("points", ctypes.c_void_p),
        ("levels", _Level * MAX_LEVELS),
        ("num_levels", ctypes.c_int),
        ("batch", ctypes.c_int),
        ("num_points", ctypes.c_int),
        ("border", ctypes.c_int),
        ("align_corners", ctypes.c_int),
        ("dtype", ctypes.c_int),
    ]


def _prepare(features, points, padding_mode, align_corners, projs, biases):
    """Validate a kernel call and lay out its arguments: returns (ctypes
    args, outputs, tensors the launch reads, output shapes)."""
    name = "sample_points_multi"
    levels = len(features)
    if not 1 <= levels <= MAX_LEVELS:
        raise ValueError(f"{name}: 1..{MAX_LEVELS} levels, got {levels}")
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"unsupported padding_mode: {padding_mode!r}")
    projs = _per_level(projs, levels)
    biases = _per_level(biases, levels)
    _check_projection(padding_mode, projs, features)
    dtype = features[0].dtype
    code = _build.dtype_code(name, dtype)
    b = features[0].shape[0]
    if points.shape[:2] != (b, levels) or points.shape[-1] != 2:
        raise ValueError(f"{name}: points {tuple(points.shape)} are not "
                         f"(batch={b}, levels={levels}, ..., 2)")
    batch_shape = points.shape[2:-1]
    pts = points.reshape(b, levels, -1, 2).float().contiguous()
    p = pts.shape[2]
    args = _Args(points=pts.data_ptr(), num_levels=levels, batch=b,
                 num_points=p, border=int(padding_mode == "border"),
                 align_corners=int(align_corners), dtype=code)
    outs, shapes, keep = [], [], [pts]
    for l, f in enumerate(features):
        if f.dim() != 4 or f.shape[0] != b or f.dtype != dtype:
            raise ValueError(f"{name}: level {l} is {tuple(f.shape)} "
                             f"{f.dtype}, expected (b={b}, H, W, C) {dtype}")
        _, h, w, c = f.shape
        vec = 16 // f.element_size()  # channels per 16-byte load
        if c % vec:
            raise ValueError(f"{name}: level {l} has {c} channels; the "
                             f"kernel needs a multiple of {vec}")
        cout = c
        lv = args.levels[l]
        if projs[l] is not None:
            wk = projs[l].float().contiguous()
            cout = wk.shape[1]
            if c * (cout + _TILE) * 4 > _build.SMEM_LIMIT:
                raise ValueError(f"{name}: level {l} projection {c}x{cout} "
                                 "does not fit in shared memory")
            if cout % 4:
                raise ValueError(f"{name}: level {l} projection to {cout} "
                                 "outputs; the kernel needs a multiple of 4")
            lv.proj_w = wk.data_ptr()
            keep.append(wk)
            if biases[l] is not None:
                bk = biases[l].float().contiguous()
                if bk.shape != (cout,):
                    raise ValueError(f"{name}: bias {tuple(bk.shape)} for "
                                     f"{cout} outputs")
                lv.proj_b = bk.data_ptr()
                keep.append(bk)
        out = torch.empty((b, p, cout), dtype=dtype, device=f.device)
        lv.feat, lv.out = f.data_ptr(), out.data_ptr()
        lv.h, lv.w, lv.c, lv.cout = h, w, c, cout
        outs.append(out)
        shapes.append((b, *batch_shape, cout))
        keep.append(f)
    return args, outs, keep, shapes


def sample_points_multi(
    features: Sequence[torch.Tensor],
    points: torch.Tensor,
    padding_mode: str = "zeros",
    align_corners: bool = True,
    projs=None,
    biases=None,
) -> tuple:
    """Sample L NHWC maps at per-level points in ONE CUDA kernel launch.

    features: L maps (b, H_l, W_l, C_l), all float32 or all bfloat16;
    points: (b, L, ..., 2) xy in [-1, 1]. Levels with ``projs[l]`` set
    return ``sample @ W + b`` (border mode only). Returns a tuple of
    (b, ..., C_l or hd) in the maps' dtype. Covers the JAX package's
    ``sample_points_multi`` and ``sample_project_points_multi``.
    """
    global launches
    args, outs, keep, shapes = _prepare(
        features, points, padding_mode, align_corners, projs, biases)
    _build.require_cuda("sample_points_multi", *keep)
    if any(ptr % 16 for lv in args.levels[:len(features)]
           for ptr in (lv.feat, lv.proj_w) if ptr):
        raise ValueError("sample_points_multi: maps and projection weights "
                         "must start on a 16-byte boundary (16-byte loads)")
    lib = _build.library()
    err = lib.capf_sample_levels(ctypes.addressof(args),
                                 *_build.launch_target(features[0]))
    _build.check(lib, err, "sample_points_multi")
    launches += 1
    return tuple(o.reshape(s) for o, s in zip(outs, shapes))


def sample_points_levels(
    features: Sequence[torch.Tensor],
    points: torch.Tensor,  # (b, L, ..., 2)
    padding_mode: str = "zeros",
    align_corners: bool = True,
    impl: str = "auto",
    projs=None,
    biases=None,
) -> tuple:
    """Level-set dispatcher. ``impl``: "auto" (the kernel for CUDA tensors,
    the plain version for CPU tensors), "fused" (the kernel) or "gather"
    (the plain version)."""
    if impl == "auto":
        impl = "gather" if features[0].device.type == "cpu" else "fused"
    if impl == "gather":
        return sample_points_multi_reference(
            features, points, padding_mode, align_corners, projs, biases)
    if impl == "fused":
        return sample_points_multi(
            features, points, padding_mode, align_corners, projs, biases)
    raise ValueError(f"unknown sampler impl: {impl!r}")
