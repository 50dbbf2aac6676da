"""Bilinear point sampling (K1, K5, K8), its backward (K6) and the deformable
aggregation (K7): CUDA kernel wrappers, plain versions, the autograd
Functions and the dispatchers.

Port of ``contextaware_poseformer_tpu/ops/deformable.py``: the single-level
``sample_points`` (233-362), ``kernel_can_preproject`` (396-406),
``sample_points_multi`` / ``sample_project_points_multi`` and their
``_multi_fwd_impl`` (475-605, 874-894), the custom VJPs ``_multi_bwd`` /
``_multi_proj_bwd`` with the Pallas backward ``_multi_bwd_pallas``
(617-645, 679-870, 907-925), ``deformable_aggregate`` with
``aggregate_reference`` (947-1162), and the ``sample_points_levels``
dispatcher (1210-1270).

The TPU kernel's one-hot/triangle matmul formulation, its batch chunking and
its VMEM level grouping are TPU workarounds and are not carried over: the
CUDA kernel (``csrc/sampler.cu``) gathers the four taps of each point and
covers every level of a call in one launch. Its grid is one flat list of
work units: each level's points, flattened over (item, point), cut into
units of that level's own size (``sampler_plan``): 64 points for the
tensor-core projection, 32 for the fp32 projection (its own build of 64
threads a block, which walks K-slices of 32 channels through a ring in
shared memory), and for the gather enough 16-byte channel groups that each
thread blends 4, at most one item's points; the units of the widest
levels run first. K5, the
TPU kernel's separable two-stage body for large maps with few channels
(``is_k5_level``: HRNet's 64x48 level 0 with C = 32 or 48), exists only to
fill the TPU's 128 output lanes; the gather reads each point's four taps
whatever C is, so K5's port is the same CUDA kernel at those shapes (W32's
unprojected level 0 in 256-point gather units), counted apart in
``launches_k5``.
K8, the single-level sampler behind ``sample_points`` (the TPU's one-stage
and two-stage bodies alike), is the same kernel launched with one level,
counted apart in ``launches_k8``.
An optional per-level projection ``W (C, hd)``, ``b (hd,)`` is fused as
sample-then-project, which equals the JAX package's sample(F @ W + b) only
in border mode, where the bilinear weights sum to one; both versions here
refuse a projection in zeros mode.

int8 maps hold raw quantized numbers (the caller owns the dequant scale):
the plain versions return their samples in float32, as the JAX gather
does, and the kernel (K1, K8) in bf16, as the TPU kernel does
(``deformable.py:555-561``). An int8 level's fused projection takes the
dequant scale as ``scales[l]`` (the lifter's ``feat_scales``), which
multiplies the projection before the bias: the JAX package hands its
kernel W * scale instead. The plain version blends in fp32, projects in
fp32 with W * scale and rounds once (to float32 for int8 maps). The
kernel's projection on bf16 and int8 maps runs on the tensor cores: the
fp32 blend and W are rounded to bf16 and the products accumulate in fp32,
as the JAX kernel projects at DEFAULT precision
(``deformable.py:453-462``), then the scale and the bias in fp32. W
reaches it as bf16 W^T made once per parameter state (``kernel_weight``),
so no call gains a launch. Its fp32 body projects in fp32.

K7 (``csrc/aggregate.cu``) samples every level, weights and sums a head's
ns samples and projects the pooled row once with the level's W (C_l, hd)
plus (sum of the weights) * b, in one launch: sum_s w_s (x_s W + b) =
(sum_s w_s x_s) W + (sum_s w_s) b, in both padding modes (the weights need
not sum to one). Rows are flattened over items in tiles of 64
(``aggregate_plan``); bf16 maps project the pooled rows, rounded once to
bf16, on the tensor cores, fp32 maps on CUDA cores. Its backward is the
plain version's VJP, as the JAX ``_aggregate_bwd`` takes.

Gradients: every sampler call where an input requires grad goes through
``_SampleLevels``, whose forward is K1 (the plain forward for CPU tensors)
and whose backward is K6 (``csrc/sampler_bwd.cu``; the plain backward for
CPU tensors), or, with fused projections, the plain version's VJP as the
JAX ``_multi_proj_bwd`` takes. The map gradient dF is computed only when a
map requires grad; with the frozen backbone it never does.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Sequence

import torch

from contextaware_poseformer_tpu_torch.ops import _build
from contextaware_poseformer_tpu_torch.ops.grid_sample import (
    _unnormalize,
    grid_sample_points,
    sample_dtype,
    sample_points_fp32,
)

launches = 0  # K1 launches (sample_points_multi)
launches_k5 = 0  # K1 launches that sample a K5 level (is_k5_level)
launches_bwd = 0  # K6 launches (sample_points_multi_backward)
launches_k7 = 0  # K7 launches (deformable_aggregate_kernel)
launches_k8 = 0  # K8 launches: the sampler kernel for sample_points

MAX_LEVELS = 8
# csrc/sampler.cu: points a unit of the fp32 projection, of the tensor-core
# projection (bf16 and int8 maps) and at most of the gather; its most
# outputs, the bf16 padding of a shared-memory row, a block's threads, the
# items a gather thread blends, a point's tap rows and weights in bytes
_TILE, _CHUNK, _MAX_POINTS = 32, 64, 256
_MAX_COUT, _PAD, _THREADS, _ITEMS, _TAP_BYTES = 64, 8, 256, 4, 32
# the fp32 projected build (kF32*): threads a block, channels a K-slice,
# outputs a pass, floats a staged sample row; its ring of two slots of
# blends and W rows, in bytes (kF32RingBytes)
_F32_THREADS, _F32_SLICE, _F32_COLS = 64, 32, 32
_F32_PITCH = _F32_SLICE + 4
_F32_RING = 2 * (_TILE * _F32_PITCH + _F32_SLICE * _F32_COLS) * 4
_SAMPLER_DTYPES = (torch.float32, torch.bfloat16, torch.int8)


def gather_points(dtype: torch.dtype, c: int, points: int,
                  threads: int = _THREADS) -> int:
    """Points a gather unit of the sampler takes at C channels, ``points``
    a level and item: enough 16-byte (point, channel group) items that each
    of the block's ``threads`` threads blends 4 (bf16 on 256 threads: 256
    points at C = 32, 170 at C = 48, 32 at C = 256), at most 256 points and
    at most one item's: a 17-point call keeps a unit an item (measured on
    the card against units of 1, 2 and 4 items a thread across items:
    PERF.md). A call that projects an fp32 level runs its gather levels in
    the fp32 projected build's 64-thread blocks."""
    groups = c * dtype.itemsize // 16
    return max(1, min(_MAX_POINTS, threads * _ITEMS // groups, points))


def _projection_refusal(dtype: torch.dtype, c: int, cout: int) -> str | None:
    """Why no projected body of the sampler takes a C -> Cout projection of
    ``dtype`` maps, or None when one does (see ``projected_plan``)."""
    if dtype == torch.float32:
        if c % 4 or cout % 4:
            return (f"the fp32 projection needs C and Cout divisible by 4, "
                    f"got {c} -> {cout}")
    elif c % 16 or cout % 8 or cout > _MAX_COUT:
        return (f"the tensor-core projection needs C divisible by 16 and "
                f"Cout by 8, at most {_MAX_COUT}; got {c} -> {cout}")
    if _projection_smem(dtype, c, cout) > _build.SMEM_LIMIT:
        return f"projection {c}x{cout} does not fit in shared memory"
    return None


def _projection_smem(dtype: torch.dtype, c: int, cout: int) -> int:
    if dtype == torch.float32:  # the ring does not grow with C or Cout
        return _TAP_BYTES * _TILE + _F32_RING
    return (_TAP_BYTES * _CHUNK + 2 * _CHUNK * (max(c, cout) + _PAD)
            + 2 * cout * (c + _PAD))


def projected_plan(dtype: torch.dtype, c: int, cout: int,
                   points: int) -> tuple[int, int]:
    """(units, shared memory bytes a unit) of a level the sampler projects
    from C to Cout channels, ``points`` points in all. bf16 and int8 maps
    take the tensor-core body (64 points a unit: their taps, the bf16 A
    tile, which later stages the output, and W^T in bf16): C a multiple of
    16, Cout of 8, at most 64. fp32 maps take the CUDA-core body (32
    points a unit: their taps, then a two-slot ring of 32-channel slices of
    the blends and of W's rows, 18 KB whatever C and Cout): C and Cout
    multiples of 4. Raises ValueError for a level neither takes."""
    refusal = _projection_refusal(dtype, c, cout)
    if refusal:
        raise ValueError(f"sample_points_multi: {refusal}")
    size = _TILE if dtype == torch.float32 else _CHUNK
    return -(-points // size), _projection_smem(dtype, c, cout)


@dataclass(frozen=True)
class SamplerPlan:
    """One launch of the sampler: per level its body ("gather", "tc": the
    tensor-core projection, "fp32": the fp32 projection), the points a unit
    takes and the units; the dynamic shared memory every block reserves
    (the largest level's); whether the build with the tensor-core body is
    launched; and the order in which the levels' units fill the grid: most
    work a unit (points x channels) first, ties in level order; and the
    launch's threads a block (64 in the fp32 projected build, else 256).
    The kernel takes the units, the order and ``unit_end`` from here."""
    bodies: tuple[str, ...]
    unit_points: tuple[int, ...]
    units: tuple[int, ...]
    smem: int
    tensor_cores: bool
    order: tuple[int, ...]
    threads: int = _THREADS

    @property
    def blocks(self) -> int:
        return sum(self.units)

    @property
    def unit_end(self) -> tuple[int, ...]:
        """The units of the first i + 1 levels in ``order``."""
        ends, total = [], 0
        for l in self.order:
            total += self.units[l]
            ends.append(total)
        return tuple(ends)


def sampler_plan(dtype: torch.dtype, levels, batch: int,
                 points: int) -> SamplerPlan:
    """The plan of a sampler call, which ``csrc/sampler.cu``'s host entry
    checks: ``levels`` per level (C, Cout or None without a projection);
    ``points`` a level and item. Raises ValueError for a level no body
    takes."""
    if dtype not in _SAMPLER_DTYPES:
        raise TypeError(f"sample_points_multi: no sampler body for {dtype}")
    total = batch * points
    if not levels or batch < 1 or points < 1:
        raise ValueError("sample_points_multi: an empty call")
    bodies, sizes, units, smem = [], [], [], 0
    # the build the call launches: a call that projects an fp32 level runs
    # every level in the fp32 projected build's blocks
    threads = (_F32_THREADS if dtype == torch.float32
               and any(cout is not None for _, cout in levels) else _THREADS)
    for c, cout in levels:
        vec = 16 // dtype.itemsize
        if c < vec or c % vec:
            raise ValueError(f"sample_points_multi: {c} channels; the kernel "
                             f"needs a multiple of {vec}")
        if cout is None:
            body, size = "gather", gather_points(dtype, c, points, threads)
            need = _TAP_BYTES * size
        else:
            body = "fp32" if dtype == torch.float32 else "tc"
            size = _TILE if body == "fp32" else _CHUNK
            need = projected_plan(dtype, c, cout, total)[1]
        bodies.append(body)
        sizes.append(size)
        units.append(-(-total // size))
        smem = max(smem, need)
    order = sorted(range(len(levels)), key=lambda l: -sizes[l] * levels[l][0])
    return SamplerPlan(tuple(bodies), tuple(sizes), tuple(units), smem,
                       "tc" in bodies, tuple(order), threads)


def kernel_weight(w: torch.Tensor) -> torch.Tensor:
    """The bf16 W^T (Cout, C) of a projection W (C, Cout) that the
    tensor-core bodies of K1 and K7 read, made once per parameter state
    (``_build.cached_operand``)."""
    return _build.cached_operand(
        w, "sampler_wt", lambda t: t.t().to(torch.bfloat16).contiguous())


def kernel_can_preproject(h: int, w: int, c: int, hd: int,
                          dtype: torch.dtype) -> bool:
    """True when a level's embed_proj runs inside the sampler (C -> hd) on
    ``dtype`` maps: the projection narrows the samples (C > hd) and a
    projected body of the kernel takes it (``projected_plan``); otherwise
    the lifter projects the gathered samples.

    The JAX version also excludes its separable two-stage levels unless a TPU
    switch is set; the CUDA kernel has one body for every level, so that
    condition does not carry over."""
    del h, w
    return c > hd and _projection_refusal(dtype, c, hd) is None


def is_k5_level(h: int, w: int, c: int) -> bool:
    """True for a level the TPU sampler takes through its two-stage body
    (K5; JAX ``_use_two_stage``): H*W >= 1024 and C < 64."""
    return h * w >= 1024 and c < 64


def _per_level(values, levels):
    return (None,) * levels if values is None else tuple(values)


def _check_projection(padding_mode, projs, features, scales):
    if any(p is not None for p in projs) and padding_mode != "border":
        raise ValueError(
            "a fused projection is exact only in border mode (the bilinear "
            "weights sum to 1 there); got padding_mode="
            f"{padding_mode!r}"
        )
    for f, p, s in zip(features, projs, scales):
        if p is not None and (p.dim() != 2 or p.shape[0] != f.shape[-1]):
            raise ValueError(f"projection of shape {tuple(p.shape)} does not "
                             f"match {f.shape[-1]} channels")
        if s is not None and (p is None or not torch.is_tensor(s)
                              or s.numel() != 1):
            raise ValueError("a scale is a one-element tensor that "
                             "multiplies a projected level's product")


def sample_points_multi_reference(
    features: Sequence[torch.Tensor],
    points: torch.Tensor,
    padding_mode: str = "zeros",
    align_corners: bool = True,
    projs=None,
    biases=None,
    scales=None,
) -> tuple:
    """Plain version of ``sample_points_multi``: per-level gathers in fp32,
    then the optional projection in fp32 (by W * scale), rounded once to the
    map dtype (int8 maps: float32 samples)."""
    levels = len(features)
    projs = _per_level(projs, levels)
    biases = _per_level(biases, levels)
    scales = _per_level(scales, levels)
    _check_projection(padding_mode, projs, features, scales)
    outs = []
    for l, f in enumerate(features):
        s = sample_points_fp32(f, points[:, l], padding_mode=padding_mode,
                               align_corners=align_corners)
        if projs[l] is not None:
            w = projs[l] if scales[l] is None else projs[l] * scales[l]
            s = s @ w.float()
            if biases[l] is not None:
                s = s + biases[l].float()
        outs.append(s.to(sample_dtype(f.dtype)))
    return tuple(outs)


class _Level(ctypes.Structure):
    _fields_ = [
        ("feat", ctypes.c_void_p),
        ("proj_w", ctypes.c_void_p),
        ("proj_b", ctypes.c_void_p),
        ("proj_scale", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("h", ctypes.c_int),
        ("w", ctypes.c_int),
        ("c", ctypes.c_int),
        ("cout", ctypes.c_int),
        ("unit_points", ctypes.c_int),
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
        # the levels in the order their units run, and the units of the
        # first i + 1 of them (``SamplerPlan``)
        ("order", ctypes.c_int * MAX_LEVELS),
        ("unit_end", ctypes.c_int * MAX_LEVELS),
    ]


def _check_levels(name, features, points, padding_mode):
    levels = len(features)
    if not 1 <= levels <= MAX_LEVELS:
        raise ValueError(f"{name}: 1..{MAX_LEVELS} levels, got {levels}")
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"unsupported padding_mode: {padding_mode!r}")
    b = features[0].shape[0]
    if points.shape[:2] != (b, levels) or points.shape[-1] != 2:
        raise ValueError(f"{name}: points {tuple(points.shape)} are not "
                         f"(batch={b}, levels={levels}, ..., 2)")
    return points.reshape(b, levels, -1, 2).float().contiguous()


def _prepare(features, points, padding_mode, align_corners, projs, biases,
             scales):
    """Validate a kernel call and lay out its arguments: returns (ctypes
    args, outputs, tensors the launch reads, output shapes)."""
    name = "sample_points_multi"
    pts = _check_levels(name, features, points, padding_mode)
    b, levels, p, _ = pts.shape
    projs = _per_level(projs, levels)
    biases = _per_level(biases, levels)
    scales = _per_level(scales, levels)
    _check_projection(padding_mode, projs, features, scales)
    dtype = features[0].dtype
    code = _build.dtype_code(name, dtype, _SAMPLER_DTYPES)
    out_dtype = torch.bfloat16 if dtype == torch.int8 else dtype
    batch_shape = points.shape[2:-1]
    args = _Args(points=pts.data_ptr(), num_levels=levels, batch=b,
                 num_points=p, border=int(padding_mode == "border"),
                 align_corners=int(align_corners), dtype=code)
    outs, shapes, keep, spec = [], [], [pts], []
    for l, f in enumerate(features):
        if f.dim() != 4 or f.shape[0] != b or f.dtype != dtype:
            raise ValueError(f"{name}: level {l} is {tuple(f.shape)} "
                             f"{f.dtype}, expected (b={b}, H, W, C) {dtype}")
        _, h, w, c = f.shape
        cout, lv = c, args.levels[l]
        if projs[l] is not None:
            cout = projs[l].shape[1]
            # the tensor-core body reads W as bf16 W^T, made once per
            # parameter state; the fp32 body W in fp32
            wk = (projs[l].float().contiguous() if dtype == torch.float32
                  else kernel_weight(projs[l]))
            lv.proj_w = wk.data_ptr()
            keep.append(wk)
            if scales[l] is not None:
                sk = scales[l].float().reshape(1).contiguous()
                lv.proj_scale = sk.data_ptr()
                keep.append(sk)
            if biases[l] is not None:
                bk = biases[l].float().contiguous()
                if bk.shape != (cout,):
                    raise ValueError(f"{name}: bias {tuple(bk.shape)} for "
                                     f"{cout} outputs")
                lv.proj_b = bk.data_ptr()
                keep.append(bk)
        spec.append((c, None if projs[l] is None else cout))
        out = torch.empty((b, p, cout), dtype=out_dtype, device=f.device)
        lv.feat, lv.out = f.data_ptr(), out.data_ptr()
        lv.h, lv.w, lv.c, lv.cout = h, w, c, cout
        outs.append(out)
        shapes.append((b, *batch_shape, cout))
        keep.append(f)
    plan = sampler_plan(dtype, spec, b, p)
    for lv, size in zip(args.levels, plan.unit_points):
        lv.unit_points = size
    for i, (l, end) in enumerate(zip(plan.order, plan.unit_end)):
        args.order[i], args.unit_end[i] = l, end
    return args, outs, keep, shapes


def _launch_forward(features, points, padding_mode, align_corners, projs,
                    biases, scales=None, k8=False) -> tuple:
    """One launch of the sampler kernel (no autograd): K1, where a launch
    with a K5 level counts for K5 as well, or, with ``k8``, K8 (one
    level)."""
    global launches, launches_k5, launches_k8
    args, outs, keep, shapes = _prepare(
        features, points, padding_mode, align_corners, projs, biases, scales)
    _build.require_cuda("sample_points_multi", *keep)
    if any(ptr % 16 for lv in args.levels[:len(features)]
           for ptr in (lv.feat, lv.proj_w) if ptr):
        raise ValueError("sample_points_multi: maps and projection weights "
                         "must start on a 16-byte boundary (16-byte loads)")
    lib = _build.library()
    err = lib.capf_sample_levels(ctypes.addressof(args),
                                 *_build.launch_target(features[0]))
    _build.check(lib, err, "sample_points_multi")
    if k8:
        launches_k8 += 1
    else:
        launches += 1
        launches_k5 += any(is_k5_level(*f.shape[1:]) for f in features)
    return tuple(o.reshape(s) for o, s in zip(outs, shapes))


class _BwdLevel(ctypes.Structure):
    _fields_ = [
        ("feat", ctypes.c_void_p),
        ("grad", ctypes.c_void_p),
        ("dfeat", ctypes.c_void_p),
        ("h", ctypes.c_int),
        ("w", ctypes.c_int),
        ("c", ctypes.c_int),
    ]


class _BwdArgs(ctypes.Structure):
    _fields_ = [
        ("points", ctypes.c_void_p),
        ("dpoints", ctypes.c_void_p),
        ("levels", _BwdLevel * MAX_LEVELS),
        ("num_levels", ctypes.c_int),
        ("batch", ctypes.c_int),
        ("num_points", ctypes.c_int),
        ("border", ctypes.c_int),
        ("align_corners", ctypes.c_int),
        ("dtype", ctypes.c_int),
    ]


def _clip_grad(v: torch.Tensor, top: float) -> torch.Tensor:
    """Gradient of ``jnp.clip(v, 0, top)``: 1 inside, 0 outside, 0.5 at an
    exact edge (``deformable.py:697-703``)."""
    up = 0.5 * ((v < top).float() + (v <= top).float())
    lo = 0.5 * ((v > 0).float() + (v >= 0).float())
    return up * lo


def _level_backward(f, pts, g, padding_mode, align_corners, need_dfeatures):
    """One level of the plain backward: f (b, H, W, C), pts (b, P, 2) fp32,
    g (b, P, C) -> (dF fp32 or None, d(points) (b, P, 2) fp32)."""
    n, h, w, c = f.shape
    flat = f.reshape(n, h * w, c).float()
    g = g.reshape(n, -1, c).float()
    x = _unnormalize(pts[..., 0], w, align_corners)
    y = _unnormalize(pts[..., 1], h, align_corners)
    sx = 0.5 * (w - 1) if align_corners else 0.5 * w
    sy = 0.5 * (h - 1) if align_corners else 0.5 * h
    if padding_mode == "border":
        mx, my = _clip_grad(x, w - 1), _clip_grad(y, h - 1)
        x, y = x.clamp(0.0, w - 1), y.clamp(0.0, h - 1)
    else:
        mx = my = 1.0
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    x0i, y0i = x0.long(), y0.long()
    # taps 00, 01, 10, 11; a tap outside the map reads zeros
    taps = ((y0i, x0i), (y0i, x0i + 1), (y0i + 1, x0i), (y0i + 1, x0i + 1))
    weights = ((1 - wy) * (1 - wx), (1 - wy) * wx, wy * (1 - wx), wy * wx)
    vals, index, inside = [], [], []
    for yi, xi in taps:
        ins = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1))[..., None]
        idx = idx.expand(-1, -1, c)
        vals.append(torch.gather(flat, 1, idx) * ins[..., None])
        index.append(idx)
        inside.append(ins)
    f00, f01, f10, f11 = vals
    gx = (1 - wy)[..., None] * (f01 - f00) + wy[..., None] * (f11 - f10)
    gy = (1 - wx)[..., None] * (f10 - f00) + wx[..., None] * (f11 - f01)
    dpts = torch.stack([(g * gx).sum(-1) * (sx * mx),
                        (g * gy).sum(-1) * (sy * my)], dim=-1)
    if not need_dfeatures:
        return None, dpts
    dflat = torch.zeros_like(flat)
    for idx, wk, ins in zip(index, weights, inside):
        dflat.scatter_add_(1, idx, g * torch.where(ins, wk, 0.0)[..., None])
    return dflat.reshape(n, h, w, c), dpts


def sample_points_multi_backward_reference(
    features: Sequence[torch.Tensor],
    points: torch.Tensor,
    grads: Sequence[torch.Tensor],
    padding_mode: str = "zeros",
    align_corners: bool = True,
    need_dfeatures: bool = True,
) -> tuple:
    """Plain version of the sampler backward (the contract of the JAX
    ``_sample_bwd_body``, ``deformable.py:679-751``), without projections.

    grads: per level the upstream gradient (b, ..., C_l) of the samples.
    Returns (dF, d(points)): dF is a tuple of (b, H_l, W_l, C_l) in the
    maps' dtype, g scattered onto the four taps with the bilinear weights
    (None unless ``need_dfeatures``); d(points) is (b, L, ..., 2) in the
    points' dtype: per point the sum over C of g times the tap differences,
    times ``0.5 * (size - 1)`` (align_corners) or ``0.5 * size``, times the
    0.5 tie mask of the border clamp. Out-of-map taps contribute zero.
    Computed in fp32, rounded once at the end."""
    pts = _check_levels("sample_points_multi_backward", features, points,
                        padding_mode)
    dfs, dpts = [], []
    for l, (f, g) in enumerate(zip(features, grads)):
        df, dp = _level_backward(f, pts[:, l], g, padding_mode,
                                 align_corners, need_dfeatures)
        dfs.append(None if df is None else df.to(f.dtype))
        dpts.append(dp)
    dpoints = torch.stack(dpts, dim=1).reshape(points.shape).to(points.dtype)
    return (tuple(dfs) if need_dfeatures else None), dpoints


def sample_points_multi_backward(
    features: Sequence[torch.Tensor],
    points: torch.Tensor,
    grads: Sequence[torch.Tensor],
    padding_mode: str = "zeros",
    align_corners: bool = True,
    need_dfeatures: bool = True,
) -> tuple:
    """K6: the sampler backward in ONE CUDA kernel launch for every level.
    Same contract as ``sample_points_multi_backward_reference``; dF is
    accumulated in fp32 with atomics and cast to the maps' dtype."""
    global launches_bwd
    name = "sample_points_multi_backward"
    pts = _check_levels(name, features, points, padding_mode)
    dtype = features[0].dtype
    code = _build.dtype_code(name, dtype)
    b, levels, p, _ = pts.shape
    dpts = torch.empty_like(pts)
    args = _BwdArgs(points=pts.data_ptr(), dpoints=dpts.data_ptr(),
                    num_levels=levels, batch=b, num_points=p,
                    border=int(padding_mode == "border"),
                    align_corners=int(align_corners), dtype=code)
    keep, dfs = [pts, dpts], []
    for l, (f, g) in enumerate(zip(features, grads)):
        if f.dim() != 4 or f.shape[0] != b or f.dtype != dtype:
            raise ValueError(f"{name}: level {l} is {tuple(f.shape)} "
                             f"{f.dtype}, expected (b={b}, H, W, C) {dtype}")
        _, h, w, c = f.shape
        if c % (16 // f.element_size()):
            raise ValueError(f"{name}: level {l} has {c} channels; the "
                             f"kernel needs a multiple of "
                             f"{16 // f.element_size()}")
        if g.numel() != b * p * c:
            raise ValueError(f"{name}: level {l} gradient of shape "
                             f"{tuple(g.shape)} for {b}x{p} points of {c}")
        gl = g.reshape(b, p, c).to(dtype).contiguous()
        lv = args.levels[l]
        lv.feat, lv.grad, lv.h, lv.w, lv.c = (f.data_ptr(), gl.data_ptr(),
                                              h, w, c)
        keep += [f, gl]
        if need_dfeatures:
            df = torch.zeros(f.shape, dtype=torch.float32, device=f.device)
            lv.dfeat = df.data_ptr()
            keep.append(df)
            dfs.append(df)
    _build.require_cuda(name, *keep)
    if any(ptr % 16 for lv in args.levels[:levels]
           for ptr in (lv.feat, lv.grad)):
        raise ValueError(f"{name}: maps and gradients must start on a "
                         "16-byte boundary (16-byte loads)")
    lib = _build.library()
    err = lib.capf_sample_levels_bwd(ctypes.addressof(args),
                                     *_build.launch_target(features[0]))
    _build.check(lib, err, name)
    launches_bwd += 1
    dpoints = dpts.reshape(points.shape).to(points.dtype)
    if not need_dfeatures:
        return None, dpoints
    return tuple(d.to(f.dtype) for d, f in zip(dfs, features)), dpoints


class _SampleLevels(torch.autograd.Function):
    """The sampler under autograd. ``spec`` = (padding_mode, align_corners,
    kernel): ``kernel`` "K1" or "K8" selects that kernel's forward and K6
    (CUDA tensors), None the plain forward and backward (CPU tensors).
    ``tensors`` = maps, projections, biases, scales (L each; projections,
    biases and scales may be None)."""

    @staticmethod
    def forward(ctx, spec, points, *tensors):
        padding_mode, align_corners, kernel = spec
        n = len(tensors) // 4
        args = (tensors[:n], points, padding_mode, align_corners,
                tensors[n:2 * n], tensors[2 * n:3 * n], tensors[3 * n:])
        outs = (_launch_forward(*args, k8=kernel == "K8") if kernel
                else sample_points_multi_reference(*args))
        ctx.spec = spec
        ctx.save_for_backward(points, *tensors)
        return outs

    @staticmethod
    def backward(ctx, *grads):
        padding_mode, align_corners, kernel = ctx.spec
        points, *tensors = ctx.saved_tensors
        n = len(tensors) // 4
        features, projs = tensors[:n], tensors[n:2 * n]
        needs = ctx.needs_input_grad[1:]  # points, then tensors
        if any(p is not None for p in projs):
            return (None, *_projected_vjp(
                points, tensors, grads, needs, padding_mode, align_corners))
        batch_shape = points.shape[2:-1]
        grads = [torch.zeros((points.shape[0], *batch_shape, f.shape[-1]),
                             dtype=f.dtype, device=f.device)
                 if g is None else g for g, f in zip(grads, features)]
        need_df = any(needs[1:1 + n])
        run = (sample_points_multi_backward if kernel
               else sample_points_multi_backward_reference)
        dfs, dpoints = run(features, points, grads, padding_mode,
                           align_corners, need_df)
        dfs = [None] * n if dfs is None else list(dfs)
        return (None, dpoints if needs[0] else None,
                *(d if need else None for d, need in zip(dfs, needs[1:])),
                *(None,) * (3 * n))


def _projected_vjp(points, tensors, grads, needs, padding_mode,
                   align_corners):
    """The plain version's VJP with fused projections (JAX
    ``_multi_proj_bwd``): recompute ``sample_points_multi_reference`` under
    autograd and differentiate it."""
    n = len(tensors) // 4
    ins = [t if t is None else t.detach().requires_grad_(need)
           for t, need in zip((points, *tensors), needs)]
    wrt = [i for i, t in enumerate(ins) if t is not None and t.requires_grad]
    with torch.enable_grad():
        outs = sample_points_multi_reference(
            ins[1:1 + n], ins[0], padding_mode, align_corners,
            ins[1 + n:1 + 2 * n], ins[1 + 2 * n:1 + 3 * n], ins[1 + 3 * n:])
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
        found = torch.autograd.grad(
            [o for o, _ in pairs], [ins[i] for i in wrt],
            [g for _, g in pairs], allow_unused=True)
    result = [None] * len(ins)
    for i, g in zip(wrt, found):
        result[i] = g
    return result


def sample_points_multi(
    features: Sequence[torch.Tensor],
    points: torch.Tensor,
    padding_mode: str = "zeros",
    align_corners: bool = True,
    projs=None,
    biases=None,
    scales=None,
) -> tuple:
    """Sample L NHWC maps at per-level points in ONE CUDA kernel launch (K1).

    features: L maps (b, H_l, W_l, C_l), all float32, all bfloat16 or all
    int8 (raw quantized numbers, C_l % 16 == 0, sampled to bfloat16);
    points: (b, L, ..., 2) xy in [-1, 1]. Levels with ``projs[l]`` set
    return ``(sample @ W) * scale + b`` (border mode only; ``scales[l]``, a
    one-element tensor or None, is an int8 level's dequant scale). Returns
    a tuple of (b, ..., C_l or hd) in the maps'
    dtype (bfloat16 for int8). Covers the JAX package's
    ``sample_points_multi`` and ``sample_project_points_multi``. Under
    autograd the backward is K6 (or the plain VJP with projections).
    """
    levels = len(features)
    projs = _per_level(projs, levels)
    biases = _per_level(biases, levels)
    scales = _per_level(scales, levels)
    if _build.needs_grad(points, *features, *projs, *biases, *scales):
        return _SampleLevels.apply((padding_mode, align_corners, "K1"),
                                   points, *features, *projs, *biases,
                                   *scales)
    return _launch_forward(features, points, padding_mode, align_corners,
                           projs, biases, scales)


def sample_points_levels(
    features: Sequence[torch.Tensor],
    points: torch.Tensor,  # (b, L, ..., 2)
    padding_mode: str = "zeros",
    align_corners: bool = True,
    impl: str = "auto",
    projs=None,
    biases=None,
    scales=None,
) -> tuple:
    """Level-set dispatcher. ``impl``: "auto" (K1/K6 for CUDA tensors, the
    plain forward and backward behind the same autograd Function for CPU
    tensors), "fused" (K1/K6) or "gather" (the plain version, differentiated
    by autograd through its own ops)."""
    if impl == "auto" and features[0].device.type != "cpu":
        impl = "fused"
    if impl == "fused":
        return sample_points_multi(features, points, padding_mode,
                                   align_corners, projs, biases, scales)
    if impl not in ("auto", "gather"):
        raise ValueError(f"unknown sampler impl: {impl!r}")
    levels = len(features)
    projs = _per_level(projs, levels)
    biases = _per_level(biases, levels)
    scales = _per_level(scales, levels)
    if impl == "auto" and _build.needs_grad(points, *features, *projs,
                                            *biases, *scales):
        return _SampleLevels.apply((padding_mode, align_corners, None),
                                   points, *features, *projs, *biases,
                                   *scales)
    return sample_points_multi_reference(
        features, points, padding_mode, align_corners, projs, biases, scales)


def sample_points(
    features: torch.Tensor,
    points: torch.Tensor,
    padding_mode: str = "zeros",
    align_corners: bool = True,
    impl: str = "auto",
    precision: str = "highest",
) -> torch.Tensor:
    """Sample one NHWC map (b, H, W, C) at points (b, ..., 2), xy in
    [-1, 1] -> (b, ..., C). Port of the JAX package's single-level
    ``sample_points``.

    ``impl``: "auto" (K8 for CUDA tensors, the plain forward and backward
    behind the sampler's autograd Function for CPU tensors), "fused" (K8:
    the sampler kernel with one level, K6 as its backward) or "gather" (the
    plain version, differentiated by autograd through its own ops). Maps in
    float32 or bfloat16 sample to their dtype; int8 maps to float32 (the
    plain version) or bfloat16 (K8). ``precision`` selects the TPU kernel's
    matrix-unit passes; both versions here blend in fp32, so it has no
    effect."""
    del precision
    if impl == "auto" and features.device.type != "cpu":
        impl = "fused"
    if impl not in ("auto", "fused", "gather"):
        raise ValueError(f"unknown sampler impl: {impl!r}")
    if impl == "gather":
        return grid_sample_points(features, points, padding_mode=padding_mode,
                                  align_corners=align_corners)
    kernel = "K8" if impl == "fused" else None
    pts = points[:, None]  # one level: (b, 1, ..., 2)
    if _build.needs_grad(points, features):
        (out,) = _SampleLevels.apply((padding_mode, align_corners, kernel),
                                     pts, features, None, None, None)
    elif kernel:
        (out,) = _launch_forward((features,), pts, padding_mode,
                                 align_corners, (None,), (None,), k8=True)
    else:
        (out,) = sample_points_multi_reference((features,), pts,
                                               padding_mode, align_corners)
    return out


def _check_aggregate(name, features, points, weights, projs, biases,
                     padding_mode):
    """Validate a deformable aggregation; returns (b, L, p, nh, ns, hd)."""
    levels = len(features)
    if not 1 <= levels <= MAX_LEVELS:
        raise ValueError(f"{name}: 1..{MAX_LEVELS} levels, got {levels}")
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"unsupported padding_mode: {padding_mode!r}")
    dtype = features[0].dtype
    if dtype == torch.int8:
        raise TypeError(
            f"{name}: int8 maps are refused: their samples are raw quantized "
            "numbers whose dequant scale the projection would need, and no "
            "caller stores the pooled context in int8")
    if weights.dim() != 5 or len(projs) != levels or len(biases) != levels:
        raise ValueError(f"{name}: weights {tuple(weights.shape)} are not "
                         f"(b, L, p, nh, ns), or not {levels} projections "
                         "and biases")
    b, _, p, nh, ns = weights.shape
    hd = projs[0].shape[-1]
    if (weights.shape[1] != levels
            or points.shape != (b, levels, p, nh * ns, 2)):
        raise ValueError(f"{name}: points {tuple(points.shape)} and weights "
                         f"{tuple(weights.shape)} for {levels} levels")
    for l, (f, w, bias) in enumerate(zip(features, projs, biases)):
        if f.dim() != 4 or f.shape[0] != b or f.dtype != dtype:
            raise ValueError(f"{name}: level {l} is {tuple(f.shape)} "
                             f"{f.dtype}, expected (b={b}, H, W, C) {dtype}")
        if w.shape != (f.shape[-1], hd) or bias.shape != (hd,):
            raise ValueError(f"{name}: level {l} projection "
                             f"{tuple(w.shape)} and bias {tuple(bias.shape)}"
                             f" for {f.shape[-1]} channels to {hd}")
    return b, levels, p, nh, ns, hd


def aggregate_reference(features, points, weights, projs, biases,
                        padding_mode="border", align_corners=True):
    """Plain version of ``deformable_aggregate``: per level the fp32 samples,
    ``@ W + b``, multiplied by the weights and summed over ns, all in fp32
    and rounded once to the maps' dtype. Returns (b, L, p, nh * hd)."""
    b, _, p, nh, ns, hd = _check_aggregate(
        "aggregate_reference", features, points, weights, projs, biases,
        padding_mode)
    outs = []
    for l, f in enumerate(features):
        s = sample_points_fp32(f, points[:, l], padding_mode=padding_mode,
                               align_corners=align_corners)  # (b, p, nh*ns, C)
        proj = (s @ projs[l].float() + biases[l].float()).reshape(
            b, p, nh, ns, hd)
        pooled = torch.einsum("bphs,bphsd->bphd", weights[:, l].float(), proj)
        outs.append(pooled.reshape(b, p, nh * hd))
    return torch.stack(outs, dim=1).to(features[0].dtype)


class _AggregateLevel(ctypes.Structure):
    _fields_ = [
        ("feat", ctypes.c_void_p),
        ("proj_w", ctypes.c_void_p),
        ("proj_b", ctypes.c_void_p),
        ("h", ctypes.c_int),
        ("w", ctypes.c_int),
        ("c", ctypes.c_int),
    ]


class _AggregateArgs(ctypes.Structure):
    _fields_ = [
        ("points", ctypes.c_void_p),
        ("weights", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("levels", _AggregateLevel * MAX_LEVELS),
        ("num_levels", ctypes.c_int),
        ("batch", ctypes.c_int),
        ("rows", ctypes.c_int),
        ("ns", ctypes.c_int),
        ("hd", ctypes.c_int),
        ("border", ctypes.c_int),
        ("align_corners", ctypes.c_int),
        ("dtype", ctypes.c_int),
    ]


_ROWS, _MAX_HD = 64, 64  # csrc/aggregate.cu: rows a tile, most bf16 outputs


@dataclass(frozen=True)
class AggregatePlan:
    """One launch of K7: 64-row tiles a level (rows flattened over items),
    one a block; blocks; and the dynamic shared memory a block reserves
    (the widest level's)."""
    tiles: int
    blocks: int
    smem: int


def _aggregate_smem(dtype, c, hd, ns):
    """``csrc/aggregate.cu``'s ``smem_bytes``: the tile's taps and weight
    sums, then bf16 the A tile, W^T (C padded to 16) and the output
    staging, or fp32 the pooled rows and W."""
    head = _ROWS * ns * _TAP_BYTES + _ROWS * 4
    if dtype == torch.bfloat16:
        ld = -(-c // 16) * 16 + _PAD
        return head + 2 * ((_ROWS + hd) * ld + _ROWS * (hd + _PAD))
    return head + 4 * (_ROWS * (c + 4) + c * hd)


def aggregate_plan(dtype: torch.dtype, channels, hd: int, ns: int,
                   batch: int, rows: int) -> AggregatePlan:
    """The plan of a K7 call: C_l of each level, head dim ``hd``, ``ns``
    samples a row, ``rows`` = p * nh rows a level and item. bf16: C a
    multiple of 8, hd of 8 and at most 64; fp32: C and hd multiples of 4.
    Raises ValueError for what it cannot take."""
    name = "deformable_aggregate"
    bf = dtype == torch.bfloat16
    vec, hd_step = (8, 8) if bf else (4, 4)
    if hd % hd_step or hd < 4 or (bf and hd > _MAX_HD):
        raise ValueError(f"{name}: head dim {hd}; the kernel needs a "
                         f"multiple of {hd_step}"
                         + (f", at most {_MAX_HD}" if bf else ""))
    for c in channels:
        if c < vec or c % vec:
            raise ValueError(f"{name}: {c} channels; the kernel needs a "
                             f"multiple of {vec}")
    smem = max(_aggregate_smem(dtype, c, hd, ns) for c in channels)
    if smem > _build.SMEM_LIMIT:
        raise ValueError(f"{name}: {max(channels)} channels with ns={ns} "
                         f"and hd={hd} need {smem} bytes of shared memory")
    tiles = -(-batch * rows // _ROWS)
    return AggregatePlan(tiles, len(channels) * tiles, smem)


def deformable_aggregate_kernel(features, points, weights, projs, biases,
                                padding_mode="border", align_corners=True):
    """K7: ``aggregate_reference``'s contract in ONE CUDA kernel launch,
    pooling each row's samples before one projection (``aggregate_plan``).
    bf16 maps read W as bf16 W^T made once per parameter state
    (``kernel_weight``); fp32 maps read W in fp32."""
    global launches_k7
    name = "deformable_aggregate"
    b, levels, p, nh, ns, hd = _check_aggregate(
        name, features, points, weights, projs, biases, padding_mode)
    dtype = features[0].dtype
    code = _build.dtype_code(name, dtype)
    rows = p * nh
    aggregate_plan(dtype, [f.shape[-1] for f in features], hd, ns, b, rows)
    pts = points.reshape(b, levels, rows * ns, 2).float().contiguous()
    wts = weights.reshape(b, levels, rows * ns).float().contiguous()
    out = torch.empty((b, levels, p, nh * hd), dtype=dtype,
                      device=features[0].device)
    args = _AggregateArgs(
        points=pts.data_ptr(), weights=wts.data_ptr(), out=out.data_ptr(),
        num_levels=levels, batch=b, rows=rows, ns=ns, hd=hd,
        border=int(padding_mode == "border"),
        align_corners=int(align_corners), dtype=code)
    keep = [pts, wts, out]
    for l, f in enumerate(features):
        _, h, w, c = f.shape
        wk = (kernel_weight(projs[l]) if dtype == torch.bfloat16
              else projs[l].float().contiguous())
        bk = biases[l].float().contiguous()
        lv = args.levels[l]
        lv.feat, lv.h, lv.w, lv.c = f.data_ptr(), h, w, c
        lv.proj_w, lv.proj_b = wk.data_ptr(), bk.data_ptr()
        keep += [f, wk, bk]
    _build.require_cuda(name, *keep)
    if any(ptr % 16 for lv in args.levels[:levels]
           for ptr in (lv.feat, lv.proj_w)):
        raise ValueError(f"{name}: maps and projection weights must start "
                         "on a 16-byte boundary (16-byte loads)")
    lib = _build.library()
    err = lib.capf_deformable_aggregate(ctypes.addressof(args),
                                        *_build.launch_target(features[0]))
    _build.check(lib, err, name)
    launches_k7 += 1
    return out


def _by_level(fn):
    """``fn`` (an aggregation with per-level tuples) taking its tensors
    flat, as ``_build.PlainVjp`` passes them: (padding_mode, align_corners,
    points, weights, *maps, *projs, *biases)."""
    def run(padding_mode, align_corners, points, weights, *tensors):
        n = len(tensors) // 3
        return fn(tensors[:n], points, weights, tensors[n:2 * n],
                  tensors[2 * n:], padding_mode, align_corners)
    return run


def deformable_aggregate(
    features,
    points: torch.Tensor,   # (b, L, p, nh*ns, 2)
    weights: torch.Tensor,  # (b, L, p, nh, ns) attention weights
    projs,                  # L x (C_l, hd)
    biases,                 # L x (hd,)
    padding_mode: str = "border",
    align_corners: bool = True,
) -> torch.Tensor:
    """The DeformableBlock's pooled context -> (b, L, p, nh * hd): per level
    the maps sampled at ``points``, projected by ``projs[l]`` plus
    ``biases[l]``, weighted and summed over the ns samples of each head.
    Maps float32 or bfloat16 (int8 is refused); the output takes their
    dtype. K7 for CUDA tensors, the plain version for CPU tensors; under
    autograd the backward is the plain version's VJP."""
    features, projs, biases = tuple(features), tuple(projs), tuple(biases)
    run = (aggregate_reference if features[0].device.type == "cpu"
           else deformable_aggregate_kernel)
    if not _build.needs_grad(points, weights, *features, *projs, *biases):
        return run(features, points, weights, projs, biases, padding_mode,
                   align_corners)
    return _build.PlainVjp.apply(
        _by_level(run), _by_level(aggregate_reference), padding_mode,
        align_corners, points, weights, *features, *projs, *biases)
