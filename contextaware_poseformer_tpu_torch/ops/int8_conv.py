"""The int8 convolution of the deploy graphs (K10): CUDA kernel wrapper,
plain version and dispatcher.

Port of the int8 routes of ``ConvBN`` in
``contextaware_poseformer_tpu/models/backbone_common.py`` (157-213), which
the JAX package leaves to XLA (PyTorch has no CUDA int8 convolution), with
the elementwise ops that the CPN int8 stream fuses into its convs
(``models/cpn.py:43-51, 123-181``). NHWC input, a (Cout, kh*kw*Cin) int8
kernel with K ordered (kh, kw, Cin), square 1x1 or 3x3, stride 1 or 2,
zero padding (k - 1) // 2:

    int8 x (``x_quant``):      step = max(amax, 1e-12) / 127, xq = x
    float x, calibrated amax:  step = max(amax, 1e-12) / 127  (static)
    float x, amax=None:        step = max|x| / 127            (dynamic)
                               xq = clip(round(x / step), -127, 127)
    acc = conv(xq, kernel_q)                      int32, exact
    y = E(acc) * E(scale * wscale * step) + E(bias)
    y = y + residual                              optional, in E
    y = relu(y)                                   optional
    out = y, or clip(round(y * (127 / max(out_amax, 1e-12))), -127, 127)

with E the backbone's compute dtype (``dtype``: bf16, or fp32 where the
backbone computes in fp32, as the JAX package's ``ConvBN`` runs its
epilogue in ``self.dtype``) and the JAX package's rounding points as it
serves them (under ``jit``): fp32 for the scales (``/ 127`` as a
multiplication by fl32(1/127), while ``127 / amax`` stays an IEEE
division), the division by ``step``, the requantization and the
round-half-even; the affine as an E multiply and an E add, two roundings
(no FMA, also in fp32); the residual add in E. A residual is the
downsample conv's output in E, or an int8 skip with its calibrated amax,
dequantized as ``E(xq) * E(max(amax, 1e-12) / 127)`` (``cpn.py:139``).
The kernel is ``csrc/int8_conv.cu``, one template for both E. A float
input is quantized once, as the JAX package does
(``backbone_common.py:192-203``), by the quantize pass (K10q, its step
form) into an int8 scratch tensor (its launches counted in
``launches_quantize``); the max|x| reduction of the dynamic route comes
from ``torch``, as the JAX package computes it outside
any kernel too. The convolution then always reads int8: an implicit GEMM on
``wgmma`` whose tile ``plan`` picks per shape.

The CPN int8 stream's own quantizes run on the same kernels: ``quant``
(K10q's scale form, ``clip(round(t * (127 / amax)))``, the JAX package's
``_quant_i8``) and ``quant_max_pool_3x3_s2`` (K10p, the stem's quantize and
3x3/s2 max-pool in one pass, counted in ``launches_quant_pool``), each a
dispatcher beside its plain version. K10q and K10p take a bf16 or an fp32
tensor, as the backbone computes.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from contextaware_poseformer_tpu_torch.ops import _build

launches = 0  # kernel launches made by int8_conv_kernel
launches_quantize = 0  # quantize-pass (K10q) launches by quantize_kernel
launches_quant_pool = 0  # K10p launches made by quant_max_pool_kernel
launches_stem = 0  # K10s launches made by stem_conv_kernel
launches_topdown = 0  # K10u launches made by topdown_kernel

CIN_MULTIPLE = 16  # input channels: K's 16-byte pieces never straddle taps
K_TILE = 128  # bytes of K a stage of the kernel's ring holds
K_PIECE = 16  # bytes of K one load moves: one tap's channels
STAGES = 4  # the ring's depth (csrc/int8_conv.cu kStages)
BLOCK_M = 64  # output pixels a block owns: one consumer warpgroup
TILE_N = (128, 64)  # the output-channel widths of the tiles it builds
RECIP_127 = float(np.float32(1) / np.float32(127))  # fl32(1 / 127)
# K10q's forms (csrc/int8_conv.cu QuantForm): the step form, dynamic or
# calibrated, and the scale form
QUANT_FORMS = {("step", False): 0, ("step", True): 1, ("scale", True): 2}
GROUP = 16  # values a K10q thread quantizes together; K10p's channel group
POOL_SMEM = 48 * 1024  # the input rows a K10p block stages, at most
SM_SMEM = 228 * 1024  # an H100 SM's shared memory
BLOCK_RESERVED = 1024  # of it, what the system keeps for each resident block


def f32_const(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-dim fp32 tensor on ``like``'s device. Dividing by it
    is IEEE division on every device (CUDA turns a division by a Python
    number into a multiplication by its reciprocal)."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def absmax(x: torch.Tensor) -> torch.Tensor:
    """max|x| as a 0-dim fp32 tensor (exact: no rounding in a max)."""
    return torch.linalg.vector_norm(x, float("inf"), dtype=torch.float32)


def dequant_step(amax: torch.Tensor, clamp: bool) -> torch.Tensor:
    """The int8 step of a tensor of max|value| ``amax`` (fp32, 0-dim):
    ``max(amax, 1e-12) / 127`` for a calibrated scale, ``amax / 127`` for
    a runtime one. The JAX package serves under ``jit``, where XLA turns a
    division by the constant 127 into a multiplication by its fp32
    reciprocal; so does this."""
    a = amax.float()
    if clamp:
        a = torch.clamp(a, min=1e-12)
    return a * RECIP_127


def quant_reference(t: torch.Tensor, amax: torch.Tensor) -> torch.Tensor:
    """clip(round(t * (127 / max(amax, 1e-12))), -127, 127) -> int8, in
    fp32: the JAX package's ``_quant_i8`` (``models/cpn.py:43-51``) and
    ``HRNet._layer1_int8.quant``. The plain version of K10q's scale form."""
    a = torch.clamp(amax.float(), min=1e-12)
    r = torch.div(f32_const(127.0, a), a)
    return torch.clamp(torch.round(t.float() * r), -127, 127).to(torch.int8)


def quant(t: torch.Tensor, amax: torch.Tensor,
          impl: str = "auto") -> torch.Tensor:
    """Dispatcher of ``quant_reference``: the plain version for a CPU tensor
    or ``impl="plain"``, K10q's scale form for any other (which raises
    unless it is a CUDA bf16 or fp32 tensor)."""
    if impl == "plain" or t.device.type == "cpu":
        return quant_reference(t, amax)
    if impl != "auto":
        raise ValueError(f"quant: impl {impl!r} (auto or plain)")
    return quantize_kernel(t, amax, True, form="scale")


def max_pool_3x3_s2_int8(q: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(kernel=3, stride=2, padding=1) of an int8 NHWC tensor of
    values in [-127, 127], in int8: the padding is -128, which never wins
    (as the JAX package's int8 ``reduce_window`` from int8 min,
    ``backbone_common.py:389-395``), and the 9 taps are strided views."""
    b, h, w, c = q.shape
    ho, wo = (h + 1) // 2, (w + 1) // 2
    p = F.pad(q, (0, 0, 1, 2 * wo - w, 1, 2 * ho - h), value=-128)
    out = None
    for dy in range(3):
        for dx in range(3):
            tap = p[:, dy:dy + 2 * ho:2, dx:dx + 2 * wo:2]
            out = tap if out is None else torch.maximum(out, tap)
    return out


def quant_max_pool_3x3_s2_reference(x: torch.Tensor,
                                    amax: torch.Tensor) -> torch.Tensor:
    """Plain version of K10p: ``max_pool_3x3_s2(quant(x, amax))``, the CPN
    stream's stem (``models/cpn.py:241-244`` in the JAX package), NHWC
    (B, H, W, C) -> int8 (B, ceil(H/2), ceil(W/2), C)."""
    return max_pool_3x3_s2_int8(quant_reference(x, amax))


def quant_max_pool_3x3_s2(x: torch.Tensor, amax: torch.Tensor,
                          impl: str = "auto") -> torch.Tensor:
    """Dispatcher: the plain version for a CPU tensor or ``impl="plain"``,
    K10p for any other (which raises unless it is a CUDA bf16 or fp32
    tensor)."""
    if impl == "plain" or x.device.type == "cpu":
        return quant_max_pool_3x3_s2_reference(x, amax)
    if impl != "auto":
        raise ValueError(f"quant_max_pool_3x3_s2: impl {impl!r} (auto or "
                         "plain)")
    return quant_max_pool_kernel(x, amax)


def dequant(xq: torch.Tensor, amax: torch.Tensor, dtype) -> torch.Tensor:
    """An int8 tensor's values in ``dtype``: ``dtype(xq) * dtype(max(amax,
    1e-12) / 127)``, one rounding (the residual skip of ``cpn.py:139``)."""
    return xq.to(dtype) * dequant_step(amax, clamp=True).to(dtype)


def _kernel_size(kernel_q: torch.Tensor, cin: int,
                 sizes=(1, 3)) -> int:
    taps = kernel_q.shape[1] // cin
    k = math.isqrt(taps)
    if k * k * cin != kernel_q.shape[1] or k not in sizes:
        raise ValueError(f"int8_conv: kernel {tuple(kernel_q.shape)} is not "
                         f"{' or '.join(f'{n}x{n}' for n in sizes)} over "
                         f"{cin} input channels")
    return k


def _conv64(x, kernel, stride):
    """conv(x, kernel) in float64, NHWC in and out, ``kernel`` (Cout,
    kh*kw*Cin) with K ordered (kh, kw, Cin): K10's 1x1 or 3x3, or the fold
    stem's 7x7. The output is laid out NHWC, as the kernel writes it: the
    float ops downstream (a resize, a cuDNN conv) then take the same route,
    and round alike, after either."""
    ksize = _kernel_size(kernel, x.shape[-1], (1, 3, STEM_KSIZE))
    w = kernel.reshape(kernel.shape[0], ksize, ksize, -1)
    return F.conv2d(x.permute(0, 3, 1, 2).double(),
                    w.permute(0, 3, 1, 2).double(), stride=stride,
                    padding=(ksize - 1) // 2).permute(0, 2, 3, 1).contiguous()


def accumulate_float(x, kernel, stride):
    """conv(x, kernel) of float operands (bf16 in the bf16 probe) summed in
    float64, as fp32."""
    return _conv64(x, kernel, stride).float()


def accumulate(xq, kernel_q, stride):
    """The int32 accumulation of the int8 values ``xq`` (NHWC, int8 or
    float holding integers, -128 included) with ``kernel_q``, in float64:
    exact, since every product is below 2**14 and every sum below 2**26
    (rounded before the cast, in case the library's algorithm leaves a
    residue far below 0.5)."""
    return torch.round(_conv64(xq, kernel_q, stride)).to(torch.int32)


def input_step(x, amax):
    """The quantization step of a K10 input: ``max(amax, 1e-12) / 127`` for
    a calibrated ``amax``, ``max|x| / 127`` unclamped for ``amax=None``."""
    return (dequant_step(absmax(x), clamp=False) if amax is None
            else dequant_step(amax, clamp=True))


def quantize_reference(x, amax):
    """Plain version of the quantize pass: a float ``x`` -> int8
    ``clip(round(x / step), -127, 127)`` with ``input_step(x, amax)``, an
    IEEE division and round-half-even, as the JAX package serves it."""
    step = input_step(x, amax)
    return torch.clamp(torch.round(x.float() / step), -127,
                       127).to(torch.int8)


def block_smem(tile_n: int, k_bytes: int, dtype: torch.dtype,
               res_dtype: torch.dtype | None) -> int:
    """A block's shared memory as the kernel sizes it at launch
    (``csrc/int8_conv.cu`` ``Tile::smem``) for K of ``k_bytes`` bytes, an
    epilogue in ``dtype`` and a residual of ``res_dtype`` (None: no
    residual): the slack that aligns the ring to 1024 bytes, the ring
    (``min(ceil(K / 128), STAGES)`` stages, at least the staged tile of
    ``dtype`` values that reuses it), the residual tile, the barriers and
    the epilogue's scales."""
    elem = torch.empty((), dtype=dtype).element_size()
    res = 0 if res_dtype is None else torch.empty(
        (), dtype=res_dtype).element_size()
    stages = min(-(-k_bytes // K_TILE), STAGES)
    ring = max(stages * (BLOCK_M + tile_n) * K_TILE,
               BLOCK_M * (tile_n + 8) * elem)
    return (1024 + ring + BLOCK_M * tile_n * res + (2 * STAGES + 1) * 8
            + 2 * tile_n * 4)


@functools.lru_cache(maxsize=None)
def plan(m: int, n: int, k_bytes: int, dtype: torch.dtype,
         res_dtype: torch.dtype | None) -> int:
    """The width (BN) of the kernel's 64-row tile for an (M, N) output,
    from K10's times on the card at every shape of the CPN and W32 deploy
    graphs, each width forced in turn (PERF.md, PR 7; 128-row tiles on two
    consumer warpgroups never won and are not built): 128 channels, unless
    N fits 64 (less padding), M is past 2**17 (the 64x48 maps at batch 64:
    bytes decide, and the smaller tile keeps more blocks in flight),
    64-wide tiles pad N less, or the block's shared memory
    (``block_smem``: K of ``k_bytes``, a residual of ``res_dtype``) would
    keep a second 128-wide block off the SM. That happens with a bf16 or
    fp32 residual tile on a full ring: the block then runs alone and its
    epilogue hides nothing (on an H100 at batch 512 the 64-wide tile ran
    14% faster at HRNet-W32's branch-2 tails, 28% at the CPN's layer4.0
    conv3; PERF.md section 6). K
    takes whole 128-byte stages whatever the tile; split-K is not built
    (the smallest deploy shape, 3,072 x 128, still gives 48 blocks)."""
    pad = {bn: -(-n // bn) * bn - n for bn in TILE_N}
    if n <= 64 or m >= 2 ** 17 or pad[64] < pad[128]:
        return 64
    two = 2 * (block_smem(128, k_bytes, dtype, res_dtype) + BLOCK_RESERVED)
    return 64 if two > SM_SMEM else 128


def int8_conv_reference(x, kernel_q, wscale, scale, bias, amax, stride,
                        relu, dtype=torch.bfloat16, residual=None,
                        res_amax=None, out_amax=None):
    """Plain version. ``x`` (B, H, W, Cin) int8 with ``amax`` its calibrated
    max|value|, or float with ``amax`` its calibrated max|value| (static)
    or None (dynamic). ``residual`` (B, Ho, Wo, Cout): float, or int8 with
    ``res_amax``; ``relu`` applies after it; ``out_amax`` requantizes the
    output to int8."""
    if x.dtype == torch.int8:
        step = dequant_step(amax, clamp=True)
        xq = x
    else:
        step = (dequant_step(absmax(x), clamp=False) if amax is None
                else dequant_step(amax, clamp=True))
        xq = torch.clamp(torch.round(x.float() / step), -127, 127)
    acc = accumulate(xq, kernel_q, stride)
    eff = (scale.float() * wscale.float() * step).to(dtype)
    y = acc.to(dtype) * eff + bias.to(dtype)
    if residual is not None:
        y = y + (dequant(residual, res_amax, dtype)
                 if residual.dtype == torch.int8 else residual.to(dtype))
    if relu:
        y = torch.relu(y)
    return y if out_amax is None else quant_reference(y, out_amax)


class _Args(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "x", "wq", "wscale", "scale", "bias", "amax", "res", "res_amax",
        "out_amax", "out")] + [(n, ctypes.c_int) for n in (
            "batch", "h", "w", "cin", "cout", "ksize", "stride", "ho", "wo",
            "clamp_amax", "res_int8", "relu", "tile_n", "f32")]


def out_size(size: int, ksize: int, stride: int) -> int:
    pad = (ksize - 1) // 2
    return (size + 2 * pad - ksize) // stride + 1


def conv_args(x, kernel_q, amax, stride, out, dtype=torch.bfloat16,
              res_dtype=None, **fields) -> _Args:
    """The kernel's argument block for ``x`` (B, H, W, Cin) and ``out``
    (B, Ho, Wo, Cout), an epilogue in ``dtype`` and a residual of
    ``res_dtype`` (for the tile's plan); ``fields`` fill the rest
    (pointers as ints)."""
    b, h, w, cin = x.shape
    ksize = _kernel_size(kernel_q, cin)
    k_bytes = ksize * ksize * cin * x.element_size()
    return _Args(x=x.data_ptr(), wq=kernel_q.data_ptr(),
                 amax=None if amax is None else amax.data_ptr(),
                 out=out.data_ptr(), batch=b, h=h, w=w, cin=cin,
                 cout=kernel_q.shape[0], ksize=ksize, stride=stride,
                 ho=out.shape[1], wo=out.shape[2],
                 tile_n=plan(b * out.shape[1] * out.shape[2],
                             kernel_q.shape[0], k_bytes, dtype, res_dtype),
                 **fields)


def _scalar(name, t):
    if t is None or t.numel() != 1:
        raise ValueError(f"int8_conv: {name} must be a one-element tensor")
    return t.reshape(()).float().contiguous()


def _quant_operands(name, x, amax):
    """The checks K10q and K10p make before they launch, the device's
    last: a bf16 or fp32 ``x`` (the backbone's compute dtype) starting on a
    16-byte boundary and an fp32 one-element ``amax``, on one CUDA device,
    contiguous. Returns the suffix of the C entry for ``x``'s dtype."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: the CUDA kernel takes bf16 or fp32 x, got "
                        f"{x.dtype}")
    if amax.dtype != torch.float32 or amax.numel() != 1:
        raise TypeError(f"{name}: amax must be an fp32 tensor of one "
                        f"element, got {amax.dtype} {tuple(amax.shape)}")
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: x must start on a 16-byte boundary")
    _build.require_cuda(name, x, amax)
    return "_f32" if x.dtype == torch.float32 else ""


def quantize_kernel(x, amax, clamp, form="step"):
    """K10q on the card: bf16 or fp32 ``x`` -> int8 into a fresh tensor
    (numel a multiple of 16). ``form="step"``: ``quantize_reference``'s
    function, with the step of ``amax`` (fp32, one element: calibrated with
    ``clamp``, max|x| without); ``form="scale"``: ``quant_reference``'s
    (``amax`` always clamped at 1e-12; ``clamp`` must be True)."""
    global launches_quantize
    name = "int8_quantize"
    mode = QUANT_FORMS.get((form, bool(clamp)))
    if mode is None:
        raise ValueError(f"{name}: form {form!r} with clamp={clamp}")
    if x.numel() % GROUP or not x.numel():
        raise ValueError(f"{name}: x must hold a non-zero multiple of "
                         f"{GROUP} values, got {tuple(x.shape)}")
    entry = "capf_int8_quantize" + _quant_operands(name, x, amax)
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    lib = _build.library()
    err = getattr(lib, entry)(x.data_ptr(), amax.data_ptr(), out.data_ptr(),
                              x.numel(), mode, *_build.launch_target(x))
    _build.check(lib, err, name)
    launches_quantize += 1
    return out


def quant_pool_rows(h: int, w: int, c: int, itemsize: int = 2) -> int:
    """K10p's plan for input values of ``itemsize`` bytes (2 bf16, 4 fp32):
    the output rows a block owns, the most whose 2 rows + 1 input rows fit
    POOL_SMEM, or else one row, a strip of three input rows past POOL_SMEM
    up to the block's opt-in limit (``_build.SMEM_LIMIT``; a wider row is
    refused). At the bf16 stem, (128, 96, 64), that is one row, 36 KB: on
    the card 1 row took 0.0447 ms, 2 rows 0.0459, 3 and 4 rows 0.048
    (PERF.md); at the fp32 stem one row, 72 KB, past POOL_SMEM."""
    ho, row = (h + 1) // 2, w * c * itemsize
    rows = max(1, min(ho, (POOL_SMEM // row - 1) // 2))
    if min(2 * rows + 1, h) * row > _build.SMEM_LIMIT:
        raise ValueError(f"int8_quant_pool: a row of {w} x {c} values of "
                         f"{itemsize} bytes leaves no room for the three "
                         "rows a strip needs")
    return rows


def quant_max_pool_kernel(x, amax):
    """K10p on the card: bf16 or fp32 NHWC ``x`` (B, H, W, C), C a multiple
    of 16 -> int8 (B, ceil(H/2), ceil(W/2), C), the function of
    ``quant_max_pool_3x3_s2_reference``."""
    global launches_quant_pool
    name = "int8_quant_pool"
    if x.dim() != 4 or x.shape[-1] % GROUP or not x.numel():
        raise ValueError(f"{name}: x must be NHWC with C a multiple of "
                         f"{GROUP}, got {tuple(x.shape)}")
    entry = "capf_int8_quant_pool" + _quant_operands(name, x, amax)
    b, h, w, c = x.shape
    rows = quant_pool_rows(h, w, c, x.element_size())
    out = torch.empty((b, (h + 1) // 2, (w + 1) // 2, c), dtype=torch.int8,
                      device=x.device)
    lib = _build.library()
    err = getattr(lib, entry)(x.data_ptr(), amax.data_ptr(), out.data_ptr(),
                              b, h, w, c, rows, *_build.launch_target(x))
    _build.check(lib, err, name)
    launches_quant_pool += 1
    return out


def int8_conv_kernel(x, kernel_q, wscale, scale, bias, amax, stride, relu,
                     dtype=torch.bfloat16, residual=None, res_amax=None,
                     out_amax=None):
    """The CUDA kernel: same contract as ``int8_conv_reference``, with the
    epilogue in ``dtype`` (bf16 or fp32) and a ``dtype`` (or, with
    ``out_amax``, int8) output; ``x`` int8 or ``dtype`` with Cin a multiple
    of 16, Cout a multiple of 8, fp32 ``wscale``/``scale``/``bias``, a
    ``dtype`` or int8 ``residual``. A float ``x`` goes through the quantize
    pass first. Where K = kh*kw*Cin does not fill whole 128-byte
    stages (Cin 16 or 48: K 144 or 432), the last stage's tail is zero on
    both sides: A's pieces past K load nothing (``cp.async`` with a source
    size of 0) and the weight map's box past K is the TMA's zero fill, the
    kernel's zero K columns."""
    global launches
    name = "int8_conv"
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: the CUDA kernel computes in bf16 or fp32, "
                        f"not {dtype}")
    if x.dim() != 4 or x.dtype not in (torch.int8, dtype):
        raise TypeError(f"{name}: x must be NHWC int8 or {dtype}, got "
                        f"{tuple(x.shape)} {x.dtype}")
    b, h, w, cin = x.shape
    cout = kernel_q.shape[0]
    ksize = _kernel_size(kernel_q, cin)
    if cin % CIN_MULTIPLE or cout % 8 or stride not in (1, 2):
        raise ValueError(f"{name}: Cin {cin} (multiple of {CIN_MULTIPLE}), "
                         f"Cout {cout} (multiple of 8), stride {stride} (1 "
                         "or 2)")
    if kernel_q.dtype != torch.int8:
        raise TypeError(f"{name}: kernel_q must be int8")
    vecs = (wscale, scale, bias)
    if any(v.dtype != torch.float32 or v.shape != (cout,) for v in vecs):
        raise TypeError(f"{name}: wscale, scale and bias must be fp32 "
                        f"({cout},)")
    if x.dtype == torch.int8 and amax is None:
        raise ValueError(f"{name}: an int8 input needs its amax")
    clamp = amax is not None
    amax = absmax(x) if amax is None else _scalar("amax", amax)
    ho, wo = out_size(h, ksize, stride), out_size(w, ksize, stride)
    keep = [x, kernel_q, *vecs, amax]
    fields = {}
    if residual is not None:
        if (residual.shape != (b, ho, wo, cout)
                or residual.dtype not in (torch.int8, dtype)):
            raise TypeError(f"{name}: residual must be {dtype} or int8 "
                            f"{(b, ho, wo, cout)}, got {residual.dtype} "
                            f"{tuple(residual.shape)}")
        keep.append(residual)
        fields.update(res=residual.data_ptr(),
                      res_int8=int(residual.dtype == torch.int8))
        if residual.dtype == torch.int8:
            res_amax = _scalar("res_amax", res_amax)
            keep.append(res_amax)
            fields["res_amax"] = res_amax.data_ptr()
    if out_amax is not None:
        out_amax = _scalar("out_amax", out_amax)
        keep.append(out_amax)
        fields["out_amax"] = out_amax.data_ptr()
    _build.require_cuda(name, *keep)
    if any(t.data_ptr() % 16 for t in (x, kernel_q, *keep[5:])):
        raise ValueError(f"{name}: x, kernel_q and residual must start on a "
                         "16-byte boundary (16-byte loads)")
    if x.dtype != torch.int8:
        x = quantize_kernel(x, amax, clamp)
    out = torch.empty((b, ho, wo, cout), device=x.device,
                      dtype=dtype if out_amax is None else torch.int8)
    args = conv_args(x, kernel_q, amax, stride, out, dtype,
                     None if residual is None else residual.dtype,
                     wscale=wscale.data_ptr(),
                     scale=scale.data_ptr(), bias=bias.data_ptr(),
                     clamp_amax=int(clamp), relu=int(relu),
                     f32=int(dtype == torch.float32), **fields)
    lib = _build.library()
    err = lib.capf_int8_conv(ctypes.addressof(args),
                             *_build.launch_target(x))
    _build.check(lib, err, name)
    launches += 1
    return out


def int8_conv(x, kernel_q, wscale, scale, bias, amax, stride, relu,
              dtype=torch.bfloat16, impl: str = "auto", residual=None,
              res_amax=None, out_amax=None):
    """Dispatcher: the plain version for a CPU tensor or ``impl="plain"``,
    the CUDA kernel for any other (which raises unless it is a CUDA
    tensor)."""
    if impl == "plain" or x.device.type == "cpu":
        return int8_conv_reference(x, kernel_q, wscale, scale, bias, amax,
                                   stride, relu, dtype, residual, res_amax,
                                   out_amax)
    if impl != "auto":
        raise ValueError(f"int8_conv: impl {impl!r} (auto or plain)")
    return int8_conv_kernel(x, kernel_q, wscale, scale, bias, amax, stride,
                            relu, dtype, residual, res_amax, out_amax)


# ---- K10s: the fold-normalize stem; K10u: the s8 top-down hop -------------

STEM_KSIZE = 7  # the stem conv: 7x7, stride 2, zero padding 3, 3 -> 64
STEM_COUT = 64
STEM_STEP_BYTES = 32  # a kernel row's k-step: its 21 (kw, c) taps, zero to 32
STEM_W_MULTIPLE = 32  # K10s's frame width: whole 16-pixel output tiles
# The step of the s8 frame (u8 - 128, in units of 1/255): the JAX package
# feeds conv1 the amax fl32(127 / 255) (``cpn.py:223``), a constant that its
# jit folds with ``max(amax, 1e-12) / 127`` as an IEEE division
# (``backbone_common.py:192-195``), unlike a traced scale's ``/ 127``
STEM_STEP = float(np.float32(127.0 / 255.0) / np.float32(127.0))


def stem_accumulate(frames_u8: torch.Tensor,
                    kernel_q: torch.Tensor) -> torch.Tensor:
    """The int32 accumulation of the fold stem: uint8 BGR frames (B, H, W,
    3) as s8 RGB (``u8 ^ 0x80``, i.e. u8 - 128, channels reversed) convolved
    with ``kernel_q`` (64, 7*7*3), K ordered (kh, kw, c) with c in RGB, at
    stride 2 under zero padding 3 (``accumulate``) -> (B, ceil(H/2),
    ceil(W/2), 64)."""
    return accumulate((frames_u8.to(torch.int16) - 128).flip(-1), kernel_q,
                      2)


def stem_conv_reference(frames_u8, kernel_q, wscale, scale, bias, bias_map,
                        dtype=torch.bfloat16):
    """Plain version of K10s, the CPN's fold-normalize stem (the JAX
    package's ``cpn.py:214-223``): ``relu(E(ys + bias_map))`` with ``ys =
    E(acc) * E(scale * wscale * STEM_STEP) + E(bias)`` (two roundings),
    ``acc`` from ``stem_accumulate`` and E = ``dtype``; ``bias_map`` (1, Ho,
    Wo, 64) in E, the conv of the normalization's constant offset
    (``models/cpn.py``), added to every frame."""
    acc = stem_accumulate(frames_u8, kernel_q)
    eff = (scale.float() * wscale.float()
           * f32_const(STEM_STEP, scale)).to(dtype)
    ys = acc.to(dtype) * eff + bias.to(dtype)
    return torch.relu(ys + bias_map.to(dtype))


def stem_weight_steps(kernel_q: torch.Tensor) -> torch.Tensor:
    """K10s's weights: ``kernel_q`` (64, 7*7*3, (kh, kw, c) with c in RGB)
    as (7, 64, 32) int8, kernel row, channel, then the row's 21 (kw, c)
    taps with c reversed (the frames' BGR order: the flip folded into the
    weights), zero to 32 bytes (one mma k-step a kernel row)."""
    cout = kernel_q.shape[0]
    k = kernel_q.reshape(cout, STEM_KSIZE, STEM_KSIZE, 3).flip(-1)
    k = F.pad(k.reshape(cout, STEM_KSIZE, 3 * STEM_KSIZE),
              (0, STEM_STEP_BYTES - 3 * STEM_KSIZE))
    return k.permute(1, 0, 2).contiguous()


# K10s's plan (csrc/stem_conv.cu): a block stages its input rows in a ring
# of STEM_SLOTS rows, slot (b * 2 Ho + iy) % STEM_SLOTS for row iy of image b
STEM_SLOTS = 16
# rows staged ahead of the one computing, by the epilogue's bytes a value
# (fp32 1: two blocks an SM); the bias-map rows staged are those, the one
# computing and the one before it (a warp may still read it)
STEM_AHEAD = {2: 2, 4: 1}
STEM_MAX_WARPS = 8  # a segment's 16-pixel tiles: one a warp
STEM_LEAD, STEM_TAIL = 16, 32  # staged bytes before and after the pixels
STEM_MAP_PITCH = STEM_COUT + 8  # a staged map pixel's values (no conflicts)
STEM_B_BYTES = 2 * STEM_COUT * 128  # wgmma's B: two 128-byte-swizzled stages
STEM_ALIGN = 1024  # the slack that aligns the stages
STEM_BLOCKS_SM = 2  # persistent blocks an SM, at most (registers)
STEM_FRAG_SLOTS = 8  # bf16: the input rows of A fragments a warp keeps
SM_SMEM = 228 * 1024  # an H100 SM's shared memory (1 KB more a block)
SMS = 132  # H100 SXM: the grid's bound when the card is not asked


@dataclass(frozen=True)
class StemPlan:
    seg: int  # output pixels of a row segment: 16 a warp, at most 128
    segs: int  # segments of an output row, ceil(Wo / seg)
    bands: int  # bands of consecutive output rows (of B * Ho) a segment
    grid: int  # segs * bands persistent blocks
    pitch: int  # bytes of a staged input row: lead, 6 seg, tail
    period: int  # an image's rows in the ring's slot numbers: 2 Ho
    ahead: int  # rows staged ahead of the one computing
    smem: int  # dynamic shared memory a block takes

    @property
    def map_slots(self) -> int:
        return self.ahead + 2

    @property
    def threads(self) -> int:  # whole warpgroups: a warp a 16-pixel tile
        return 128 * -(-self.seg // 64)


def stem_smem_bytes(seg: int, itemsize: int) -> int:
    """K10s's dynamic shared memory (``csrc/stem_conv.cu`` ``smem_bytes``):
    the slack that aligns wgmma's B, B (the weights in two 128-byte-swizzled
    stages), the folded scales and biases (E), the ring of staged input
    rows, the staged bias-map rows of E values of ``itemsize`` bytes, each
    pixel padded by 8 values, and in bf16 each warp's kept A fragments
    (16 bytes a lane a kernel row)."""
    return (STEM_ALIGN + STEM_B_BYTES + 2 * STEM_COUT * itemsize
            + STEM_SLOTS * (STEM_LEAD + 6 * seg + STEM_TAIL)
            + (STEM_AHEAD[itemsize] + 2) * seg * STEM_MAP_PITCH * itemsize
            + (seg // 16 * STEM_FRAG_SLOTS * 32 * 16 if itemsize == 2
               else 0))


@functools.lru_cache(maxsize=None)
def stem_plan(batch: int, h: int, w: int, itemsize: int = 2,
              sms: int = SMS) -> StemPlan:
    """K10s's launch for ``batch`` frames of H x W (W a multiple of 32) and
    an epilogue of ``itemsize``-byte values: an output row in the fewest
    segments of at most STEM_MAX_WARPS 16-pixel tiles (one at 256x192), and
    each segment's B * Ho rows cut into as many bands of consecutive rows as
    fill the card (STEM_BLOCKS_SM blocks an SM, which the kernel's
    registers allow, or fewer where shared memory runs out). Band k of a
    segment owns rows [k R / bands, (k + 1) R / bands), R = B * Ho."""
    ho, wo = (h + 1) // 2, w // 2
    tiles = wo // 16
    seg = 16 * -(-tiles // -(-tiles // STEM_MAX_WARPS))
    segs = -(-wo // seg)
    smem = stem_smem_bytes(seg, itemsize)
    per_sm = max(1, min(STEM_BLOCKS_SM, SM_SMEM // (smem + 1024)))
    bands = max(1, min(batch * ho, per_sm * sms // segs))
    return StemPlan(seg, segs, bands, segs * bands,
                    STEM_LEAD + 6 * seg + STEM_TAIL, 2 * ho,
                    STEM_AHEAD[itemsize], smem)


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


class _StemArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "x", "wk", "wscale", "scale", "bias", "bias_map", "out")] + [
        ("step", ctypes.c_float)] + [(n, ctypes.c_int) for n in (
            "batch", "h", "w", "ho", "wo", "f32", "seg", "segs", "bands",
            "period", "smem")]


def stem_conv_kernel(frames_u8, kernel_q, wscale, scale, bias, bias_map,
                     dtype=torch.bfloat16):
    """K10s on the card: the contract of ``stem_conv_reference``, for
    uint8 frames (B, H, W, 3) with W a multiple of 32; ``bias_map`` (1, Ho,
    Wo, 64) or (Ho, Wo, 64) in ``dtype`` (bf16 or fp32). Its weights come
    from ``kernel_q`` once per parameter state
    (``stem_weight_steps``, ``_build.cached_operand``); its launch from
    ``stem_plan``."""
    global launches_stem
    name = "stem_conv"
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: the CUDA kernel computes in bf16 or fp32, "
                        f"not {dtype}")
    if (frames_u8.dtype != torch.uint8 or frames_u8.dim() != 4
            or frames_u8.shape[-1] != 3):
        raise TypeError(f"{name}: frames must be uint8 (B, H, W, 3), got "
                        f"{frames_u8.dtype} {tuple(frames_u8.shape)}")
    b, h, w, _ = frames_u8.shape
    if w % STEM_W_MULTIPLE or not b or not h:
        raise ValueError(f"{name}: the frame width {w} must be a multiple "
                         f"of {STEM_W_MULTIPLE}")
    ho, wo = (h + 1) // 2, w // 2
    if kernel_q.dtype != torch.int8 or kernel_q.shape != (
            STEM_COUT, STEM_KSIZE * STEM_KSIZE * 3):
        raise TypeError(f"{name}: kernel_q must be int8 (64, 147)")
    vecs = (wscale, scale, bias)
    if any(v.dtype != torch.float32 or v.shape != (STEM_COUT,)
           for v in vecs):
        raise TypeError(f"{name}: wscale, scale and bias must be fp32 (64,)")
    bias_map = bias_map.reshape(ho, wo, STEM_COUT) if bias_map.numel() == (
        ho * wo * STEM_COUT) else None
    if bias_map is None or bias_map.dtype != dtype:
        raise TypeError(f"{name}: bias_map must be {dtype} ({ho}, {wo}, "
                        f"{STEM_COUT})")
    _build.require_cuda(name, frames_u8, kernel_q, *vecs, bias_map)
    wk = _build.cached_operand(kernel_q, "stem k-steps", stem_weight_steps)
    if any(t.data_ptr() % 16 for t in (frames_u8, wk, bias_map)):
        raise ValueError(f"{name}: frames, weights and bias_map must start "
                         "on a 16-byte boundary (16-byte loads)")
    p = stem_plan(b, h, w, bias_map.element_size(), _sms(frames_u8.device))
    out = torch.empty((b, ho, wo, STEM_COUT), dtype=dtype,
                      device=frames_u8.device)
    args = _StemArgs(x=frames_u8.data_ptr(), wk=wk.data_ptr(),
                     wscale=wscale.data_ptr(), scale=scale.data_ptr(),
                     bias=bias.data_ptr(), bias_map=bias_map.data_ptr(),
                     out=out.data_ptr(), step=STEM_STEP, batch=b, h=h, w=w,
                     ho=ho, wo=wo, f32=int(dtype == torch.float32),
                     seg=p.seg, segs=p.segs, bands=p.bands, period=p.period,
                     smem=p.smem)
    lib = _build.library()
    err = lib.capf_stem_conv(ctypes.addressof(args),
                             *_build.launch_target(frames_u8))
    _build.check(lib, err, name)
    launches_stem += 1
    return out


def stem_conv(frames_u8, kernel_q, wscale, scale, bias, bias_map,
              dtype=torch.bfloat16, impl: str = "auto"):
    """Dispatcher: the plain version for a CPU tensor or ``impl="plain"``,
    K10s for any other (which raises unless it is a CUDA tensor)."""
    if impl == "plain" or frames_u8.device.type == "cpu":
        return stem_conv_reference(frames_u8, kernel_q, wscale, scale, bias,
                                   bias_map, dtype)
    if impl != "auto":
        raise ValueError(f"stem_conv: impl {impl!r} (auto or plain)")
    return stem_conv_kernel(frames_u8, kernel_q, wscale, scale, bias,
                            bias_map, dtype)


@functools.lru_cache(maxsize=None)
def interp_table(out_size: int, in_size: int,
                 dtype=torch.bfloat16) -> tuple[np.ndarray, np.ndarray]:
    """The two taps (out, 2) int32 and their weights (out, 2) fp32, each an
    E number (E = ``dtype``), of each output row of a bilinear resize with
    align_corners from ``in_size`` to ``out_size``: the nonzero entries of
    the JAX package's ``_linear_interp_matrix`` (``backbone_common.py:
    249-263``) as its served graph computes them. Its jit folds the source
    position's constants as ``o * fl32(fl32(in - 1) * fl32(1 / (out - 1)))``
    (held against the JAX package in ``tests/test_torch_cpn_knobs.py``); a
    second tap clipped onto the first is folded into it (w0 + w1, w1 = 0),
    as the matrix sums them before its rounding to E."""
    f32 = np.float32
    if in_size == 1:
        idx = np.zeros((out_size, 2), np.int32)
        w = np.stack([np.ones(out_size, f32), np.zeros(out_size, f32)], 1)
    else:
        src = (np.arange(out_size, dtype=f32)
               * (f32(in_size - 1) * (f32(1) / f32(out_size - 1)))
               if out_size > 1 else np.zeros(1, f32))
        i0 = np.clip(np.floor(src).astype(np.int32), 0, in_size - 1)
        i1 = np.clip(i0 + 1, 0, in_size - 1)
        w1 = src - i0.astype(f32)
        w0 = f32(1) - w1
        same = i0 == i1
        w0, w1 = np.where(same, w0 + w1, w0), np.where(same, f32(0), w1)
        idx, w = np.stack([i0, i1], 1), np.stack([w0, w1], 1).astype(f32)
    w = torch.from_numpy(w).to(dtype).float().numpy()
    for a in (idx, w):  # cached: every caller shares them
        a.flags.writeable = False
    return idx, w


@functools.lru_cache(maxsize=None)
def _interp_tensors(out_size, in_size, dtype, device):
    idx, w = interp_table(out_size, in_size, dtype)
    return (torch.tensor(idx, device=device), torch.tensor(w, device=device))


def topdown_reference(q, ua, lat, dtype=torch.bfloat16):
    """Plain version of K10u, the CPN's s8 top-down hop (the JAX package's
    ``cpn.py:334-338`` and the lateral add of ``cpn.py:289``): ``q`` (B, h,
    w, C) int8 with its calibrated amax ``ua``, ``lat`` (B, 2h, 2w, C) ->
    ``E(lat + E(u * E(max(ua, 1e-12) / 127)))`` with ``u`` the separable
    align-corners x2 upsample of ``q``, rows first: each pass the sum of
    its two taps' fp32 products rounded once to E (``interp_table``), as
    the JAX package's two interpolation matmuls in E compute it."""
    _, h, w, _ = q.shape
    dev = q.device
    ri, rw = _interp_tensors(2 * h, h, dtype, dev)
    ci, cw = _interp_tensors(2 * w, w, dtype, dev)
    ri, ci = ri.long(), ci.long()
    qf = q.float()
    r = (rw[:, 0].view(1, -1, 1, 1) * qf[:, ri[:, 0]]
         + rw[:, 1].view(1, -1, 1, 1) * qf[:, ri[:, 1]]).to(dtype).float()
    u = (cw[:, 0].view(1, 1, -1, 1) * r[:, :, ci[:, 0]]
         + cw[:, 1].view(1, 1, -1, 1) * r[:, :, ci[:, 1]]).to(dtype)
    return lat.to(dtype) + u * dequant_step(ua, clamp=True).to(dtype)


# K10u's plan (csrc/topdown.cu): a block owns a strip of TOPDOWN_ROWS
# output rows of one image, a tile of its columns and a slice of its
# channels, in TOPDOWN_THREADS threads (8 channels a thread on x)
TOPDOWN_ROWS = 2
TOPDOWN_MAX_CHANNELS = 256
TOPDOWN_THREADS = 256
TOPDOWN_SMEM = 96 * 1024  # a block's budget: two or more blocks an SM
TOPDOWN_TAP_BYTES = 16  # a staged tap: two int32 indices, two weights


@dataclass(frozen=True)
class TopdownPlan:
    rows: int  # output rows of a strip
    cols: int  # output columns of a tile (2w where they fit)
    chans: int  # channels of a slice, a multiple of 8 (C up to 256)
    strips: int  # ceil(2h / rows)
    tiles: int  # ceil(2w / cols)
    slices: int  # ceil(C / chans)
    src_rows: int  # source rows a strip stages, at most
    src_cols: int  # source columns a tile stages, at most
    smem: int  # dynamic shared memory a block takes

    def grid(self, batch: int) -> int:
        return batch * self.strips * self.tiles * self.slices

    @property
    def block(self) -> tuple[int, int]:  # (channel groups, pixels)
        gx = self.chans // 8
        return gx, TOPDOWN_THREADS // gx


def topdown_smem_bytes(rows, cols, chans, src_rows, src_cols,
                       itemsize) -> int:
    """K10u's dynamic shared memory (``csrc/topdown.cu`` ``smem_bytes``):
    the staged s8 source rows (to 16 bytes), the row pass in E
    (``itemsize`` bytes a value) and the strip's and tile's taps."""
    return (-(-src_rows * src_cols * chans // 16) * 16
            + rows * src_cols * chans * itemsize
            + TOPDOWN_TAP_BYTES * (rows + cols))


def _tap_span(idx: np.ndarray, n: int) -> int:
    """The most source rows (or columns) that ``n`` consecutive outputs of
    the tap table ``idx`` (out, 2) reach, from the first's first tap to
    the last's second."""
    first = idx[0::n, 0]
    last = idx[np.minimum(np.arange(0, len(idx), n) + n - 1,
                          len(idx) - 1), 1]
    return int((last - first).max()) + 1


@functools.lru_cache(maxsize=None)
def topdown_plan(h: int, w: int, c: int, itemsize: int = 2) -> TopdownPlan:
    """K10u's launch for q (B, h, w, C) and a lateral of ``itemsize``-byte
    values: strips of TOPDOWN_ROWS output rows; C in the fewest slices of at
    most TOPDOWN_MAX_CHANNELS; the output row in the fewest column tiles
    whose staged rows fit TOPDOWN_SMEM (one tile at the served hops). The
    staged spans are the most any strip or tile reaches in the tap tables
    (``interp_table``): at x2 with align corners, 2 output rows reach at
    most 3 source rows, n output columns ceil((n - 1) / 2) + 2."""
    oh, ow = 2 * h, 2 * w
    rows = min(TOPDOWN_ROWS, oh)
    slices = -(-c // TOPDOWN_MAX_CHANNELS)
    chans = 8 * -(-(c // 8) // slices)
    ridx, _ = interp_table(oh, h)
    cidx, _ = interp_table(ow, w)
    src_rows = _tap_span(ridx, rows)
    tiles = 1
    while True:
        cols = -(-ow // tiles)
        bound = -(-(cols - 1) // 2) + 2  # the columns a tile reaches, at most
        if cols == 1 or topdown_smem_bytes(rows, cols, chans, src_rows,
                                           bound, itemsize) <= TOPDOWN_SMEM:
            break
        tiles += 1
    tiles = -(-ow // cols)
    src_cols = _tap_span(cidx, cols)
    smem = topdown_smem_bytes(rows, cols, chans, src_rows, src_cols,
                              itemsize)
    return TopdownPlan(rows, cols, chans, -(-oh // rows), tiles, slices,
                       src_rows, src_cols, smem)


class _TopdownArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "q", "ua", "lat", "out", "row_idx", "row_w", "col_idx", "col_w")] + [
        (n, ctypes.c_int) for n in (
            "batch", "h", "w", "c", "f32", "rows", "cols", "chans",
            "src_rows", "src_cols", "smem")]


def topdown_kernel(q, ua, lat, dtype=torch.bfloat16):
    """K10u on the card: the contract of ``topdown_reference``, for ``q``
    int8 (B, h, w, C) with C a multiple of 8, ``lat`` (B, 2h, 2w, C) in
    ``dtype`` (bf16 or fp32), ``ua`` an fp32 tensor of one element; its
    launch from ``topdown_plan``."""
    global launches_topdown
    name = "topdown"
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: the CUDA kernel computes in bf16 or fp32, "
                        f"not {dtype}")
    if q.dtype != torch.int8 or q.dim() != 4 or q.shape[-1] % 8 \
            or not q.numel():
        raise TypeError(f"{name}: q must be int8 (B, h, w, C), C a multiple "
                        f"of 8, got {q.dtype} {tuple(q.shape)}")
    b, h, w, c = q.shape
    if lat.dtype != dtype or tuple(lat.shape) != (b, 2 * h, 2 * w, c):
        raise TypeError(f"{name}: lat must be {dtype} {(b, 2 * h, 2 * w, c)}"
                        f", got {lat.dtype} {tuple(lat.shape)}")
    ua = _scalar("ua", ua)
    _build.require_cuda(name, q, lat, ua)
    if q.data_ptr() % 8 or lat.data_ptr() % 16:
        raise ValueError(f"{name}: q must start on an 8-byte and lat on a "
                         "16-byte boundary")
    ri, rw = _interp_tensors(2 * h, h, dtype, q.device)
    ci, cw = _interp_tensors(2 * w, w, dtype, q.device)
    p = topdown_plan(h, w, c, lat.element_size())
    out = torch.empty_like(lat)
    args = _TopdownArgs(
        q=q.data_ptr(), ua=ua.data_ptr(), lat=lat.data_ptr(),
        out=out.data_ptr(), row_idx=ri.data_ptr(), row_w=rw.data_ptr(),
        col_idx=ci.data_ptr(), col_w=cw.data_ptr(), batch=b, h=h, w=w, c=c,
        f32=int(dtype == torch.float32), rows=p.rows, cols=p.cols,
        chans=p.chans, src_rows=p.src_rows, src_cols=p.src_cols,
        smem=p.smem)
    lib = _build.library()
    err = lib.capf_topdown(ctypes.addressof(args), *_build.launch_target(q))
    _build.check(lib, err, name)
    launches_topdown += 1
    return out


def topdown(q, ua, lat, dtype=torch.bfloat16, impl: str = "auto"):
    """Dispatcher: the plain version for a CPU tensor or ``impl="plain"``,
    K10u for any other (which raises unless it is a CUDA tensor)."""
    if impl == "plain" or q.device.type == "cpu":
        return topdown_reference(q, ua, lat, dtype)
    if impl != "auto":
        raise ValueError(f"topdown: impl {impl!r} (auto or plain)")
    return topdown_kernel(q, ua, lat, dtype)
