"""The int8 HRNet layer1 (K9): CUDA kernel wrapper, plain version and
dispatcher.

Port of ``contextaware_poseformer_tpu/ops/layer1_chain.py`` (the Pallas
kernel ``_kernel``, 51-113) and of the per-conv chain it replaces,
``HRNet._layer1_int8`` (``models/hrnet.py:138-162``): four Bottleneck
blocks (planes 64, expansion 4, block 0 with a 1x1 downsample) on int8
tensors with static calibrated scales:

    xq = quant(x, in)                              bf16 stem (B, H, W, 64)
    per block: t1 = quant(relu(conv1(xq)), t1)     1x1 -> 64
               t2 = quant(relu(conv2(t1)), t2)     3x3 -> 64
               y = conv3(t2)                       1x1 -> 256
               res = downsample(xq) (block 0) or bf16(xq) * bf16(in / 127)
               xq = quant(relu(y + res), out)      int8 (B, H, W, 256)

``quant(t, amax) = clip(round(t * (127 / amax)), -127, 127)`` multiplies
where ConvBN's dynamic route divides, each conv is K10's contract on an
int8 input (int32 accumulation, the bf16 affine ``bf16(scale * wscale *
amax / 127)``), and every amax is clamped to >= 1e-12. The layer1 path
therefore agrees with K10's per-conv chain bit for bit.

The TPU kernel keeps one image's whole chain in VMEM; one image's
256-channel int8 tensor (786 KB at 64x48) exceeds a Hopper block's 227 KB
of shared memory, so ``csrc/layer1_chain.cu`` launches once per block: a
persistent grid whose blocks stage the block's weights once and walk strips
of whole rows of one image, 64 pixels a step, carrying t1's halo from step
to step and loading the next input tiles while the products run; only the
block's input and output touch device memory. ``plan`` picks the strip,
the grid and the input ring's depth.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from contextaware_poseformer_tpu_torch.ops import _build, int8_conv
from contextaware_poseformer_tpu_torch.ops.int8_conv import quant_reference

launches = 0  # kernel launches made by layer1_block_kernel (4 a chain)
launches_floor = 0  # launches of its floor build (a probe's counterpart)

PLANES = 64
EXPANSION = 256
TILE = 64  # pixels a step of csrc/layer1_chain.cu (wgmma's M)
# input tiles in flight ahead of the step: 2 and 3 measured no faster on an
# H100 (tools/torch_kernel_ab.py --sweep)
DEPTH = 1
SMS = 132  # H100 SXM: the grid's bound when the card is not asked


@dataclass(frozen=True)
class Plan:
    strip_rows: int  # whole rows of one image a block walks in order
    strips: int  # batch * ceil(H / strip_rows)
    grid: int  # persistent blocks, min(strips, SMs)
    lead: int  # t1 tiles conv1 runs ahead: ceil((W + 1) / 64)
    depth: int  # input tiles in flight ahead of the step
    smem: int  # dynamic shared memory a block takes


def smem_bytes(cin: int, lead: int, depth: int) -> int:
    """Dynamic shared memory one block of csrc/layer1_chain.cu takes
    (mirrors ``layer1_layout`` there): w1 (swizzled chunks of 8 KB), w3 and
    wd in one 32 KB region, the input ring (lead + 1 + depth tiles of 64
    pixels: bf16 64 or int8 256 channels), t2 (8 KB), w2 and t1's ring of
    2 lead + 1 tiles in rows padded by 16 bytes, a zero row, the staged
    output tile, the bf16 folded scales and biases, and 1 KB to align the
    base."""
    stage = TILE * (2 * PLANES if cin == PLANES else EXPANSION)
    return (8192 * (1 if cin == PLANES else 2) + EXPANSION * 128
            + (lead + 1 + depth) * stage + 8192
            + PLANES * (9 * PLANES + 16)
            + (2 * lead + 1) * TILE * (PLANES + 16) + (PLANES + 16)
            + TILE * (EXPANSION + 16) + 2 * (4 * PLANES + 4 * EXPANSION)
            + 1024)


def plan(batch: int, h: int, w: int, cin: int, sms: int = SMS) -> Plan:
    """The schedule of one launch: the strip length that minimises the
    steps of the slowest block (waves of strips x (tiles a strip + 2 lead
    tiles of conv1 ahead of its first output)), then the steps of all
    blocks together; an input ring DEPTH tiles deep. ValueError for a shape
    whose layout fits no block."""
    if min(batch, h, w) < 1 or cin not in (PLANES, EXPANSION):
        raise ValueError(f"layer1_chain: no schedule for batch {batch}, "
                         f"{h}x{w}x{cin}")
    lead = -(-(w + 1) // TILE)
    smem = smem_bytes(cin, lead, DEPTH)
    if smem > _build.SMEM_LIMIT:
        raise ValueError(f"layer1_chain: width {w} needs {smem} bytes of "
                         f"shared memory, more than a block has")
    best = None
    for rows in range(1, h + 1):
        strips = batch * -(-h // rows)
        steps = -(-rows * w // TILE) + 2 * lead
        waves = -(-strips // sms)
        key = (waves * steps, strips * steps)
        if best is None or key < best[0]:
            best = (key, rows, strips)
    _, rows, strips = best
    return Plan(rows, strips, min(strips, sms), lead, DEPTH, smem)


def layer1_int8_chain(x, in_amax, blocks, conv=int8_conv.int8_conv,
                      quant=quant_reference):
    """The per-conv chain (the JAX package's ``layer1_impl="xla"``):
    ``x`` (B, H, W, 64) float -> int8 (B, H, W, 256), each conv through
    ``conv`` (K10's dispatcher, or its plain version) and each quantize
    through ``quant`` (K10q's dispatcher ``int8_conv.quant``, or its plain
    version). ``blocks``: four dicts with the (kernel_q, wscale, scale,
    bias) pieces of ``conv1``, ``conv2``, ``conv3`` and ``downsample``
    (block 0 only, else None) and the calibrated amax scalars ``t1``,
    ``t2`` and ``out``."""
    dtype = x.dtype
    a = in_amax
    xq = quant(x, a)
    for blk in blocks:
        y = conv(xq, *blk["conv1"], a, 1, True, dtype)
        y = conv(quant(y, blk["t1"]), *blk["conv2"], blk["t1"], 1, True,
                 dtype)
        y = conv(quant(y, blk["t2"]), *blk["conv3"], blk["t2"], 1, False,
                 dtype)
        if blk["downsample"] is not None:
            res = conv(xq, *blk["downsample"], a, 1, False, dtype)
        else:
            res = int8_conv.dequant(xq, a, dtype)
        a = blk["out"]
        xq = quant(torch.relu(y + res), a)
    return xq


def layer1_chain_reference(x, in_amax, blocks):
    """Plain version: the per-conv chain through K10's plain version."""
    return layer1_int8_chain(x, in_amax, blocks,
                             int8_conv.int8_conv_reference)


class _BlockArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "x", "out", "w1", "w2", "w3", "wd",
        "ws1", "sc1", "bi1", "ws2", "sc2", "bi2", "ws3", "sc3", "bi3",
        "wsd", "scd", "bid", "a_in", "a_t1", "a_t2", "a_out")] + [
        (n, ctypes.c_int) for n in ("batch", "h", "w", "cin", "strip_rows",
                                    "lead", "depth", "grid")]


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _vec(name, t, n):
    if t.dtype != torch.float32 or t.shape != (n,):
        raise TypeError(f"layer1_chain: {name} must be fp32 ({n},), got "
                        f"{t.dtype} {tuple(t.shape)}")
    return t


def layer1_block_kernel(x, in_amax, blk, out=None, floor=False):
    """One launch of the CUDA kernel: Bottleneck block ``blk`` (a dict as
    in ``layer1_int8_chain``) on ``x``, bf16 (B, H, W, 64) for block 0
    (with a downsample) or int8 (B, H, W, 256) with its amax ``in_amax``;
    returns int8 (B, H, W, 256), written into ``out`` when given. ``floor``
    launches the floor build (the TPU probe ``layer1_chain_floor``: the
    same MMAs and epilogues without the requant and window stages, wrong
    numerics on purpose), counted apart in ``launches_floor``."""
    global launches, launches_floor
    name = "layer1_chain"
    first = x.dtype == torch.bfloat16
    cin = PLANES if first else EXPANSION
    if x.dim() != 4 or x.shape[-1] != cin or x.dtype not in (
            torch.bfloat16, torch.int8):
        raise TypeError(f"{name}: x must be bf16 (B, H, W, {PLANES}) or "
                        f"int8 (B, H, W, {EXPANSION}), got {x.dtype} "
                        f"{tuple(x.shape)}")
    b, h, w, _ = x.shape
    shapes = {"conv1": (PLANES, cin), "conv2": (PLANES, 9 * PLANES),
              "conv3": (EXPANSION, PLANES), "downsample": (EXPANSION, PLANES)}
    pieces = {}
    for conv, (o, k) in shapes.items():
        p = blk[conv]
        if (p is None) == (conv != "downsample" or first):
            raise ValueError(f"{name}: {conv} is "
                             f"{'missing' if p is None else 'unexpected'} "
                             f"on a {x.dtype} input (only block 0, on the "
                             "bf16 stem output, has a downsample)")
        if p is None:
            continue
        kq, ws, sc, bi = p
        if kq.dtype != torch.int8 or kq.shape != (o, k):
            raise TypeError(f"{name}: {conv} kernel {kq.dtype} "
                            f"{tuple(kq.shape)}, expected int8 ({o}, {k})")
        pieces[conv] = (kq, *(_vec(conv, v, o) for v in (ws, sc, bi)))
    amax = [in_amax.float(), blk["t1"].float(), blk["t2"].float(),
            blk["out"].float()]
    if out is None:
        out = torch.empty((b, h, w, EXPANSION), dtype=torch.int8,
                          device=x.device)
    tensors = [x, out, *amax] + [t for p in pieces.values() for t in p]
    _build.require_cuda(name, *tensors)
    sched = plan(b, h, w, cin, _sms(x.device))
    if any(t.data_ptr() % 16 for t in (x, out, *(p[0] for p in
                                                 pieces.values()))):
        raise ValueError(f"{name}: activations and kernels must start on a "
                         "16-byte boundary (16-byte loads)")

    def ptrs(conv):
        p = pieces.get(conv)
        return [None] * 4 if p is None else [t.data_ptr() for t in p]

    (w1, ws1, sc1, bi1), (w2, ws2, sc2, bi2), (w3, ws3, sc3, bi3), \
        (wd, wsd, scd, bid) = (ptrs(c) for c in shapes)
    args = _BlockArgs(
        x.data_ptr(), out.data_ptr(), w1, w2, w3, wd,
        ws1, sc1, bi1, ws2, sc2, bi2, ws3, sc3, bi3, wsd, scd, bid,
        *(a.data_ptr() for a in amax), b, h, w, cin, sched.strip_rows,
        sched.lead, sched.depth, sched.grid)
    lib = _build.library()
    entry = lib.capf_layer1_block_floor if floor else lib.capf_layer1_block
    err = entry(ctypes.addressof(args), *_build.launch_target(x))
    _build.check(lib, err, name)
    if floor:
        launches_floor += 1
    else:
        launches += 1
    return out


def layer1_chain_kernel(x, in_amax, blocks, floor=False):
    """The CUDA kernel: one launch per block, same contract as
    ``layer1_chain_reference`` for a bf16 ``x`` (``floor``: the floor
    build, see ``layer1_block_kernel``)."""
    if x.dtype != torch.bfloat16 or x.dim() != 4 or x.shape[-1] != PLANES:
        raise TypeError(f"layer1_chain: x must be bf16 (B, H, W, {PLANES}), "
                        f"got {x.dtype} {tuple(x.shape)}")
    if len(blocks) != 4:
        raise ValueError(f"layer1_chain: 4 blocks, got {len(blocks)}")
    b, h, w, _ = x.shape
    bufs = [torch.empty((b, h, w, EXPANSION), dtype=torch.int8,
                        device=x.device) for _ in range(2)]
    src, a_in = x, in_amax
    for i, blk in enumerate(blocks):
        src = layer1_block_kernel(src, a_in, blk, bufs[i % 2], floor)
        a_in = blk["out"]
    return src


def layer1_chain(x, in_amax, blocks, impl: str = "auto"):
    """Dispatcher: the plain version for a CPU tensor or ``impl="plain"``,
    the CUDA kernel for any other (which raises unless it is a CUDA
    tensor)."""
    if impl == "plain" or x.device.type == "cpu":
        return layer1_chain_reference(x, in_amax, blocks)
    if impl != "auto":
        raise ValueError(f"layer1_chain: impl {impl!r} (auto or plain)")
    return layer1_chain_kernel(x, in_amax, blocks)
