"""Counterpart of ``experiments/int8_primitives.py`` (``kernel_bitcast`` /
``kernel_slice``): two ways to shift an int8 window by one image row.

The probe packs a 64x48x32 map as 768 rows of 4 pixels x 32 channels (12
rows an image row), builds each row's 192-lane int8 window (left
neighbour's last 32 channels, the row's 128, right neighbour's first 32,
zero at the ends of an image row; clip(round(x * 127 / amax))) and computes
``xwin @ w + roll(xwin, -12) @ w`` (int32, exact). ``csrc/probes.cu``
builds the shifted operand by an address offset (``words=False``) or from
a 4-rows-to-a-word layout shifted by 3 words and unpacked with
``__byte_perm`` (``words=True``, the TPU's int32 bitcast roll). Both forms
share one geometry (blocks of 16 rows x 64 outputs, 96 a call) and read
``w`` (192, 128) as it is: one launch a call.
"""

from __future__ import annotations

import torch

from contextaware_poseformer_tpu_torch.ops import _build
from contextaware_poseformer_tpu_torch.ops.int8_conv import f32_const

M, GROUPS, LANES, K, N = 768, 12, 128, 192, 128
launches = {"offset": 0, "words": 0}


def window(xf: torch.Tensor, amax: torch.Tensor) -> torch.Tensor:
    """The int8 windows (M, 192) of the fp32 rows ``xf`` (M, 128)."""
    grp = torch.arange(xf.shape[0], device=xf.device) % GROUPS
    left = torch.roll(xf, 1, 0)[:, 96:128] * (grp != 0)[:, None]
    right = torch.roll(xf, -1, 0)[:, 0:32] * (grp != GROUPS - 1)[:, None]
    q = torch.div(f32_const(127.0, amax), amax.float())
    win = torch.cat([left, xf, right], dim=1).float() * q
    return torch.clamp(torch.round(win), -127, 127).to(torch.int8)


def window_matmul_reference(xf, w, amax):
    """Plain version: ``xwin @ w + roll(xwin, -12) @ w``, int32 (float64
    products, exact)."""
    xwin = window(xf, amax).double()
    wd = w.double()
    acc = xwin @ wd + torch.roll(xwin, -GROUPS, 0) @ wd
    return torch.round(acc).to(torch.int32)


def window_matmul(xf, w, amax, words=False):
    """The CUDA kernel: ``xf`` fp32 (768, 128), ``w`` int8 (192, 128),
    ``amax`` fp32 scalar -> int32 (768, 128)."""
    name = "window_matmul"
    if xf.shape != (M, LANES) or xf.dtype != torch.float32:
        raise TypeError(f"{name}: xf must be fp32 ({M}, {LANES})")
    if w.shape != (K, N) or w.dtype != torch.int8:
        raise TypeError(f"{name}: w must be int8 ({K}, {N})")
    xf, w = xf.contiguous(), w.contiguous()
    amax = amax.float().reshape(())
    out = torch.empty((M, N), dtype=torch.int32, device=xf.device)
    _build.require_cuda(name, xf, w, amax, out)
    if xf.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"{name}: xf and w must start on a 16-byte "
                         "boundary (16-byte loads)")
    lib = _build.library()
    err = lib.capf_window_matmul(xf.data_ptr(), w.data_ptr(),
                                 amax.data_ptr(), out.data_ptr(), int(words),
                                 *_build.launch_target(xf))
    _build.check(lib, err, name)
    launches["words" if words else "offset"] += 1
    return out
