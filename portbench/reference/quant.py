"""Symmetric linear quantization and its calibration statistic, plain.

A tensor of largest magnitude ``amax`` is held as integers in
[-levels, levels] with the step ``max(amax, 1e-12) / levels``; a weight per
output channel, with the step ``max|w| / levels``. The calibration
statistic is the upper edge of the first of 2048 histogram bins over
[0, max|x|] whose cumulative share reaches the quantile.
"""

from __future__ import annotations

import torch

HIST_BINS = 2048
TINY = 1e-12


def step_of(amax: torch.Tensor, levels: int) -> torch.Tensor:
    return torch.clamp(amax.float(), min=TINY) / levels


def quantize(x: torch.Tensor, step: torch.Tensor, levels: int) -> torch.Tensor:
    """Integers (held in float32) of ``x`` at ``step``, saturated."""
    return torch.clamp(torch.round(x / step), -levels, levels)


def quantize_weight(w: torch.Tensor, levels: int):
    """OIHW weight -> (integers in float32, step per output channel)."""
    wstep = w.abs().amax(dim=(1, 2, 3)) / levels
    return torch.round(w / wstep[:, None, None, None]), wstep


def observed_amax(x: torch.Tensor, quantile: float) -> torch.Tensor:
    """max|x|, or for a quantile below 1 the histogram edge above it."""
    ax = x.abs().reshape(-1).float()
    m = ax.max()
    if quantile >= 1.0:
        return m
    hist = torch.histc(ax, bins=HIST_BINS, min=0.0, max=float(m))
    cum = torch.cumsum(hist.double(), 0) / ax.numel()
    first = int(torch.nonzero(cum >= quantile)[0])
    return (first + 1) * m / HIST_BINS
