"""Seeded weights: one state dict, made on the device in one draw.

Every parameter of ``reference.model.param_specs`` gets N(mean, std) values
of its kind (``reference.model.INIT``): one ``randn`` over all of them from
a generator on the device, then one multiply and one add by per-element
scales. The same dict is handed to the program and to the reference.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.model import init_affine, param_specs


def generator(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed % (2 ** 63))
    return g


def make(cfg, seed: int, device) -> dict[str, torch.Tensor]:
    """name -> float32 tensor on ``device`` for the model of ``cfg``."""
    specs = param_specs(cfg)
    affine = init_affine(specs)
    counts = torch.tensor([math.prod(s) for _, s, _ in specs],
                          device=device)
    means = torch.tensor([m for m, _ in affine], device=device)
    stds = torch.tensor([s for _, s in affine], device=device)
    total = int(counts.sum())
    flat = torch.randn(total, generator=generator(device, seed),
                       device=device)
    flat = (flat * torch.repeat_interleave(stds, counts)
            + torch.repeat_interleave(means, counts))
    out, off = {}, 0
    for name, shape, _ in specs:
        n = math.prod(shape)
        out[name] = flat[off:off + n].view(shape)
        off += n
    return out
