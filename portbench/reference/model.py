"""The whole model, plain: input normalization, the backbone, the lifter;
its parameter list; its calibration; the MPJPE loss and AdamW.

Everything is read from a configuration file of ``portbench/configs``.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import cpn as cpn_ref
from portbench.reference import hrnet as hrnet_ref
from portbench.reference.lifter import Lifter

# (mean, std) of each kind of parameter: the benchmark's seeded weights,
# N(mean, std), std of a kernel over the square root of its fan-in
INIT = {
    "conv": (0.0, 1.0), "bn_scale": (1.0, 0.1), "bn_bias": (0.0, 0.1),
    "kernel": (0.0, 1.0), "offsets_kernel": (0.0, 0.1), "bias": (0.0, 0.02),
    "ln_scale": (1.0, 0.02), "ln_bias": (0.0, 0.02), "embed": (0.0, 0.02),
}


def feature_dims(cfg) -> list[int]:
    bb = cfg["backbone"]
    if bb["kind"] == "cpn":
        return [bb["lateral_channels"]] * 4
    return list(bb["stage4"]["channels"])


def backbone_convs(bb):
    """(name, cin, cout, kernel) of every convolution of the backbone."""
    if bb["kind"] == "cpn":
        return [c[:4] for c in cpn_ref.conv_names(
            bb["resnet_layers"], bb["lateral_channels"], bb["refine_planes"])]
    return [c[:4] for c in hrnet_ref.conv_names(bb)]


def _linear(name, cin, cout, kind="kernel"):
    return [(f"{name}.kernel", (cin, cout), kind),
            (f"{name}.bias", (cout,), "bias")]


def _norm(name, dim):
    return [(f"{name}.scale", (dim,), "ln_scale"),
            (f"{name}.bias", (dim,), "ln_bias")]


def _block(name, dim, ratio):
    hidden = int(dim * ratio)
    return (_norm(f"{name}.norm1", dim)
            + _linear(f"{name}.attn.qkv", dim, 3 * dim)
            + _linear(f"{name}.attn.proj", dim, dim)
            + _norm(f"{name}.norm2", dim)
            + _linear(f"{name}.mlp.fc1", dim, hidden)
            + _linear(f"{name}.mlp.fc2", hidden, dim))


def param_specs(cfg) -> list[tuple[str, tuple[int, ...], str]]:
    """(state-dict name, shape, kind) of every parameter of the model of
    configuration ``cfg``, in the program's naming."""
    bb, lf = cfg["backbone"], cfg["lifter"]
    out = []
    for name, cin, cout, k in backbone_convs(bb):
        pre = f"backbone.{name.replace('.', '_')}"
        out += [(f"{pre}.weight", (cout, cin, k, k), "conv"),
                (f"{pre}.scale", (cout,), "bn_scale"),
                (f"{pre}.bias", (cout,), "bn_bias")]
    d, levels, ratio = lf["embed_dim_ratio"], lf["levels"], lf["mlp_ratio"]
    dims = feature_dims(cfg)
    nh, ns = lf["deform_heads"], lf["deform_samples"]
    lift = _linear("coord_embed", lf["in_chans"], d)
    for lvl, c in enumerate(dims):
        lift += _linear(f"feat_embed_{lvl}", c, d)
    lift.append(("pos_embed", (1, levels + 1, lf["num_joints"], d), "embed"))
    for i in range(lf["depth"] if lf.get("use_deformable", True) else 0):
        pre = f"context_block_{i}"
        lift += _norm(f"{pre}.norm1", d)
        lift += _linear(f"{pre}.attention_weights", d, nh * ns)
        lift += _linear(f"{pre}.sampling_offsets", d, 2 * nh * ns,
                        "offsets_kernel")
        for lvl, c in enumerate(dims):
            lift += _linear(f"{pre}.embed_proj_{lvl}", c, d // nh)
        lift += _norm(f"{pre}.norm2", d)
        lift += _linear(f"{pre}.mlp.fc1", d, int(d * ratio))
        lift += _linear(f"{pre}.mlp.fc2", int(d * ratio), d)
    for kind, dim in (("res", d), ("joint", d * (levels + 1))):
        for i in range(lf["depth"]):
            lift += _block(f"{kind}_block_{i}", dim, ratio)
    lift += _norm("head_norm", d * (levels + 1))
    lift += _linear("head", d * (levels + 1), 3)
    return out + [(f"lifter.{n}", s, k) for n, s, k in lift]


def init_affine(specs):
    """Per parameter (mean, std) of its seeded N(mean, std) values."""
    out = []
    for _, shape, kind in specs:
        mean, std = INIT[kind]
        if kind == "conv":
            std /= math.sqrt(math.prod(shape[1:]))
        elif kind in ("kernel", "offsets_kernel"):
            std /= math.sqrt(shape[0])
        out.append((mean, std))
    return out


def normalize(frames_u8, cfg):
    """uint8 BGR (N, H, W, 3) -> normalized RGB float32 NCHW: less the
    configuration's pixel mean, over its pixel std where it states one."""
    bb = cfg["backbone"]
    x = frames_u8.flip(-1).float() / 255.0 - torch.tensor(
        bb["pixel_mean_rgb"], device=frames_u8.device) / 255.0
    if "pixel_std_rgb" in bb:
        x = x / torch.tensor(bb["pixel_std_rgb"], device=frames_u8.device)
    return x.permute(0, 3, 1, 2)


class Model:
    """The model of configuration ``cfg`` on the weights ``params``.
    ``levels``: 127 (int8) or 7 (the int4 control) for an int8 graph;
    ``quantized`` False runs an int8 graph's backbone all in float."""

    def __init__(self, cfg, params, levels=127, quantized=True):
        self.cfg = cfg
        params = {k: v.float() for k, v in params.items()}
        bb = cfg["backbone"]
        self.int8 = quantized and bb.get("int8", "none") != "none"
        kind = cpn_ref.CPN if bb["kind"] == "cpn" else hrnet_ref.HRNet
        self.backbone = kind(params, bb, levels)
        self.lifter = Lifter(params, cfg["lifter"], cfg["image_shape"])

    @torch.no_grad()
    def calibrate(self, frames_u8, chunk):
        """The calibration pass over ``frames_u8`` in chunks of ``chunk``."""
        for i in range(0, len(frames_u8), chunk):
            self.backbone(normalize(frames_u8[i:i + chunk], self.cfg),
                          "calib")

    def maps(self, frames_u8):
        with torch.no_grad():
            return self.backbone(normalize(frames_u8, self.cfg),
                                 "serve" if self.int8 else "float")

    def __call__(self, frames_u8, kp2d, kp2d_crop, generator=None):
        return self.lifter(kp2d, kp2d_crop, self.maps(frames_u8), generator)


def mpjpe(pred, gt):
    return torch.linalg.vector_norm(pred - gt, dim=-1).mean()


class AdamW:
    """AdamW with decoupled weight decay: p <- p (1 - lr wd), then the Adam
    step with bias-corrected moments."""

    def __init__(self, params, lr, weight_decay, betas=(0.9, 0.999),
                 eps=1e-8):
        self.params = params  # name -> tensor (leaf, requires grad)
        self.lr, self.wd, self.betas, self.eps = lr, weight_decay, betas, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self):
        self.t += 1
        b1, b2 = self.betas
        for k, p in self.params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            p.mul_(1 - self.lr * self.wd)
            mhat = self.m[k] / (1 - b1 ** self.t)
            vhat = self.v[k] / (1 - b2 ** self.t)
            p.sub_(self.lr * mhat / (vhat.sqrt() + self.eps))
