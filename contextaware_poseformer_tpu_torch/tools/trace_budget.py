"""Attribute every device microsecond of a ``torch.profiler`` trace to a
named bucket.

The port's counterpart of the JAX package's ``tools/trace_budget.py``: the
named buckets must cover at least 95% of device time, and the tool exits 2
when they do not, listing the kernels it could not place. The fallback
buckets (``CATCH_ALL``: a kernel launched inside the backbone, the lifter
or the model but in none of their named parts) count against that share
as the unattributed time does, and are reported beside it::

  python -m contextaware_poseformer_tpu_torch.tools.trace_budget \\
      trace.json [iters] [--json out.json]

A trace names its kernels but not the modules that launched them, so the
profiled code runs under ``annotate(model)``: forward hooks (registered by
this tool; no model code changes) push a ``record_function`` range
``nn:<module path>`` around every module's forward, and a few functions
outside the model (the input normalization, augmentation, the loss, the
optimizer step) run inside ``fn:<name>`` ranges. Each kernel, memcpy and
memset on the device is joined to its launch on the host through the
trace's correlation ids, and the launch to the ranges around it on its
thread. A kernel named for its function (the samplers, K2-K4, the int8
kernels; the CPN's fold-normalize stem K10s takes "backbone stem", whatever
conv computes it, and its s8 top-down hop K10u a bucket of its own) takes
that function's bucket; any other takes the bucket of its
innermost range: an ``nn:`` module's by ``RULES``, an ``fn:`` function's
name (the CPN's pooling, quantization and bilinear resizes, called between
its modules, have ranges of their own, and each of its bottlenecks, a
method, has an ``nn:`` range named as the module path the block would
have, so that its residual add and ReLU take its layer's bucket). Kernels
launched by the autograd engine (a thread with no module ranges) go to
"backward (lifter)": every preset freezes the backbone, so the lifter's is
the only backward. Those inside the optimizer's step go to "optimizer",
and memory copies and fills to "copies".
"""

from __future__ import annotations

import collections
import contextlib
import functools
import gzip
import json
import sys

import torch

# (bucket, substrings of the kernel name); first match wins
KERNEL_RULES: list[tuple[str, tuple[str, ...]]] = [
    ("int8 quantize", ("int8_quantize_kernel", "int8_quant_pool_kernel")),
    ("backbone stem", ("stem_conv_kernel",)),
    ("globalNet top-down (K10u)", ("topdown_kernel",)),
    ("backbone layer1", ("layer1_block_kernel",)),
    ("sampler backward", ("sample_levels_bwd", "grid_sampler_2d_backward")),
    ("sampler", ("sample_levels", "aggregate_kernel", "grid_sampler")),
    ("lifter attention", ("small_attention", "attention_bf16",
                          "attention_fp32")),
    ("lifter MLP/LN", ("ln_mlp", "ln_fc1", "fc2_residual")),
]
# (bucket, substrings of the innermost module path); first match wins
RULES: list[tuple[str, tuple[str, ...]]] = [
    ("backbone stem", ("backbone.conv1", "backbone.conv2",
                       "backbone.resnet_conv1")),
    ("backbone layer1", ("layer1",)),
    ("backbone layer2", ("layer2",)),
    ("backbone layer3", ("layer3",)),
    ("backbone layer4", ("layer4",)),
    ("globalNet", ("global_net",)),
    ("refineNet", ("refine_net",)),
    ("HRNet transitions+fuse", ("transition", "fuse_layers")),
    ("HRNet stage2", ("stage2",)),
    ("HRNet stage3", ("stage3",)),
    ("HRNet stage4", ("stage4",)),
    ("backbone other", ("backbone",)),
    ("lifter attention", (".attn",)),
    ("lifter MLP/LN", (".mlp", ".norm")),
    ("lifter embed/head", ("embed", "head", "pos_drop")),
    ("lifter deformable", ("context_block",)),
    ("lifter blocks (residual, drop-path)", ("res_block", "joint_block")),
    ("lifter other", ("lifter",)),
    ("model glue (casts, reference grid)", ("<model>",)),
]
# the fallback buckets of RULES: a kernel in a model part no rule names
CATCH_ALL = ("backbone other", "lifter other",
             "model glue (casts, reference grid)")
DEVICE_CATEGORIES = {"kernel": None, "gpu_memcpy": "copies",
                     "gpu_memset": "copies"}
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
RANGE_CATEGORIES = ("user_annotation", "cpu_op")
BACKWARD = "backward (lifter)"
OPTIMIZER = "optimizer"
UNATTRIBUTED = "UNATTRIBUTED"
MIN_COVERAGE = 0.95
TOP = 3  # kernels named a bucket


def _wrapped(label, fn, paths):
    """``fn`` inside a range named ``label``, or, for a callable label,
    ``label(paths, args)`` (``paths``: a module's id -> its path)."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        name = label(paths, args) if callable(label) else label
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)

    return run


def _block(arg: int):
    """The range label of a CPN bottleneck method whose block name (its
    scales' prefix, e.g. ``resnet.layer2.0``) is argument ``arg``: the
    path the block would have as a module, so that its residual add and
    ReLU, run between its convolutions, take its layer's bucket."""
    return lambda paths, args: f"nn:{paths.get(id(args[0]), '?')}.{args[arg]}"


def default_functions() -> list[tuple[object, str, object]]:
    """(owner, attribute, range label) of the functions outside the model
    that ``annotate`` times: the serving and training input paths (looked
    up by name where they are called), the training losses, the
    optimizer's step, and the CPN's bottlenecks and the functions its
    forward calls between its modules."""
    from contextaware_poseformer_tpu_torch.data import augment
    from contextaware_poseformer_tpu_torch.models import cpn
    from contextaware_poseformer_tpu_torch.train import losses, steps

    out = [(augment, "serving_images", "fn:input normalize"),
           (steps, "augmented_batch", "fn:input (normalize, augment)"),
           (steps.Optimizer, "step", f"fn:{OPTIMIZER}"),
           (cpn, "max_pool_3x3_s2", "fn:backbone stem"),
           (cpn, "quant", "fn:int8 quantize"),
           (cpn, "quant_max_pool_3x3_s2", "fn:int8 quantize"),
           (cpn, "resize_bilinear_align_corners",
            "fn:bilinear resize (globalNet, refineNet)"),
           (cpn.CPN, "_fold_stem", "fn:backbone stem"),
           (cpn.CPN, "_bottleneck", _block(2)),
           (cpn.CPN, "_bottleneck_i8", _block(3))]
    out += [(losses.LOSSES, name, "fn:loss") for name in losses.LOSSES]
    return out


@contextlib.contextmanager
def annotate(model: torch.nn.Module, functions=None):
    """Within the block, every module of ``model`` runs inside a
    ``record_function("nn:<path>")`` range (the root: ``nn:<model>``) and
    each of ``functions`` (default ``default_functions()``) inside its
    label's range (a callable label names it from the module paths and
    the call's arguments); all is undone on exit."""
    functions = default_functions() if functions is None else functions
    handles, saved = [], []
    paths = {id(m): name or "<model>" for name, m in model.named_modules()}
    for name, module in model.named_modules():
        label = f"nn:{name or '<model>'}"

        def enter(mod, args, label=label):
            rf = torch.profiler.record_function(label)
            rf.__enter__()
            mod.__dict__.setdefault("_budget_ranges", []).append(rf)

        def leave(mod, args, out):
            mod.__dict__["_budget_ranges"].pop().__exit__(None, None, None)

        handles.append(module.register_forward_pre_hook(enter))
        handles.append(module.register_forward_hook(leave, always_call=True))
    try:
        for owner, attr, label in functions:
            if isinstance(owner, dict):
                saved.append((owner, attr, owner[attr]))
                owner[attr] = _wrapped(label, owner[attr], paths)
            else:
                saved.append((owner, attr, getattr(owner, attr)))
                setattr(owner, attr,
                        _wrapped(label, getattr(owner, attr), paths))
        yield model
    finally:
        for h in handles:
            h.remove()
        for module in model.modules():
            module.__dict__.pop("_budget_ranges", None)
        for owner, attr, fn in reversed(saved):
            if isinstance(owner, dict):
                owner[attr] = fn
            else:
                setattr(owner, attr, fn)


def load_trace(path: str) -> dict:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def _enclosing(ranges, launches):
    """For each launch (time, key) on one thread, the names of the ranges
    around it, outermost first: one sweep over both sorted by time."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    out, stack, i = {}, [], 0
    for t, key in sorted(launches):
        while i < len(ranges) and ranges[i][0] <= t:
            start, end, name = ranges[i]
            while stack and stack[-1][1] < start:
                stack.pop()
            stack.append((start, end, name))
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[key] = [name for s, e, name in stack if s <= t <= e]
    return out


def classify(kernel: str, around: list[str]) -> str:
    """The bucket of a device event named ``kernel`` (its category's bucket
    for a copy) whose launch ran inside the ranges ``around``."""
    low = kernel.lower()
    for bucket, needles in KERNEL_RULES:
        if any(n in low for n in needles):
            return bucket
    if any(n.startswith(f"fn:{OPTIMIZER}") or n.startswith("Optimizer.step")
           for n in around):
        return OPTIMIZER
    if any(n.startswith("autograd::engine::evaluate_function")
           for n in around):
        return BACKWARD
    for name in reversed(around):  # the innermost module or function
        if name.startswith("fn:"):
            return name[3:]
        if name.startswith("nn:"):
            return next((bucket for bucket, needles in RULES
                         if any(n in name[3:] for n in needles)),
                        UNATTRIBUTED)
    return UNATTRIBUTED


def budget(trace: dict) -> dict:
    """Device microseconds by bucket over a Chrome trace of
    ``torch.profiler``: ``{"buckets", "total_us", "coverage", "catch_all",
    "named", "unattributed", "top"}`` (``coverage``: the share of device
    time in any bucket; ``catch_all``: in the ``CATCH_ALL`` buckets;
    ``named``: in the others, the share the 95% rule reads;
    ``unattributed``: kernel name -> microseconds; ``top``: each bucket's
    TOP kernels by time)."""
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    launches = {}  # correlation id -> (pid, tid, ts)
    ranges = collections.defaultdict(list)  # (pid, tid) -> (start, end, name)
    device = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATEGORIES:
            device.append(e)
        elif cat in LAUNCH_CATEGORIES and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (e["pid"], e["tid"], e["ts"])
        elif cat in RANGE_CATEGORIES:
            ranges[(e["pid"], e["tid"])].append(
                (e["ts"], e["ts"] + e.get("dur", 0), e.get("name", "")))
    by_thread = collections.defaultdict(list)
    for corr, (pid, tid, ts) in launches.items():
        by_thread[(pid, tid)].append((ts, corr))
    around = {}
    for thread, ls in by_thread.items():
        around.update(_enclosing(ranges.get(thread, []), ls))
    buckets = collections.Counter()
    kernels = collections.defaultdict(collections.Counter)
    for e in device:
        dur = e.get("dur", 0)
        name = e.get("name", "")
        bucket = DEVICE_CATEGORIES[e["cat"]] or classify(
            name, around.get(e.get("args", {}).get("correlation"), []))
        buckets[bucket] += dur
        kernels[bucket][name] += dur
    total = sum(buckets.values())
    coverage = 1.0 - buckets[UNATTRIBUTED] / total if total else 0.0
    catch_all = sum(buckets[b] for b in CATCH_ALL) / total if total else 0.0
    return {"buckets": dict(buckets.most_common()), "total_us": total,
            "coverage": coverage, "catch_all": catch_all,
            "named": coverage - catch_all,
            "unattributed": dict(kernels[UNATTRIBUTED].most_common()),
            "top": {b: kernels[b].most_common(TOP) for b in buckets}}


def report(result: dict, iters: int = 1, top: int = 25) -> str:
    total = max(result["total_us"], 1e-9)
    lines = [f"device total: {result['total_us'] / iters / 1e3:.3f} ms/iter "
             f"({iters} iters)", f"{'bucket':40s} {'us/iter':>10s} "
             f"{'%':>6s}"]
    for b, d in result["buckets"].items():
        lines.append(f"{b:40s} {d / iters:10.1f} {d / total * 100:6.2f}")
        lines += [f"    {k / iters:10.1f} us  {n[:80]}"
                  for n, k in result["top"].get(b, [])]
    lines.append(f"attributed coverage: {result['coverage'] * 100:.2f}%, "
                 f"of which {result['catch_all'] * 100:.2f}% in the "
                 f"fallback buckets; named {result['named'] * 100:.2f}%")
    if result["unattributed"]:
        lines.append("top unattributed kernels (tighten the rules):")
        lines += [f"{d / iters:10.1f} us/it  {n[:90]}" for n, d in
                  list(result["unattributed"].items())[:top]]
    return "\n".join(lines)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    json_out = None
    if "--json" in argv:
        i = argv.index("--json")
        json_out = argv[i + 1]
        del argv[i:i + 2]
    if not argv:
        raise SystemExit(__doc__)
    iters = int(argv[1]) if len(argv) > 1 else 1
    result = budget(load_trace(argv[0]))
    print(report(result, iters))
    if json_out:
        with open(json_out, "w") as f:
            json.dump({"trace": argv[0], "iters": iters, **result}, f,
                      indent=1)
        print(f"wrote {json_out}")
    return 0 if result["named"] >= MIN_COVERAGE else 2


if __name__ == "__main__":
    sys.exit(main())
