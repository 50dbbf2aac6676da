"""Build and bind the hand-written Hopper kernels under ``ops/csrc``.

Each ``csrc/*.cu`` file compiles with its own ``nvcc``, all started
together, and the objects link into ONE shared library with a plain C
interface, loaded through ``ctypes`` (no PyTorch headers, so a build takes
seconds rather than minutes). The library lands in ``build/kernels/``
at the repository root, named by a hash of the sources and the compiler
flags, so an edited source rebuilds and an unchanged one is reused. The build
runs at first use: importing this module compiles nothing, which keeps every
``ops`` module importable on a machine without ``nvcc`` or a GPU.

Each kernel entry point takes raw device pointers (``tensor.data_ptr()``) and
the caller's CUDA stream, launches on that stream without synchronising, and
returns ``cudaGetLastError()`` after the launch; ``check`` turns a non-zero
code into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
import weakref
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# ctypes signature of every exported function: (restype, argtypes)
_P = ctypes.c_void_p
_I = ctypes.c_int
SIGNATURES = {
    "capf_error_string": (ctypes.c_char_p, [_I]),
    # (device, stream): the empty kernel
    "capf_empty": (_I, [_I, _P]),
    # (args struct*, device, stream)
    "capf_sample_levels": (_I, [_P, _I, _P]),
    # (args struct*, device, stream)
    "capf_sample_levels_bwd": (_I, [_P, _I, _P]),
    # (args struct*, device, stream)
    "capf_deformable_aggregate": (_I, [_P, _I, _P]),
    # (args struct*, device, stream)
    "capf_ln_mlp_residual": (_I, [_P, _I, _P]),
    # (dtype, x, wqkv, bqkv, wproj, bproj, out, rows, tokens, d, heads,
    #  heads a group, device, stream)
    "capf_small_attention": (
        _I, [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    # (dtype, qkv, out, batch, tokens, d, heads, heads a block, device,
    #  stream)
    "capf_attention_middle": (_I, [_I, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    # (args struct*, device, stream)
    "capf_int8_conv": (_I, [_P, _I, _P]),
    # (args struct*, mode, device, stream)
    "capf_int8_conv_probe": (_I, [_P, _I, _I, _P]),
    # (args struct*, device, stream)
    "capf_int8_requant": (_I, [_P, _I, _P]),
    # (x, amax, out, n, form, device, stream); x bf16, or fp32 (_f32)
    "capf_int8_quantize": (_I, [_P, _P, _P, ctypes.c_longlong, _I, _I, _P]),
    "capf_int8_quantize_f32": (_I, [_P, _P, _P, ctypes.c_longlong, _I, _I,
                                    _P]),
    # (x, amax, out, batch, h, w, c, rows, device, stream); x bf16, or fp32
    "capf_int8_quant_pool": (_I, [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "capf_int8_quant_pool_f32": (_I, [_P, _P, _P, _I, _I, _I, _I, _I, _I,
                                      _P]),
    # (args struct*, device, stream)
    "capf_layer1_block": (_I, [_P, _I, _P]),
    "capf_layer1_block_floor": (_I, [_P, _I, _P]),
    # (xf, w, amax, out, words, device, stream)
    "capf_window_matmul": (_I, [_P, _P, _P, _P, _I, _I, _P]),
    # (args struct*, device, stream)
    "capf_stem_conv": (_I, [_P, _I, _P]),
    # (args struct*, device, stream)
    "capf_topdown": (_I, [_P, _I, _P]),
    # (y, scale, bias, residual, out, pixels, c, dtype, relu, width,
    #  stride, blocks, device, stream)
    "capf_conv_epilogue": (_I, [_P, _P, _P, _P, _P, ctypes.c_longlong, _I,
                                _I, _I, _I, ctypes.c_longlong, _I, _I, _P]),
}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
FLOATS = (torch.float32, torch.bfloat16)  # what most kernels take
SMEM_LIMIT = 227 * 1024  # dynamic shared memory one H100 block may use


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels can only be built on a machine with the CUDA toolkit"
    )


def library_path() -> Path:
    return BUILD_DIR / f"libcapf_kernels_{source_hash()}.so"


def build() -> tuple[Path, float]:
    """Compile the kernels if the hashed library is missing.

    Returns (library path, build seconds; 0.0 when it already existed). The
    compiler's output (``-Xptxas -v``: registers, shared memory and spills
    per kernel) is kept beside the library as ``<name>.log``.
    """
    out = library_path()
    if out.exists():
        return out, 0.0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        try:
            for src in sorted(CSRC.glob("*.cu")):
                obj = os.path.join(tmp, src.stem + ".o")
                objs.append(obj)
                procs.append(subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", obj,
                     str(src)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True,
                ))
            logs = [(p, p.communicate()[0]) for p in procs]
        finally:
            for p in procs:  # a failed start leaves no compiler running
                if p.poll() is None:
                    p.kill()
                    p.wait()
        so = os.path.join(tmp, "lib.so")
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", so, *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ) if all(p.returncode == 0 for p, _ in logs) else None
        text = "".join(log for _, log in logs) + (link.stdout if link else "")
        out.with_suffix(".log").write_text(text)
        if link is None or link.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{text[-8000:]}")
        os.replace(so, out)  # atomic: a reader never sees half a library
    return out, time.perf_counter() - t0


def bind(path: str | os.PathLike) -> ctypes.CDLL:
    """Load a kernel library and declare every entry point's signature."""
    lib = ctypes.CDLL(str(path))
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The bound kernel library, built on first use."""
    path, _ = build()
    return bind(path)


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.capf_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def empty_kernel(device: torch.device) -> None:
    """Launch the library's empty kernel on ``device``'s current stream:
    the launch floor that a timer of these kernels reads."""
    lib = library()
    index = device.index if device.index is not None else 0
    check(lib, lib.capf_empty(
        index, torch.cuda.current_stream(device).cuda_stream), "empty")


def launch_target(t: torch.Tensor) -> tuple[int, int]:
    """(device index, handle of that device's current stream) for a launch
    on the tensor's device. The raw handle, as PyTorch's compiled code
    reads it: ``torch.cuda.current_stream`` builds a ``Stream`` object on
    every call, some microseconds a launch of host time."""
    index = t.get_device()
    return index, torch._C._cuda_getCurrentRawStream(index)


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """The checks every kernel wrapper makes before it launches: the tensors
    lie on ONE CUDA device and are contiguous. (Gradients reach a kernel
    only through its wrapper's ``torch.autograd.Function``.)"""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(
                f"{name}: the CUDA kernel needs every tensor on one CUDA "
                f"device, got {t.device} beside {dev}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor of shape {tuple(t.shape)} "
                             "is not contiguous")


def needs_grad(*tensors) -> bool:
    """True when autograd would record a graph through any of the tensors
    (``None`` entries are skipped)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


class PlainVjp(torch.autograd.Function):
    """A kernel call whose backward is its plain version's VJP: the forward
    runs ``kernel(*args)``; the backward recomputes ``plain(*args)`` under
    autograd and differentiates it, as the JAX package's ``custom_vjp``s of
    K2-K4 run their jnp reference in the backward. Non-tensor arguments
    (eps, head counts) pass through as they are."""

    @staticmethod
    def forward(ctx, kernel, plain, *args):
        ctx.plain = plain
        ctx.args = [None if isinstance(a, torch.Tensor) else a for a in args]
        ctx.slots = [i for i, a in enumerate(args)
                     if isinstance(a, torch.Tensor)]
        ctx.save_for_backward(*(args[i] for i in ctx.slots))
        return kernel(*args)

    @staticmethod
    def backward(ctx, grad):
        args = list(ctx.args)
        wrt = []
        for i, t in zip(ctx.slots, ctx.saved_tensors):
            args[i] = t.detach().requires_grad_(ctx.needs_input_grad[2 + i])
            if args[i].requires_grad:
                wrt.append(i)
        grads = [None] * len(args)
        with torch.enable_grad():
            out = ctx.plain(*args)
            found = torch.autograd.grad(out, [args[i] for i in wrt], grad,
                                        allow_unused=True)
        for i, g in zip(wrt, found):
            grads[i] = g
        return (None, None, *grads)


# (id(tensor), tag) -> (weak reference, _version, data_ptr, operand)
_OPERANDS: dict[tuple, tuple] = {}


def cached_operand(w: torch.Tensor, tag, make) -> torch.Tensor:
    """``make(w)`` (a kernel's operand made from parameter ``w``: a cast, a
    transpose, a permutation), computed once per parameter state: cached by
    the tensor itself (a weak reference), ``tag`` (what is made) and its
    ``_version`` and data pointer, so an in-place update (an optimizer step,
    a ``copy_``) makes it anew. A tensor made under
    ``torch.inference_mode()`` has no version counter and is made on every
    call."""
    if w.is_inference():
        with torch.no_grad():
            return make(w.detach())
    key = (id(w), tag)
    hit = _OPERANDS.get(key)
    if (hit is not None and hit[0]() is w and hit[1] == w._version
            and hit[2] == w.data_ptr()):
        return hit[3]
    with torch.no_grad():
        made = make(w.detach())
    ref = weakref.ref(w, lambda _, key=key: _OPERANDS.pop(key, None))
    _OPERANDS[key] = (ref, w._version, w.data_ptr(), made)
    return made


def dtype_code(name: str, dtype: torch.dtype, accepted=FLOATS) -> int:
    """The kernel's code for ``dtype`` (``common.cuh``'s ``DType``), or a
    TypeError when the kernel does not take it."""
    if dtype not in accepted:
        names = ", ".join(str(d).removeprefix("torch.") for d in accepted)
        raise TypeError(f"{name}: the CUDA kernel takes {names}, got {dtype}")
    return DTYPE_CODES[dtype]
