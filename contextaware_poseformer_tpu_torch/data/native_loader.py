"""ctypes bindings for the native C++ batch loader: the port's copy of
``contextaware_poseformer_tpu/data/native_loader.py``.

One GIL-free call decodes + affine-crops a whole batch on a C++ thread pool.
The library builds on first use with g++ from the repository's
``native/fastloader.cpp`` into ``build/native/`` (gitignored).

Selection policy: cv2's imread (SIMD libjpeg-turbo, releases the GIL) in a
Python thread pool is preferred when cv2 is present; the native path serves
hosts without cv2, or on request with CAPF_NATIVE_LOADER=1.
CAPF_NATIVE_LOADER=0 disables it entirely.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
_SRC = os.path.join(_REPO_ROOT, "native", "fastloader.cpp")
_LIB = os.path.join(_REPO_ROOT, "build", "native", "libfastloader.so")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_error: str | None = None


def _build() -> None:
    """Compile into a private name, then rename: a process that loads the
    library while another builds it sees the old file or the whole new one,
    never half of it (a half-written .so fails to load, "file too
    short")."""
    os.makedirs(os.path.dirname(_LIB), exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.{threading.get_ident()}"
    try:
        subprocess.run(
            [
                "g++", "-O3", "-fPIC", "-shared", "-std=c++17",
                "-o", tmp, _SRC, "-ljpeg", "-lpthread",
            ],
            check=True,
            capture_output=True,
        )
        os.replace(tmp, _LIB)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib() -> ctypes.CDLL | None:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
                _build()
            lib = ctypes.CDLL(_LIB)
            lib.fl_load_crop_batch.restype = ctypes.c_int
            lib.fl_load_crop_batch.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int),
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ]
            lib.fl_decode_jpeg.restype = ctypes.c_int
            lib.fl_decode_jpeg.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
            ]
            _lib = lib
        except Exception as e:  # missing g++/libjpeg -> cv2 path
            _build_error = str(e)
        return _lib


def _policy_enabled() -> bool:
    flag = os.environ.get("CAPF_NATIVE_LOADER")
    if flag == "1":
        return True
    if flag == "0":
        return False
    # auto: only when cv2 (libjpeg-turbo) is unavailable
    try:
        import cv2  # noqa: F401

        return False
    except Exception:
        return True


def available() -> bool:
    """True when the native loader should be used for batch loading."""
    return _policy_enabled() and get_lib() is not None


def load_crop_batch(
    paths: list[str],
    transforms: np.ndarray | None,  # (n, 2, 3) forward affines, or None
    out_hw: tuple[int, int],
    precropped: bool = False,
    n_threads: int = 8,
) -> np.ndarray:
    """Decode + crop a batch into a fresh uint8 (n, H, W, 3) BGR array."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {_build_error}")
    n = len(paths)
    h, w = out_hw
    out = np.empty((n, h, w, 3), np.uint8)
    blob = b"\0".join(p.encode() for p in paths) + b"\0"
    offsets = np.zeros(n, np.int32)
    pos = 0
    for i, p in enumerate(paths):
        offsets[i] = pos
        pos += len(p.encode()) + 1
    if transforms is None:
        trans = np.zeros((n, 6), np.float64)
    else:
        trans = np.ascontiguousarray(transforms, np.float64).reshape(n, 6)

    rc = lib.fl_load_crop_batch(
        blob,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        n,
        trans.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        1 if precropped else 0,
        h, w, n_threads,
    )
    if rc != 0:
        raise FileNotFoundError(
            f"native loader failed on item {-rc - 1}: {paths[-rc - 1]}"
        )
    return out
