"""ctypes bindings for the native C++ data-path library (ggjt_kernels.cpp).

The port's own copy of the JAX package's `native/`. g++ builds the library
at first use into the repository's `build/` directory, named by a hash of
the source and the flags (`build/libggjt-<hash>.so`), never next to the
source. Every entry point has a numpy fallback that gives the same bytes, so
the package works without a compiler: the native path is a host-throughput
optimization for checkpoint conversion and loading (multithreaded FP16
widening and Q8_0/Q4_0 block quantization). It runs on the host only.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "ggjt_kernels.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build")
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None
_tried = False


def _threads() -> int:
    env = os.environ.get("LLAMAGO_THREADS")
    if env and env.isdigit() and int(env) > 0:
        return int(env)
    return max(1, os.cpu_count() or 1)


def lib_path() -> str:
    """build/libggjt-<hash of the source and flags>.so"""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libggjt-{h.hexdigest()[:16]}.so")


def build(force: bool = False) -> bool:
    """Compile the shared library into build/. Returns True on success. The
    library is written under a temporary name and moved into place, so
    processes that build at once never load a partial file."""
    out = lib_path()
    if os.path.exists(out) and not force:
        return True
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", *_FLAGS, _SRC, "-o", tmp, "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError):
        return False
    os.replace(tmp, out)
    return True


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not build():
            return None
        try:
            lib = ctypes.CDLL(lib_path())
        except OSError:
            return None
        i64, i32 = ctypes.c_int64, ctypes.c_int32
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u16p = ctypes.POINTER(ctypes.c_uint16)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.ggjt_fp16_to_fp32.argtypes = [u16p, f32p, i64, i32]
        lib.ggjt_quantize_q8_0.argtypes = [f32p, u8p, i64, i64, i32]
        lib.ggjt_quantize_q4_0.argtypes = [f32p, u8p, i64, i64, i32]
        lib.ggjt_transpose_f32.argtypes = [f32p, f32p, i64, i64, i32]
        for fn in (lib.ggjt_fp16_to_fp32, lib.ggjt_quantize_q8_0,
                   lib.ggjt_quantize_q4_0, lib.ggjt_transpose_f32):
            fn.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def fp16_to_fp32(src: np.ndarray) -> np.ndarray | None:
    """Multithreaded FP16 -> FP32. None when the native lib is unavailable."""
    lib = _load()
    if lib is None:
        return None
    src = np.ascontiguousarray(src)
    dst = np.empty(src.shape, np.float32)
    lib.ggjt_fp16_to_fp32(_ptr(src.view(np.uint16), ctypes.c_uint16),
                          _ptr(dst, ctypes.c_float), src.size, _threads())
    return dst


def quantize_rows(kind: str):
    """Return a callable (f32 [out, in] -> raw uint8 blocks) or None."""
    lib = _load()
    if lib is None or kind not in ("q8_0", "q4_0"):
        return None  # q4_1 has a numpy-only path (checkpoint/quant_file.py)
    from llamago_tpu_torch.checkpoint.quant_file import row_bytes

    fn = lib.ggjt_quantize_q8_0 if kind == "q8_0" else lib.ggjt_quantize_q4_0

    def quantize(x: np.ndarray) -> np.ndarray:
        x = np.ascontiguousarray(x, np.float32)
        out, k = x.shape
        dst = np.empty((out, row_bytes(kind, k)), np.uint8)
        fn(_ptr(x, ctypes.c_float), _ptr(dst, ctypes.c_uint8), out, k, _threads())
        return dst

    return quantize


def transpose_f32(src: np.ndarray) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    src = np.ascontiguousarray(src, np.float32)
    rows, cols = src.shape
    dst = np.empty((cols, rows), np.float32)
    lib.ggjt_transpose_f32(_ptr(src, ctypes.c_float), _ptr(dst, ctypes.c_float),
                           rows, cols, _threads())
    return dst
