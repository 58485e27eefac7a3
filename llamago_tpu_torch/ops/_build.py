"""Build the CUDA kernels in `csrc/` with nvcc and load them with ctypes.

Each `csrc/<name>.cu` compiles on its own into `build/lib<name>-<hash>.so`
at the repository root, where `<hash>` covers the source and the flags: a
changed source builds anew at its first use, an unchanged one loads the
library already built. The sources have a plain C interface and include
no PyTorch headers, so one build takes seconds.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/lib<name>-<hash>.so csrc/<name>.cu

`build_all()` starts one nvcc per source at once and waits for all of
them; `library(name)` builds (if needed) and loads one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build")
SOURCES = ("dequant_matmul", "attn_decode", "cache_append", "attn_decode_quant",
           "w4x8_matmul", "dequant_matmul_so")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, /usr/local/cuda, or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                           "to build the CUDA kernels")
    return found


def lib_path(name: str) -> str:
    src = os.path.join(CSRC, f"{name}.cu")
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(name: str, verbose: bool = False):
    """Start nvcc for one source unless its library exists. Returns
    (library path, temporary output path, Popen), the last two None when
    the library is already built."""
    out = lib_path(name)
    if os.path.exists(out):
        return out, None, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return out, tmp, proc


def _finish(name: str, out: str, tmp: str | None, proc) -> str:
    """Wait for nvcc; move the library into place. Returns nvcc's output."""
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build_all(verbose: bool = False) -> dict[str, str]:
    """Compile every source in parallel (one nvcc each). Returns nvcc's
    output per source (with -Xptxas -v when verbose)."""
    with _lock:
        started = {n: _start(n, verbose) for n in SOURCES}
        logs, failures = {}, []
        for n in SOURCES:  # wait for every nvcc, even after one failed
            try:
                logs[n] = _finish(n, *started[n])
            except RuntimeError as e:
                failures.append(e)
        if failures:
            raise failures[0]
        return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built at first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            out, tmp, proc = _start(name)
            _finish(name, out, tmp, proc)
            _libs[name] = ctypes.CDLL(out)
        return _libs[name]


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
