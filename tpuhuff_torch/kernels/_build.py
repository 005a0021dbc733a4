"""Build and load the port's CUDA kernels (``tpuhuff_torch/csrc/*.cu``).

At first use the sources are compiled by ``nvcc`` for Hopper (``sm_90a``)
into ONE shared library with a plain C interface, cached under
``tpuhuff_torch/_build/`` by a hash of the sources and flags, and loaded
with ``ctypes``.  A plain C interface builds in seconds; a source that
includes PyTorch's headers would take minutes per build.

Nothing here runs at import: the CPU tests import every module of the
port on a box with no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

import torch

__all__ = ["lib", "build_seconds", "check_tensor", "launch"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signatures of csrc/*.cu (every pointer and the stream as c_void_p, so
# ctypes never truncates a 64-bit address to a 32-bit int)
_SIGNATURES = {
    # data, valid, lens, acodes, words, bits, miss, B, N, R, stream
    "tpuhuff_encode_lanes": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # rows, bit0, nbits, ub, dd, perm, out, B, W, block_len, max_len, stream
    "tpuhuff_decode_rows": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # data, n, out, stream
    "tpuhuff_hist256": [_P, _L, _P, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of the build this process ran


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of tpuhuff_torch "
                       "need the CUDA toolkit (set CUDA_HOME)")


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _key(sources: list[str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fp:
            h.update(fp.read())
    return h.hexdigest()[:16]


def _build(sources: list[str], target: str) -> None:
    global build_seconds
    os.makedirs(_BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources]
    t0 = time.perf_counter()
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({r.returncode}): {' '.join(cmd)}\n{r.stderr}")
        os.replace(tmp, target)  # atomic: a concurrent loader sees all or none
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_seconds = time.perf_counter() - t0


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            sources = _sources()
            target = os.path.join(_BUILD, f"libtpuhuff_torch_{_key(sources)}.so")
            if not os.path.exists(target):
                _build(sources, target)
            handle = ctypes.CDLL(target)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.tpuhuff_error_string.argtypes = [ctypes.c_int]
            handle.tpuhuff_error_string.restype = ctypes.c_char_p
            _lib = handle
    return _lib


def check_tensor(t, name: str, dtype, shape: tuple, device) -> None:
    """Validate a kernel operand before its pointer goes to C."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch(name: str, device: torch.device, *args) -> None:
    """Call the C entry point ``name`` with ``args`` and the current CUDA
    stream of ``device``, with ``device`` current; raise if it reports a
    CUDA error (a refused launch never runs, and a later synchronize would
    not report it)."""
    with torch.cuda.device(device):
        err = getattr(lib(), name)(*args,
                                   torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        text = lib().tpuhuff_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{name}: CUDA error {err} ({text})")
