"""Build and load the port's CUDA kernels (``tpuhuff_torch/csrc/*.cu``).

At first use the sources are compiled by ``nvcc`` for Hopper (``sm_90a``),
one ``nvcc`` process per source, all started together, and linked into ONE
shared library with a plain C interface, cached under
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

__all__ = ["lib", "build_seconds", "check_tensor", "launch", "resolve_device"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_U = ctypes.c_uint
# C signatures of csrc/*.cu (every pointer and the stream as c_void_p, so
# ctypes never truncates a 64-bit address to a 32-bit int)
_SIGNATURES = {
    # data, valid, lens, acodes, words, bits, miss, B, N, R, stream
    "tpuhuff_encode_lanes": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # ... the same, then hist, n_hist, hist_out, stream
    "tpuhuff_encode_lanes_hist": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P,
                                  _L, _P, _P],
    # rows, bit0, nbits, ub, dd, perm, lut, out, B, W, block_len, max_len,
    # global_rows (int*, out: the route taken; may be null), stream
    "tpuhuff_decode_rows": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _P, _P],
    # rows, bit0, nbits, thr, sym, len, lut, out, B, W, block_len,
    # global_rows, stream
    "tpuhuff_decode_rows_general": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                    _I, _P, _P],
    # B, W, block_len (queries: no stream)
    "tpuhuff_decode_rows_tile": [_I, _I, _I],
    "tpuhuff_decode_rows_general_tile": [_I, _I, _I],
    # data, n, out, stream
    "tpuhuff_hist256": [_P, _L, _P, _P],
    # n, per_sm (int*, out) (a query: no stream)
    "tpuhuff_hist256_grid": [_L, _P],
    # words, bits, ends, carry, out, carry_out, B, R, stream
    "tpuhuff_stitch_lanes": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
    # payload, n, start_bits, rows, bit0, B, W, stream
    "tpuhuff_lane_rows": [_P, _L, _P, _P, _P, _I, _I, _P],
    # data, n, span, head, piece, nseg, k_span, k_head, k_last, slices,
    # fold, out, stream
    "tpuhuff_crc32_spans": [_P, _L, _L, _L, _L, _I, _U, _U, _U, _P, _P, _P,
                            _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_fns: dict = {}  # launch()'s C functions by name
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
    """Hash of the flags, the sources and every header they may include,
    so an edited header never reuses a stale library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(glob.glob(os.path.join(_CSRC, "*.cuh")))
    for path in sources + headers:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fp:
            h.update(fp.read())
    return h.hexdigest()[:16]


def _run(cmds: list[list[str]]) -> None:
    """Run the commands side by side; raise with the first failure's output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        try:
            _, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def _build(sources: list[str], target: str) -> None:
    global build_seconds
    os.makedirs(_BUILD, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=_BUILD) as tmp:
        objs = [os.path.join(tmp, os.path.basename(src) + ".o")
                for src in sources]
        _run([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
              for src, obj in zip(sources, objs)])
        lib_tmp = os.path.join(tmp, "lib.so")
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib_tmp, *objs]])
        os.replace(lib_tmp, target)  # atomic: a concurrent loader sees all or none
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
    fn = _fns.get(name)
    if fn is None:
        fn = _fns[name] = getattr(lib(), name)
    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index is None or device.index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, stream)
    if err != 0:
        text = lib().tpuhuff_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{name}: CUDA error {err} ({text})")


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with its index (``cuda`` is the
    current card); ``cuda`` without a card raises, never falling back to
    the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested, but "
                               "torch.cuda.is_available() is False")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev
