"""ctypes bindings to the C++ host runtime of the port.

The runtime's source is the repository's ``cpp/huffc.cpp``.  At first use
it is compiled with ``g++`` into ``tpuhuff_torch/_build/libhuffc_<key>.so``,
the key a hash of the source, the flags and the host CPU (one flag set is
``-march=native``), and loaded with ``ctypes``.  The library the JAX
package builds and loads (``cpp/libhuffc.so``) is never written or loaded
here.  If no flag set compiles, every call raises with the compiler's
error: the host routes have no Python fallback.  Before the runtime's
first threads start, glibc's malloc arenas are capped
(:func:`_bound_arenas`), which bounds the process's address space.

Entry points (the subset of :mod:`tpuhuff.native` the port calls, with the
same arguments and results):

* :func:`hist` — threaded byte histogram;
* :func:`encode` — threaded encode of one bitstream (the ``.hff`` payload);
* :func:`encode_blocks_host` — threaded independent-block encode + stitch;
* :func:`build_dfa` / :func:`decode_blocks` — byte-driven DFA decode of
  independent bit ranges;
* :func:`decode_resume` — DFA decode of one bit range, resumable at the
  last complete code (the streamed ``.hff`` reader), and :func:`decode`,
  the same without the resume offset (the in-memory codec);
* :func:`index_blocks` / :func:`spec_index` — the bit offset after every
  ``block_len``-th letter of a bit range, serially or split across
  threads by DFA self-synchronization (the ``.hff`` sidecar index);
* :func:`decode_index` — :func:`decode_resume` and :func:`index_blocks`
  in one walk;
* :func:`crc32` / :func:`crc32_blocks` — zlib CRC32 of a buffer, and
  per-span CRC32s;
* :func:`extract_rows` — per-block row gather for the device decoders;
* :func:`stitch_blocks` — bit-carry concatenation of block bitstreams.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
import time
from typing import Tuple

import numpy as np

from .core.format import CompressError

__all__ = [
    "lib",
    "build_seconds",
    "num_threads",
    "hist",
    "encode",
    "encode_blocks_host",
    "DfaTables",
    "build_dfa",
    "decode",
    "decode_resume",
    "decode_blocks",
    "decode_index",
    "index_blocks",
    "spec_index",
    "crc32",
    "crc32_blocks",
    "extract_rows",
    "stitch_blocks",
]

_PKG = os.path.dirname(os.path.abspath(__file__))
_SOURCE = os.path.join(os.path.dirname(_PKG), "cpp", "huffc.cpp")
_BUILD = os.path.join(_PKG, "_build")
_BASE_FLAGS = ["-O3", "-fPIC", "-shared", "-pthread", "-funroll-loops"]
# tried in order: zlib's CRC32 is the faster one; -march=native the faster
# code; the last set needs neither zlib nor a known CPU
_LADDER = [
    ["-march=native", "-DHUFFC_USE_ZLIB"],
    ["-march=native"],
    ["-DHUFFC_USE_ZLIB"],
    [],
]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of the build this process ran

_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
_u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
_i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_U32 = ctypes.c_uint32
_U64 = ctypes.c_uint64
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32
_INT = ctypes.c_int

_SIGNATURES = {
    # data, n, threads, out
    "huffc_hist": ([_u8p, _U64, _INT, _u64p], None),
    # data, n, lens, codes, out, cap, start_bit, threads
    "huffc_encode": ([_u8p, _U64, _u8p, _u64p, _u8p, _U64, _U64, _INT], _I64),
    # data, n, block_len, lens, codes, out, cap, bit_lens, threads
    "huffc_encode_blocks": ([_u8p, _U64, _U64, _u8p, _u64p, _u8p, _U64,
                             _u64p, _INT], _I64),
    # left, right, letter, n, root, next, count, syms, last_bit, state_of_node
    "huffc_build_dfa": ([_i32p, _i32p, _i32p, _I32, _I32, _i16p, _u8p, _u8p,
                         _u8p, _i16p], _I32),
    # comp, start_bit, end_bit, <dfa tables>, root, out, cap, resume
    "huffc_decode": ([_u8p, _U64, _U64, _i16p, _u8p, _u8p, _u8p, _i32p,
                      _i32p, _i32p, _i16p, _i32p, _I32, _u8p, _U64, _u64p],
                     _I64),
    # comp, starts, ends, nb, <dfa tables>, root, out, offs, caps, lens, threads
    "huffc_decode_blocks": ([_u8p, _u64p, _u64p, _I64, _i16p, _u8p, _u8p,
                             _u8p, _i32p, _i32p, _i32p, _i16p, _i32p, _I32,
                             _u8p, _u64p, _u64p, _u64p, _INT], _I64),
    # comp, start_bit, end_bit, <dfa tables>, root, out, cap, resume,
    # block_len, bounds, bounds_cap, in_block, n_bounds
    "huffc_decode_index": ([_u8p, _U64, _U64, _i16p, _u8p, _u8p, _u8p, _i32p,
                            _i32p, _i32p, _i16p, _i32p, _I32, _u8p, _U64,
                            _u64p, _U64, _u64p, _I64, _u64p, _i64p], _I64),
    # comp, start_bit, end_bit, next, count, last_bit, left, right,
    # state_of_node, node_of_state, root, block_len, bounds, bounds_cap,
    # in_block, resume
    "huffc_index_blocks": ([_u8p, _U64, _U64, _i16p, _u8p, _u8p, _i32p, _i32p,
                            _i16p, _i32p, _I32, _U64, _u64p, _I64, _u64p,
                            _u64p], _I64),
    # ... the same, then threads
    "huffc_spec_index": ([_u8p, _U64, _U64, _i16p, _u8p, _u8p, _i32p, _i32p,
                          _i16p, _i32p, _I32, _U64, _u64p, _I64, _u64p, _u64p,
                          _INT], _I64),
    # data, n, seed
    "huffc_crc32": ([_u8p, _U64, _U32], _U32),
    # data, n, span, out, threads
    "huffc_crc32_blocks": ([_u8p, _U64, _U64, _u32p, _INT], None),
    # words, n_words, starts, nb, row_words, out, threads
    "huffc_extract_rows": ([_u32p, _U64, _u64p, _I64, _I64, _u32p, _INT],
                           None),
    # rows, row_bytes, bit_lens, nb, out, cap, start_bit, threads
    "huffc_stitch_blocks": ([_u8p, _U64, _u64p, _I64, _u8p, _U64, _U64, _INT],
                            _I64),
}


# glibc's mallopt parameter, and the bound put on it: each of the
# runtime's os.cpu_count() threads would otherwise get a malloc arena of
# its own, and each arena reserves 64 MiB of address space
_M_ARENA_MAX = -8
_ARENA_MAX = 2


def num_threads() -> int:
    return max(1, os.cpu_count() or 1)


def _bound_arenas() -> None:
    """Cap glibc's malloc arenas at ``_ARENA_MAX`` (2) before the runtime
    starts its first threads, so that the process's address space stays
    bounded (a 1.5 GiB round trip fits under a 1 GiB ``RLIMIT_AS``).  A
    ``MALLOC_ARENA_MAX`` in the environment is left to rule; a C library
    without ``mallopt`` is left as it is."""
    if os.environ.get("MALLOC_ARENA_MAX"):
        return
    try:
        mallopt = ctypes.CDLL(None).mallopt
    except (OSError, AttributeError):
        return
    mallopt.argtypes = [ctypes.c_int, ctypes.c_int]
    mallopt.restype = ctypes.c_int
    mallopt(_M_ARENA_MAX, _ARENA_MAX)


def _cpu_id() -> bytes:
    """The host CPU's identity, for the ``-march=native`` build's key."""
    ident = platform.machine().encode()
    try:
        with open("/proc/cpuinfo", "rb") as fp:
            for line in fp:
                if line.startswith((b"model name", b"flags")):
                    ident += line
                if line.strip() == b"":
                    break
    except OSError:
        pass
    return ident


def _key(source: bytes) -> str:
    h = hashlib.sha256(source)
    h.update(repr((_BASE_FLAGS, _LADDER)).encode())
    h.update(_cpu_id())
    return h.hexdigest()[:16]


def _build(target: str) -> None:
    global build_seconds
    os.makedirs(_BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    errors = []
    t0 = time.perf_counter()
    try:
        for extra in _LADDER:
            cmd = ["g++", *_BASE_FLAGS, *extra, "-o", tmp, _SOURCE]
            if "-DHUFFC_USE_ZLIB" in extra:
                cmd.append("-lz")
            try:
                r = subprocess.run(cmd, capture_output=True, text=True,
                                   timeout=300)
            except (OSError, subprocess.TimeoutExpired) as e:
                errors.append(f"{' '.join(cmd)}: {e}")
                continue
            if r.returncode == 0:
                os.replace(tmp, target)  # a concurrent loader sees all or none
                build_seconds = time.perf_counter() - t0
                return
            errors.append(f"{' '.join(cmd)} ({r.returncode}):\n{r.stderr}")
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    raise RuntimeError("cannot build the host runtime of tpuhuff_torch:\n"
                       + "\n".join(errors))


def lib() -> ctypes.CDLL:
    """The loaded host runtime, built first if its source or host changed."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            with open(_SOURCE, "rb") as fp:
                target = os.path.join(_BUILD, f"libhuffc_{_key(fp.read())}.so")
            if not os.path.exists(target):
                _build(target)
            _bound_arenas()
            handle = ctypes.CDLL(target)
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = handle
    return _lib


def hist(data: np.ndarray, threads: int | None = None) -> np.ndarray:
    """(256,) int64 byte counts of ``data``."""
    data = np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
    out = np.zeros(256, dtype=np.uint64)
    lib().huffc_hist(data, data.size, threads or num_threads(), out)
    return out.astype(np.int64)


def encode(data: np.ndarray, lens_lut: np.ndarray, codes_lut: np.ndarray,
           threads: int | None = None) -> Tuple[bytes, int]:
    """Pack ``data`` into one MSB-first bitstream; returns ``(payload,
    padding_bits)``.  A byte with no code raises :class:`CompressError`."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    lens_lut = np.ascontiguousarray(lens_lut, dtype=np.uint8)
    codes_lut = np.ascontiguousarray(codes_lut, dtype=np.uint64)
    max_len = int(lens_lut.max()) if lens_lut.size else 0
    cap = (data.size * max(max_len, 1) + 7) // 8 + 16
    out = np.zeros(cap, dtype=np.uint8)
    r = int(lib().huffc_encode(data, data.size, lens_lut, codes_lut, out, cap,
                               0, threads or num_threads()))
    if r == -2:
        raise CompressError("letter not found in codes", None)
    if r < 0:
        raise RuntimeError(f"huffc_encode failed: {r}")
    return out[: (r + 7) // 8].tobytes(), (8 - r % 8) % 8


def encode_blocks_host(
    data: np.ndarray, block_len: int, lens_lut: np.ndarray,
    codes_lut: np.ndarray, threads: int | None = None,
) -> Tuple[bytes, int, np.ndarray]:
    """Threaded independent-block encode and bit-carry stitch in one call.
    Returns ``(payload, total_bits, bit_lens)``, ``bit_lens[k]`` block k's
    exact bit count; a byte with no code raises :class:`CompressError`."""
    data = np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
    lens_lut = np.ascontiguousarray(lens_lut, dtype=np.uint8)
    codes_lut = np.ascontiguousarray(codes_lut, dtype=np.uint64)
    if data.size == 0:
        return b"", 0, np.zeros(0, dtype=np.uint64)
    nb = -(-data.size // block_len)
    max_len = int(lens_lut.max()) if lens_lut.size else 1
    cap = (data.size * max(max_len, 1) + 7) // 8 + 16
    out = np.zeros(cap, dtype=np.uint8)
    bit_lens = np.zeros(nb, dtype=np.uint64)
    r = int(lib().huffc_encode_blocks(
        data, data.size, block_len, lens_lut, codes_lut, out, cap, bit_lens,
        threads or num_threads()))
    if r == -2:
        raise CompressError("letter not found in codes", None)
    if r < 0:
        raise RuntimeError(f"huffc_encode_blocks failed: {r}")
    return out[: (r + 7) // 8].tobytes(), r, bit_lens


class DfaTables:
    """Byte-driven DFA decode tables of a tree (the runtime's layout)."""

    __slots__ = (
        "next_state", "emit_count", "emit_syms", "last_emit_bit",
        "state_of_node", "node_of_state", "left", "right", "letter", "root",
        "num_states",
    )

    def __init__(self, tree) -> None:
        left, right, letter = tree.node_arrays()
        self.left = np.ascontiguousarray(left, dtype=np.int32)
        self.right = np.ascontiguousarray(right, dtype=np.int32)
        self.letter = np.ascontiguousarray(letter, dtype=np.int32)
        self.root = int(tree.root)
        n = self.left.size
        S = max(int(np.count_nonzero(self.left >= 0)), 1)
        self.next_state = np.zeros((S, 256), dtype=np.int16)
        self.emit_count = np.zeros((S, 256), dtype=np.uint8)
        self.emit_syms = np.zeros((S, 256, 8), dtype=np.uint8)
        self.last_emit_bit = np.zeros((S, 256), dtype=np.uint8)
        self.state_of_node = np.zeros(n, dtype=np.int16)
        self.num_states = int(lib().huffc_build_dfa(
            self.left, self.right, self.letter, n, self.root,
            self.next_state.reshape(-1), self.emit_count.reshape(-1),
            self.emit_syms.reshape(-1), self.last_emit_bit.reshape(-1),
            self.state_of_node))
        self.node_of_state = np.zeros(max(self.num_states, 1), dtype=np.int32)
        for node, s in enumerate(self.state_of_node):
            if s >= 0:
                self.node_of_state[s] = node


def build_dfa(tree) -> DfaTables:
    return DfaTables(tree)


def decode(comp: np.ndarray, start_bit: int, end_bit: int,
           tables: DfaTables, out_cap: int) -> bytes:
    """The letters of the bit range ``[start_bit, end_bit)`` of ``comp``
    (:func:`decode_resume` without its resume offset); more than
    ``out_cap`` letters raise ``RuntimeError``."""
    return decode_resume(comp, start_bit, end_bit, tables, out_cap)[0]


def decode_resume(comp: np.ndarray, start_bit: int, end_bit: int,
                  tables: DfaTables, out_cap: int) -> Tuple[bytes, int]:
    """Decode the bit range ``[start_bit, end_bit)`` of ``comp``; returns
    ``(letters, resume_bit)``, ``resume_bit`` the offset just past the last
    complete code (a code may straddle the end of a streamed window)."""
    comp = np.ascontiguousarray(comp, dtype=np.uint8)
    out = np.empty(out_cap, dtype=np.uint8)
    resume = np.zeros(1, dtype=np.uint64)
    r = int(lib().huffc_decode(
        comp, start_bit, end_bit, tables.next_state.reshape(-1),
        tables.emit_count.reshape(-1), tables.emit_syms.reshape(-1),
        tables.last_emit_bit.reshape(-1), tables.left, tables.right,
        tables.letter, tables.state_of_node, tables.node_of_state, tables.root,
        out, out_cap, resume))
    if r < 0:
        raise RuntimeError(f"huffc_decode failed: {r}")
    return out[:r].tobytes(), int(resume[0])


def decode_blocks(
    comp: np.ndarray, start_bits: np.ndarray, end_bits: np.ndarray,
    tables: DfaTables, out_offsets: np.ndarray, out_caps: np.ndarray,
    threads: int | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode independent bit ranges in parallel.  Returns ``(out_buffer,
    out_lens)``: block k's letters are at ``out_buffer[out_offsets[k]:
    out_offsets[k] + out_lens[k]]``."""
    comp = np.ascontiguousarray(comp, dtype=np.uint8)
    start_bits = np.ascontiguousarray(start_bits, dtype=np.uint64)
    end_bits = np.ascontiguousarray(end_bits, dtype=np.uint64)
    out_offsets = np.ascontiguousarray(out_offsets, dtype=np.uint64)
    out_caps = np.ascontiguousarray(out_caps, dtype=np.uint64)
    total = int(out_offsets[-1] + out_caps[-1]) if out_caps.size else 0
    out = np.empty(total, dtype=np.uint8)
    out_lens = np.zeros(start_bits.size, dtype=np.uint64)
    r = int(lib().huffc_decode_blocks(
        comp, start_bits, end_bits, start_bits.size,
        tables.next_state.reshape(-1), tables.emit_count.reshape(-1),
        tables.emit_syms.reshape(-1), tables.last_emit_bit.reshape(-1),
        tables.left, tables.right, tables.letter, tables.state_of_node,
        tables.node_of_state, tables.root, out, out_offsets, out_caps,
        out_lens, threads or num_threads()))
    if r != 0:
        raise RuntimeError(f"huffc_decode_blocks failed on block {-r - 1}")
    return out, out_lens


def decode_index(
    comp: np.ndarray, start_bit: int, end_bit: int, tables: DfaTables,
    out_cap: int, block_len: int, in_block: int = 0,
) -> Tuple[bytes, np.ndarray, int, int]:
    """:func:`decode_resume` and :func:`index_blocks` in one DFA walk.
    Returns ``(letters, boundaries, resume_bit, in_block)``, resumable
    across windows like :func:`decode_resume`."""
    comp = np.ascontiguousarray(comp, dtype=np.uint8)
    out = np.empty(out_cap, dtype=np.uint8)
    cap_b = int(end_bit - start_bit) // max(int(block_len), 1) + 2
    bounds = np.zeros(cap_b, dtype=np.uint64)
    state = np.asarray([in_block], dtype=np.uint64)
    resume = np.zeros(1, dtype=np.uint64)
    nb = np.zeros(1, dtype=np.int64)
    r = int(lib().huffc_decode_index(
        comp, start_bit, end_bit, tables.next_state.reshape(-1),
        tables.emit_count.reshape(-1), tables.emit_syms.reshape(-1),
        tables.last_emit_bit.reshape(-1), tables.left, tables.right,
        tables.letter, tables.state_of_node, tables.node_of_state, tables.root,
        out, out_cap, resume, block_len, bounds, cap_b, state, nb))
    if r < 0:
        raise RuntimeError(f"huffc_decode_index failed: {r}")
    return (out[:r].tobytes(), bounds[: int(nb[0])].copy(), int(resume[0]),
            int(state[0]))


def _index_args(comp, start_bit, end_bit, tables, block_len, in_block):
    """The arguments :func:`index_blocks` and :func:`spec_index` share, and
    their boundary, state and resume buffers."""
    comp = np.ascontiguousarray(comp, dtype=np.uint8)
    # every letter is >= 1 bit, so at most (bits // block_len) + 1 boundaries
    cap = int(end_bit - start_bit) // max(int(block_len), 1) + 2
    bounds = np.zeros(cap, dtype=np.uint64)
    state = np.asarray([in_block], dtype=np.uint64)
    resume = np.zeros(1, dtype=np.uint64)
    args = (comp, start_bit, end_bit, tables.next_state.reshape(-1),
            tables.emit_count.reshape(-1), tables.last_emit_bit.reshape(-1),
            tables.left, tables.right, tables.state_of_node,
            tables.node_of_state, tables.root, block_len, bounds, cap, state,
            resume)
    return args, bounds, state, resume


def index_blocks(
    comp: np.ndarray, start_bit: int, end_bit: int, tables: DfaTables,
    block_len: int, in_block: int = 0,
) -> Tuple[np.ndarray, int, int]:
    """Walk a bit range without emitting; returns ``(boundaries, resume_bit,
    in_block)``, ``boundaries`` the bit offset after every
    ``block_len``-th letter.  Resumable across windows like
    :func:`decode_resume` (fed again from ``resume_bit`` with the returned
    ``in_block``)."""
    args, bounds, state, resume = _index_args(comp, start_bit, end_bit,
                                              tables, block_len, in_block)
    nb = int(lib().huffc_index_blocks(*args))
    if nb < 0:
        raise RuntimeError("huffc_index_blocks: boundary buffer overflow")
    return bounds[:nb].copy(), int(resume[0]), int(state[0])


def spec_index(
    comp: np.ndarray, start_bit: int, end_bit: int, tables: DfaTables,
    block_len: int, in_block: int = 0, threads: int | None = None,
) -> Tuple[np.ndarray, int, int]:
    """:func:`index_blocks` split across threads: each parses a
    byte-aligned chunk from the root state and a serial pass over the
    seams splices the true parse together (a seam that does not coalesce
    walks its chunk again serially).  A one-leaf tree or a range too small
    to split goes to :func:`index_blocks`."""
    args, bounds, state, resume = _index_args(comp, start_bit, end_bit,
                                              tables, block_len, in_block)
    nb = int(lib().huffc_spec_index(*args, threads or num_threads()))
    if nb == -3:
        return index_blocks(comp, start_bit, end_bit, tables, block_len,
                            in_block)
    if nb < 0:
        raise RuntimeError(f"huffc_spec_index failed: {nb}")
    return bounds[:nb].copy(), int(resume[0]), int(state[0])


def crc32(data, seed: int = 0) -> int:
    """zlib's CRC32 of ``data`` (bytes-like or uint8 array), chained from
    ``seed``."""
    if isinstance(data, (bytes, bytearray, memoryview)):
        data = np.frombuffer(data, dtype=np.uint8)
    data = np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
    return int(lib().huffc_crc32(data, data.size, seed & 0xFFFFFFFF))


def crc32_blocks(data: np.ndarray, span: int,
                 threads: int | None = None) -> np.ndarray:
    """``out[k] = crc32(data[k*span : (k+1)*span])`` (the last span may be
    short), threaded over spans."""
    data = np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
    ns = -(-data.size // max(span, 1)) if data.size else 0
    out = np.zeros(ns, dtype=np.uint32)
    if ns:
        lib().huffc_crc32_blocks(data, data.size, span, out,
                                 threads or num_threads())
    return out


def extract_rows(words: np.ndarray, starts_w: np.ndarray, row_words: int,
                 threads: int | None = None) -> np.ndarray:
    """Threaded row gather: ``out[k] = words[starts_w[k]:+row_words]``,
    zero-filled past the end."""
    words = np.ascontiguousarray(words, dtype=np.uint32)
    starts_w = np.ascontiguousarray(starts_w, dtype=np.uint64)
    out = np.empty((starts_w.size, row_words), dtype=np.uint32)
    lib().huffc_extract_rows(words, words.size, starts_w, starts_w.size,
                             row_words, out.reshape(-1),
                             threads or num_threads())
    return out


def stitch_blocks(rows: np.ndarray, bit_lens: np.ndarray,
                  threads: int | None = None) -> Tuple[bytes, int]:
    """Bit-carry concatenation of block bitstreams (``rows`` (B, row_bytes)
    uint8, MSB-first).  Returns ``(payload, padding_bits)``."""
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    bit_lens = np.ascontiguousarray(bit_lens, dtype=np.uint64)
    total = int(bit_lens.sum())
    cap = total // 8 + 16
    out = np.zeros(cap, dtype=np.uint8)
    r = int(lib().huffc_stitch_blocks(
        rows.reshape(-1), rows.shape[1] if rows.ndim == 2 else rows.size,
        bit_lens, bit_lens.size, out, cap, 0, threads or num_threads()))
    if r < 0:
        raise RuntimeError("huffc_stitch_blocks overflow")
    return out[: (total + 7) // 8].tobytes(), (8 - total % 8) % 8
