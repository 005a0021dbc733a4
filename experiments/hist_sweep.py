#!/usr/bin/env python3
"""The histogram kernel K3 against its parent and against other counters.

Builds, side by side, into a temporary directory (the sources are not
touched), each with ``nvcc -Xptxas -v`` (registers and spills printed):

* ``parent``: the parent commit's ``tpuhuff_torch/csrc/histogram.cu``
  (one 256-bin copy per warp, a shared ``atomicAdd`` per byte, a grid of up
  to 1024 blocks);
* ``this``: this checkout's ``csrc/histogram.cu`` over
  ``csrc/histogram_common.cuh`` (per-thread ``uint16_t`` columns, a shared
  ``atomicAdd`` per byte into the thread's own half-word, a resident grid
  of one thread block to an SM), and the same at 8 and 12 vectors a step
  in place of 5;
* copies of ``this`` whose ``Counters`` struct (the region between the
  header's ``counters: begin`` and ``counters: end`` lines) is replaced:
  ``u8 columns, a load and a store``: each thread's column of ``uint8_t``
  counters, incremented by a shared load and store (no atomic), folded
  every 3 steps (240 bytes a thread), 64 KiB a thread block, three to an
  SM; ``u8 lanes, shared atomics``: the same columns, each byte one shared
  ``atomicAdd`` of ``1 << 8 * (column % 4)`` into the word that holds the
  thread's counter; ``u8, pairs (fours) loaded together``: the u8 columns
  with a word's bytes in groups of 2 (4) whose counters are all loaded
  before any is stored, each store adding the group's earlier bytes of the
  same value (a thread's increments otherwise wait one shared-memory
  latency each, since any two may be of one counter); ``R u32 copies per
  warp`` (R = 4, 8): each warp's R lane-interleaved 256-bin copies,
  ``bins[bin * R + lane % R]``, a shared ``atomicAdd`` per byte, folded
  once at the end (exact below 4 GiB per thread block, enough for these
  sizes); and four whose counts are wrong by design, timed only: ``loads
  only`` at 5 and 8 vectors a step (the loop's loads and no counting: the
  floor of the load structure), ``u8 columns, no folds``, and ``this, no
  loads`` (each vector made in registers from its index: the counting
  alone).

Each build but the last four is checked exact against
``torch.bincount``, and every build is timed with CUDA events (20 calls back to back, the C entry called directly, so no Python
wrapper time) on five inputs (textlike, uniform random, runs of 0x00 and
0xff, geometric: ``chip_smoke.HIST_KINDS``) at 1, 16 and 64 MiB, in turns:
every build in order, then in reverse order.  Last, the wrappers at
64 MiB: the parent's ``tpuhuff_torch.kernels.histogram`` (in a child
process run from the parent checkout, so its own package and build) and
this checkout's with ``out=`` (as pass 1 calls it) and without, parent /
this / this / parent: card ms (``chip_smoke.cuda_ms``), the device's time
alone and the host time per call (``chip_smoke.spin_ms``).

Run from the root of a checkout on a machine with an NVIDIA card and nvcc,
given the root of a checkout of the parent commit (``git archive``):

    python3 experiments/hist_sweep.py PARENT_CHECKOUT
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (  # noqa: E402
    HBM_BYTES_PER_MS,
    HIST_KINDS,
    cuda_ms,
    make_hist_input,
    spin_ms,
)
from tpuhuff_torch.kernels import _build, histogram  # noqa: E402

CSRC = os.path.join(ROOT, "tpuhuff_torch", "csrc")
SIZES_MIB = (1, 16, 64)
BEGIN, END = "// counters: begin", "// counters: end"

# The u8 columns: each thread owns a byte of each bin's row (the 4 threads
# of a word in 4 warps), folded every 3 steps of 5 vectors (240 bytes a
# thread) into the per-block totals, four counters a word through dp4a;
# 64 KiB a thread block, three to an SM.  %(adds)s is its add and add4.
_U8 = """
struct Counters {
  static constexpr int kSmemBytes = 256 * kThreads;
  static constexpr int kFoldSteps = %(fold_steps)s;
  uint8_t* cnt;
  uint32_t col;
  int t;
  __device__ __forceinline__ Counters(uint8_t* smem, int tid)
      : cnt(smem),
        col(static_cast<uint32_t>((tid & ~127) | ((tid & 31) << 2) | ((tid >> 5) & 3))),
        t(tid) {}
  __device__ __forceinline__ void clear() {
    Vec16* v = reinterpret_cast<Vec16*>(cnt);
    for (int i = t; i < kSmemBytes / 16; i += kThreads) v[i] = Vec16{0u, 0u, 0u, 0u};
  }
%(adds)s
  __device__ __forceinline__ uint32_t fold() {
    Vec16* row = reinterpret_cast<Vec16*>(cnt + t * kThreads);
    uint32_t sum = 0;
#pragma unroll 4
    for (int j = 0; j < kThreads / 16; ++j) {
      Vec16* p = row + ((j + t) & (kThreads / 16 - 1));
      const Vec16 v = *p;
      sum += __dp4a(v.x, 0x01010101u, 0u) + __dp4a(v.y, 0x01010101u, 0u) +
             __dp4a(v.z, 0x01010101u, 0u) + __dp4a(v.w, 0x01010101u, 0u);
      *p = Vec16{0u, 0u, 0u, 0u};
    }
    return sum;
  }
};
"""

_U8_LOAD_STORE = """
  __device__ __forceinline__ void add(uint32_t byte) { cnt[(byte << 8) | col] += 1; }
  __device__ __forceinline__ void add4(uint32_t w) {
    cnt[((w << 8) & 0xFF00u) | col] += 1;
    cnt[(w & 0xFF00u) | col] += 1;
    cnt[((w >> 8) & 0xFF00u) | col] += 1;
    cnt[((w >> 16) & 0xFF00u) | col] += 1;
  }
"""

_U8_LANES = """
  __device__ __forceinline__ void add(uint32_t byte) {
    atomicAdd(reinterpret_cast<uint32_t*>(cnt + ((byte << 8) | (col & ~3u))),
              1u << (8 * (col & 3u)));
  }
  __device__ __forceinline__ void add4(uint32_t w) {
    add(w & 255u);
    add((w >> 8) & 255u);
    add((w >> 16) & 255u);
    add(w >> 24);
  }
"""

_GROUPS = {
    2: """
  __device__ __forceinline__ void add(uint32_t byte) { cnt[(byte << 8) | col] += 1; }
  __device__ __forceinline__ void add4(uint32_t w) {
    const uint32_t a0 = ((w << 8) & 0xFF00u) | col, a1 = (w & 0xFF00u) | col;
    const uint32_t a2 = ((w >> 8) & 0xFF00u) | col, a3 = ((w >> 16) & 0xFF00u) | col;
    const uint32_t c0 = cnt[a0], c1 = cnt[a1];
    cnt[a0] = static_cast<uint8_t>(c0 + 1);
    cnt[a1] = static_cast<uint8_t>(c1 + 1 + (a1 == a0));
    const uint32_t c2 = cnt[a2], c3 = cnt[a3];
    cnt[a2] = static_cast<uint8_t>(c2 + 1);
    cnt[a3] = static_cast<uint8_t>(c3 + 1 + (a3 == a2));
  }
""",
    4: """
  __device__ __forceinline__ void add(uint32_t byte) { cnt[(byte << 8) | col] += 1; }
  __device__ __forceinline__ void add4(uint32_t w) {
    const uint32_t a0 = ((w << 8) & 0xFF00u) | col, a1 = (w & 0xFF00u) | col;
    const uint32_t a2 = ((w >> 8) & 0xFF00u) | col, a3 = ((w >> 16) & 0xFF00u) | col;
    const uint32_t c0 = cnt[a0], c1 = cnt[a1], c2 = cnt[a2], c3 = cnt[a3];
    cnt[a0] = static_cast<uint8_t>(c0 + 1);
    cnt[a1] = static_cast<uint8_t>(c1 + 1 + (a1 == a0));
    cnt[a2] = static_cast<uint8_t>(c2 + 1 + (a2 == a0) + (a2 == a1));
    cnt[a3] = static_cast<uint8_t>(c3 + 1 + (a3 == a0) + (a3 == a1) + (a3 == a2));
  }
"""}


def _u8(adds: str, fold_steps: str = "3"):
    return _U8 % {"adds": adds, "fold_steps": fold_steps}


_COPIES = """
struct Counters {
  static constexpr int kR = %d;
  static constexpr int kSmemBytes = (kThreads / 32) * kR * 256 * 4;
  static constexpr int kFoldSteps = 1 << 30;  // folded once, at the end
  uint32_t* s;
  uint32_t* mine;
  int t;
  __device__ __forceinline__ Counters(uint8_t* smem, int tid)
      : s(reinterpret_cast<uint32_t*>(smem)),
        mine(reinterpret_cast<uint32_t*>(smem) + (tid >> 5) * kR * 256 + (tid & (kR - 1))),
        t(tid) {}
  __device__ __forceinline__ void clear() {
    for (int i = t; i < kSmemBytes / 4; i += kThreads) s[i] = 0u;
  }
  __device__ __forceinline__ void add(uint32_t byte) { atomicAdd(mine + byte * kR, 1u); }
  __device__ __forceinline__ void add4(uint32_t w) {
    add(w & 255u);
    add((w >> 8) & 255u);
    add((w >> 16) & 255u);
    add(w >> 24);
  }
  __device__ __forceinline__ uint32_t fold() {
    uint32_t sum = 0;
    for (int w = 0; w < kThreads / 32; ++w)
      for (int r = 0; r < kR; ++r) {
        uint32_t* p = s + (w * 256 + t) * kR + r;
        sum += *p;
        *p = 0u;
      }
    return sum;
  }
};
"""


_LOADS_ONLY = """
struct Counters {
  static constexpr int kSmemBytes = 256 * kThreads;
  static constexpr int kFoldSteps = 3;
  uint8_t* cnt;
  uint32_t acc = 0;
  int t;
  __device__ __forceinline__ Counters(uint8_t* smem, int tid) : cnt(smem), t(tid) {}
  __device__ __forceinline__ void clear() {
    Vec16* v = reinterpret_cast<Vec16*>(cnt);
    for (int i = t; i < kSmemBytes / 16; i += kThreads) v[i] = Vec16{0u, 0u, 0u, 0u};
  }
  __device__ __forceinline__ void add(uint32_t byte) { acc ^= byte; }
  __device__ __forceinline__ void add4(uint32_t w) { acc += w; }
  __device__ __forceinline__ uint32_t fold() {
    if (acc == 0x9E3779B9u) cnt[t] = 1;  // keeps the loads
    return 0;
  }
};
"""


def _whole(text: str):
    """Replace the whole Counters struct."""
    def patch(header: str) -> str:
        lo, hi = header.index(BEGIN), header.index(END)
        return header[:lo] + text + header[hi:]
    return patch


def _copies(r: int):
    return _whole(_COPIES % r)


def _no_loads(header: str) -> str:
    """Each vector made from its index in registers (about uniform bytes)
    in place of loaded: the counting alone."""
    old = "__device__ __forceinline__ Vec16 load16(const Vec16* p) { return __ldg(p); }"
    new = """__device__ __forceinline__ Vec16 load16(const Vec16* p) {
  const uint32_t i = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(p) >> 4);
  return Vec16{i * 2654435761u, i * 2246822519u, i * 3266489917u, i * 668265263u};
}"""
    if old not in header:
        sys.exit("hist_sweep: load16 is not where the patch expects it")
    return header.replace(old, new)


def _vecs(n: int, patch=None):
    """``patch``, then n 16-byte vectors per thread per step."""
    def with_vecs(header: str) -> str:
        header = header if patch is None else patch(header)
        old = "constexpr int kVecsPerStep = "
        lo = header.index(old) + len(old)
        return header[:lo] + str(n) + header[header.index(";", lo):]
    return with_vecs


# name: (patch of histogram_common.cuh, whether its counts are exact)
VARIANTS = {
    "this": (None, True),
    "this, 8 vectors a step": (_vecs(8), True),
    "this, 12 vectors a step": (_vecs(12), True),
    "u8 columns, a load and a store": (_whole(_u8(_U8_LOAD_STORE)), True),
    "u8 lanes, shared atomics": (_whole(_u8(_U8_LANES)), True),
    "u8, pairs loaded together": (_whole(_u8(_GROUPS[2])), True),
    "u8, fours loaded together": (_whole(_u8(_GROUPS[4])), True),
    "4 u32 copies per warp": (_copies(4), True),
    "8 u32 copies per warp": (_copies(8), True),
    "loads only": (_whole(_LOADS_ONLY), False),
    "loads only, 8 vectors a step": (_vecs(8, _whole(_LOADS_ONLY)), False),
    "u8 columns, no folds": (_whole(_u8(_U8_LOAD_STORE, "1 << 30")), False),
    "this, no loads": (_no_loads, False),
}


def build_all(tmp: str, parent: str) -> dict:
    """One library per build, compiled side by side; prints ptxas's lines
    for the kernel."""
    with open(os.path.join(CSRC, "histogram_common.cuh")) as fp:
        header = fp.read()
    sources = {"parent": os.path.join(parent, "tpuhuff_torch", "csrc",
                                      "histogram.cu")}
    for i, (name, (patch, _)) in enumerate(VARIANTS.items()):
        d = os.path.join(tmp, f"v{i}")
        os.makedirs(d)
        shutil.copy(os.path.join(CSRC, "histogram.cu"), d)
        with open(os.path.join(d, "histogram_common.cuh"), "w") as fp:
            fp.write(header if patch is None else patch(header))
        sources[name] = os.path.join(d, "histogram.cu")
    targets = {name: os.path.join(tmp, f"hist_{i}.so")
               for i, name in enumerate(sources)}
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
         "-o", targets[name], src], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for name, src in sources.items()}
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            sys.exit(f"{name}: nvcc failed\n{err}")
        for line in err.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
        lib = ctypes.CDLL(targets[name])
        lib.tpuhuff_hist256.argtypes = _build._SIGNATURES["tpuhuff_hist256"]
        lib.tpuhuff_hist256.restype = ctypes.c_int
        if name != "parent":
            per_sm = ctypes.c_int(0)
            grid = lib.tpuhuff_hist256_grid(ctypes.c_longlong(64 << 20),
                                            ctypes.byref(per_sm))
            print(f"grid {name}: {grid} blocks at 64 MiB, {per_sm.value} to "
                  "an SM", flush=True)
        libs[name] = lib
    return libs


_CHILD = r"""
import importlib.util, json, sys, numpy as np, torch
sys.path.insert(0, sys.argv[1])
from tpuhuff_torch.kernels import histogram
spec = importlib.util.spec_from_file_location("smoke", sys.argv[2])
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
res = {}
for kind, path in json.loads(sys.argv[3]).items():
    x = torch.from_numpy(np.fromfile(path, dtype=np.uint8)).cuda()
    ms = smoke.cuda_ms(torch, lambda: histogram(x))
    alone, host = smoke.spin_ms(torch, lambda: histogram(x))
    res[kind] = [ms, alone, host]
print("RESULT " + json.dumps(res), flush=True)
"""


def parent_wrapper(parent: str, files: dict) -> dict:
    out = subprocess.run(
        [sys.executable, "-c", _CHILD, parent,
         os.path.join(ROOT, "chip_smoke.py"), json.dumps(files)],
        cwd=parent, capture_output=True, text=True, timeout=900)
    line = [x for x in out.stdout.splitlines() if x.startswith("RESULT ")]
    if out.returncode != 0 or not line:
        sys.exit(f"the parent's wrapper failed:\n{out.stdout}\n{out.stderr}")
    return json.loads(line[0][len("RESULT "):])


def main() -> None:
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    parent = os.path.abspath(sys.argv[1])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all(tmp, parent)
        inputs = {kind: torch.from_numpy(make_hist_input(
            kind, SIZES_MIB[-1] << 20, np, seed=11)).to(dev)
            for kind in HIST_KINDS}
        out = torch.zeros(256, dtype=torch.int64, device=dev)

        def run(lib, x) -> None:
            err = lib.tpuhuff_hist256(x.data_ptr(), x.numel(), out.data_ptr(),
                                      stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")

        names = list(libs)
        for mib in SIZES_MIB:
            for kind, data in inputs.items():
                x = data[: mib << 20]
                want = torch.bincount(x, minlength=256)
                for name in names:
                    out.zero_()
                    run(libs[name], x)
                    if VARIANTS.get(name, (None, True))[1] and not torch.equal(
                            out, want):
                        sys.exit(f"{name} is not exact on {mib} MiB of {kind}")
                times = {name: [] for name in names}
                for name in names + names[::-1]:
                    times[name].append(cuda_ms(torch, lambda: run(libs[name], x),
                                               reps=20))
                bound = (x.numel() + 2 * 256 * 8) / HBM_BYTES_PER_MS
                print(f"{mib} MiB of {kind} (bound {bound:.4f} ms): " + ", ".join(
                    f"{name} {t[0]:.4f} / {t[1]:.4f} ms" for name, t in
                    times.items()) + f" [{card}]", flush=True)

        # the wrappers, at 64 MiB: parent / this / this / parent
        files = {}
        for kind, data in inputs.items():
            files[kind] = os.path.join(tmp, f"{len(files)}.bin")
            data.cpu().numpy().tofile(files[kind])
        readings = {kind: [] for kind in HIST_KINDS}
        for label in ("parent", "this", "this", "parent"):
            if label == "parent":
                for kind, r in parent_wrapper(parent, files).items():
                    readings[kind].append(("parent", *r))
                continue
            for kind, x in inputs.items():
                ms = cuda_ms(torch, lambda: histogram(x, out=out))
                alone, host = spin_ms(torch, lambda: histogram(x, out=out))
                bare, _ = spin_ms(torch, lambda: histogram(x))
                readings[kind].append(("this", ms, alone, host))
                print(f"wrapper this, 64 MiB of {kind}, no out=: alone "
                      f"{bare:.4f} ms", flush=True)
        for kind, rows in readings.items():
            print(f"wrapper at 64 MiB of {kind} (card ms, alone ms, host ms "
                  "per call): " + "; ".join(
                      f"{who} {ms:.4f}, {alone:.4f}, {host:.4f}"
                      for who, ms, alone, host in rows) + f" [{card}]",
                  flush=True)


if __name__ == "__main__":
    main()
