#!/usr/bin/env python3
"""Bytes per thread, tile size and input stages of the encode kernels (K1, K5).

Prints what ``nvcc -Xptxas -v`` reports for every instantiation of
``csrc/encode.cu`` at the defaults (registers, spills; the kernel is a
template on the bytes per thread P and K5's route), then builds the source
once for each (bytes per thread, tile bytes, stages), with
``-DTPUHUFF_ENCODE_BYTES_PER_THREAD=q -DTPUHUFF_ENCODE_TILE_BYTES=t
-DTPUHUFF_ENCODE_STAGES=s`` (all builds side by side), and works on one
64 MiB chunk of the main path: 262,144 lanes of 256 bytes of textlike data
under its canonical tree.  Each build is checked bit-exact against the
plain PyTorch version (K1, and K5 with ``hist_data`` = the lanes), then K1
and K5 are timed with CUDA events, in the order given and again in reverse
so that drift shows, beside each build's plan (lanes per tile, shared
memory per thread block, thread blocks per SM).

Run from the root of a checkout on a machine with an NVIDIA card and nvcc:

    python3 experiments/encode_sweep.py
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import cuda_ms, make_textlike  # noqa: E402
from tpuhuff_torch.core.canonical import (  # noqa: E402
    build_tree_for_device,
    canonicalize,
)
from tpuhuff_torch.core.weights import ByteWeights  # noqa: E402
from tpuhuff_torch.kernels import _build  # noqa: E402
from tpuhuff_torch.kernels.encode import (  # noqa: E402
    encode_blocks_reference,
    make_encode_tables,
    out_words,
)

BYTES_PER_THREAD = (8, 16, 32)
TILE_BYTES = (4096, 8192, 16384)
STAGES = (1, 2)
LANE = 256
SOURCE = os.path.join(ROOT, "tpuhuff_torch", "csrc", "encode.cu")


def ptxas_report() -> None:
    """Compile the source once more with -Xptxas -v, at the defaults (the
    shared memory is dynamic: the plans below give it)."""
    with tempfile.TemporaryDirectory() as tmp:
        r = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
             "-o", os.path.join(tmp, "x.o"), SOURCE],
            capture_output=True, text=True, check=True)
    name = None
    for line in r.stderr.splitlines():
        m = re.search(r"Compiling entry function '[^']*encode_tilesILi(\d+)ELi(\d)E",
                      line)
        if m:
            name = f"P {m.group(1)}, route {m.group(2)}"
        elif name and ("Used" in line or "spill" in line):
            print(f"encode.cu {name}: {line.split(':', 1)[-1].strip()}",
                  flush=True)


def build_all(grid, tmp: str) -> dict:
    """One library of the encode kernels per (bytes per thread, tile
    bytes, stages)."""
    targets = {key: os.path.join(tmp, "enc_{}_{}_{}.so".format(*key))
               for key in grid}
    t0 = time.perf_counter()
    _build._run([[_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                  f"-DTPUHUFF_ENCODE_BYTES_PER_THREAD={q}",
                  f"-DTPUHUFF_ENCODE_TILE_BYTES={t}",
                  f"-DTPUHUFF_ENCODE_STAGES={s}", "-o", target, SOURCE]
                 for (q, t, s), target in targets.items()])
    print(f"{len(targets)} builds side by side in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    libs = {}
    for ts, target in targets.items():
        lib = ctypes.CDLL(target)
        for name, argtypes in _build._SIGNATURES.items():
            if name.startswith("tpuhuff_encode"):
                getattr(lib, name).argtypes = argtypes
                getattr(lib, name).restype = ctypes.c_int
        # B, N, R, with a histogram, out: the plan a launch takes
        lib.tpuhuff_encode_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.tpuhuff_encode_plan.restype = ctypes.c_int
        libs[ts] = lib
    return libs


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    ptxas_report()
    dev = torch.device("cuda", 0)
    text = make_textlike(100 << 20, np)
    tree = canonicalize(build_tree_for_device(
        ByteWeights(np.bincount(text, minlength=256)), 32)[0])
    etab = make_encode_tables(*tree.encode_tables()).to(dev)
    B = (64 << 20) // LANE
    lanes = torch.from_numpy(text[: B * LANE].reshape(B, LANE)).to(dev)
    valid = torch.full((B,), LANE, dtype=torch.int32, device=dev)
    R = out_words(LANE, etab.max_len)
    want = encode_blocks_reference(lanes, valid, etab, hist_data=lanes)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(lib, hist: bool):
        words = torch.empty((B, R), dtype=torch.int32, device=dev)
        bits = torch.empty(B, dtype=torch.int32, device=dev)
        miss = torch.empty(B, dtype=torch.int32, device=dev)
        args = (lanes.data_ptr(), valid.data_ptr(), etab.lens.data_ptr(),
                etab.acodes.data_ptr(), words.data_ptr(), bits.data_ptr(),
                miss.data_ptr(), B, LANE, R)
        if not hist:
            err = lib.tpuhuff_encode_lanes(*args, stream)
            out = (words, bits, miss)
        else:
            counts = torch.zeros(256, dtype=torch.int64, device=dev)
            err = lib.tpuhuff_encode_lanes_hist(
                *args, lanes.data_ptr(), lanes.numel(), counts.data_ptr(),
                stream)
            out = (words, bits, miss, counts)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return out

    grid = [(q, t, s) for q in BYTES_PER_THREAD for s in STAGES
            for t in TILE_BYTES]
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all(grid, tmp)
        for key, lib in libs.items():
            same = all(torch.equal(g, w) for g, w in zip(run(lib, True), want))
            same = same and all(torch.equal(g, w) for g, w in
                                zip(run(lib, False), want[:3]))
            torch.cuda.synchronize()
            if not same:
                sys.exit("bytes per thread {}, tile bytes {}, stages {}: not "
                         "bit-exact".format(*key))
        print("every (bytes per thread, tile bytes, stages): K1 and K5 "
              "bit-exact against the plain version", flush=True)
        for q, t, s in grid + grid[::-1]:
            lib = libs[(q, t, s)]
            plans = []
            for hist in (0, 1):
                out = (ctypes.c_int32 * 5)()
                if lib.tpuhuff_encode_plan(B, LANE, R, hist, out):
                    sys.exit("tpuhuff_encode_plan failed")
                plans.append(f"{out[0]} lanes, {out[2]} B, {out[3]} per SM")
            k1 = cuda_ms(torch, lambda: run(lib, False), reps=20)
            k5 = cuda_ms(torch, lambda: run(lib, True), reps=20)
            print(f"bytes per thread {q}, tile bytes {t}, stages {s} (K1: "
                  f"{plans[0]}; K5: {plans[1]}): K1 {k1:.4f} ms, K5 "
                  f"{k5:.4f} ms ({B} lanes of {LANE} B, hist_data = the "
                  f"lanes) [{card}]", flush=True)


if __name__ == "__main__":
    main()
