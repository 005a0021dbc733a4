#!/usr/bin/env python3
"""Lanes per warp of the encode kernel (K1) and its fused histogram form (K5).

Builds ``tpuhuff_torch/csrc/encode.cu`` once for each value of
``TPUHUFF_LANES_PER_WARP`` (a thread block of 8 warps then covers 8 x that
many lanes, and K5 merges its counts into the global counters once per
block), checks each build bit-exact against the plain PyTorch version, and
times K1 and K5 (``hist_data`` = the lanes) with CUDA events on one 64 MiB
chunk of the main path: 262,144 lanes of 256 bytes of textlike data.  The
builds are timed in turns (1, 2, 4, 8, 8, 4, 2, 1) so that drift shows.

Run from the root of a checkout on a machine with an NVIDIA card and nvcc:

    python3 experiments/k5_lanes_per_warp.py
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

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

LANES_PER_WARP = (1, 2, 4, 8)
LANE = 256


def build(lpw: int, tmp: str) -> ctypes.CDLL:
    target = os.path.join(tmp, f"enc{lpw}.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                    f"-DTPUHUFF_LANES_PER_WARP={lpw}", "-o", target,
                    os.path.join(ROOT, "tpuhuff_torch", "csrc", "encode.cu")],
                   check=True)
    lib = ctypes.CDLL(target)
    for name, argtypes in _build._SIGNATURES.items():
        if name.startswith("tpuhuff_encode"):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
    return lib


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
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

    with tempfile.TemporaryDirectory() as tmp:
        libs = {lpw: build(lpw, tmp) for lpw in LANES_PER_WARP}

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
                raise RuntimeError(f"launch failed: {err}")
            return out

        for lpw, lib in libs.items():
            got = run(lib, True)
            torch.cuda.synchronize()
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            same = same and all(torch.equal(g, w) for g, w in
                                zip(run(lib, False), want[:3]))
            torch.cuda.synchronize()
            print(f"lanes per warp {lpw}: bit-exact against the plain "
                  f"version: {same}", flush=True)
            if not same:
                sys.exit(1)
        order = LANES_PER_WARP + LANES_PER_WARP[::-1]
        for lpw in order:
            lib = libs[lpw]
            k1 = cuda_ms(torch, lambda: run(lib, False), reps=20)
            k5 = cuda_ms(torch, lambda: run(lib, True), reps=20)
            print(f"lanes per warp {lpw}: K1 {k1:.4f} ms, K5 {k5:.4f} ms "
                  f"({B} lanes of {LANE} B, hist_data = the lanes) [{card}]",
                  flush=True)


if __name__ == "__main__":
    main()
