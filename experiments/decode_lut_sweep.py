#!/usr/bin/env python3
"""First-level table bits k and tile rows n of the decode kernels (K2, K4).

Prints what ``nvcc -Xptxas -v`` reports for the two decode kernels at the
defaults (registers, shared memory, spills), then builds
``csrc/decode.cu`` and ``csrc/decode_general.cu`` once for each (k, n),
with ``-DTPUHUFF_DECODE_LUT_BITS=k -DTPUHUFF_DECODE_TILE_ROWS=n`` (all
builds side by side), and works on one 64 MiB chunk of the main path:
262,144 blocks of 256 bytes of textlike data, encoded by K1 under the
canonical tree (K2) and under the same code lengths in the device
writer's own, non-canonical order (K4), the rows as wide as the file
path's row gather makes them.  For each k it prints the share of the
chunk's symbols whose code is longer than k bits (they escape the table);
for each (k, n) it checks both kernels bit-exact against the chunk, then
times them with CUDA events, in the order given and again in reverse so
that drift shows.  Last, both kernels at the defaults on rows as wide as
K1's output.

Run from the root of a checkout on a machine with an NVIDIA card and nvcc:

    python3 experiments/decode_lut_sweep.py
"""

from __future__ import annotations

import ctypes
import dataclasses
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
from tpuhuff_torch.core.tree import HuffTree  # noqa: E402
from tpuhuff_torch.core.weights import ByteWeights  # noqa: E402
from tpuhuff_torch.kernels import _build  # noqa: E402
from tpuhuff_torch.kernels import decode as dec  # noqa: E402
from tpuhuff_torch.kernels.encode import (  # noqa: E402
    encode_blocks,
    make_encode_tables,
)

LUT_BITS = (10, 11, 12, 13, 14)
TILE_ROWS = (128, 256, 512, 768, 1024)
LANE = 256
SOURCES = [os.path.join(ROOT, "tpuhuff_torch", "csrc", name)
           for name in ("decode.cu", "decode_general.cu")]


def ptxas_report() -> None:
    """Compile each decode source once more with -Xptxas -v."""
    with tempfile.TemporaryDirectory() as tmp:
        for src in SOURCES:
            r = subprocess.run(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                 "-o", os.path.join(tmp, "x.o"), src],
                capture_output=True, text=True, check=True)
            for line in r.stderr.splitlines():
                if "Used" in line or "spill" in line:
                    print(f"{os.path.basename(src)}: {line.strip()}",
                          flush=True)


def build_all(grid, tmp: str) -> dict:
    """One library of both decode kernels per (k, n), built side by side."""
    targets = {kn: os.path.join(tmp, f"dec_{kn[0]}_{kn[1]}.so") for kn in grid}
    _build._run([[_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                  f"-DTPUHUFF_DECODE_LUT_BITS={k}",
                  f"-DTPUHUFF_DECODE_TILE_ROWS={n}", "-o", target, *SOURCES]
                 for (k, n), target in targets.items()])
    libs = {}
    for kn, target in targets.items():
        lib = ctypes.CDLL(target)
        for name, argtypes in _build._SIGNATURES.items():
            if name.startswith("tpuhuff_decode"):
                getattr(lib, name).argtypes = argtypes
                getattr(lib, name).restype = ctypes.c_int
        libs[kn] = lib
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
    counts = np.bincount(text, minlength=256)
    device_tree = build_tree_for_device(ByteWeights(counts), 32)[0]
    trees = {"K2": canonicalize(device_tree), "K4": device_tree}
    if dec.make_canonical_decode_tables(trees["K4"]) is not None:
        t = trees["K4"]
        trees["K4"] = HuffTree(t.right, t.left, t.letters, t.weights, t.root)
    B = (64 << 20) // LANE
    chunk = text[: B * LANE]
    lanes = torch.from_numpy(chunk.reshape(B, LANE)).to(dev)
    valid = torch.full((B,), LANE, dtype=torch.int32, device=dev)
    bit0 = torch.zeros(B, dtype=torch.int32, device=dev)
    code_lens = trees["K2"].encode_tables()[0].astype(np.int64)
    chunk_counts = np.bincount(chunk, minlength=256)
    for k in LUT_BITS:
        share = chunk_counts[code_lens > k].sum() / chunk_counts.sum()
        print(f"k {k}: {share:.6%} of the chunk's symbols escape the table "
              f"(codes longer than {k} bits)", flush=True)

    ops = {}
    for name, tree in trees.items():
        words, bits, _ = encode_blocks(
            lanes, valid, make_encode_tables(*tree.encode_tables()).to(dev))
        used = (int(bits.max()) + 31) // 32
        ops[name] = {"full": torch.nn.functional.pad(words, (0, 1)),
                     "rows": torch.nn.functional.pad(words[:, :used],
                                                     (0, 1)).contiguous(),
                     "nbits": bits}
    tables = {"K2": dec.make_canonical_decode_tables(trees["K2"]),
              "K4": dec.make_decode_tables(trees["K4"])}
    tables = {(name, k): dataclasses.replace(
                  tab, lut=dec.first_level_table(tab, k)).to(dev)
              for name, tab in tables.items() for k in LUT_BITS}
    W = ops["K2"]["rows"].shape[1]
    print(f"{B} blocks of {LANE} B; rows of {W} words (K1's output: "
          f"{ops['K2']['full'].shape[1]})", flush=True)

    def run(lib, name, k, rows_key="rows"):
        o, tab = ops[name], tables[(name, k)]
        rows = o[rows_key]
        out = torch.empty((B, LANE), dtype=torch.uint8, device=dev)
        head = (rows.data_ptr(), bit0.data_ptr(), o["nbits"].data_ptr())
        tail = (tab.lut.data_ptr(), out.data_ptr(), B, rows.shape[1], LANE)
        stream = torch.cuda.current_stream(dev).cuda_stream
        if name == "K2":
            err = lib.tpuhuff_decode_rows(
                *head, tab.ub.data_ptr(), tab.dd.data_ptr(),
                tab.perm.data_ptr(), *tail, tab.max_len, None, stream)
        else:
            err = lib.tpuhuff_decode_rows_general(
                *head, tab.thr.data_ptr(), tab.sym.data_ptr(),
                tab.len.data_ptr(), *tail, None, stream)
        if err:
            raise RuntimeError(f"{name} at k {k}: CUDA error {err}")
        return out

    grid = [(k, n) for k in LUT_BITS for n in TILE_ROWS]
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all(grid, tmp)
        for k, n in grid:
            for name in trees:
                got = run(libs[(k, n)], name, k)
                torch.cuda.synchronize()
                if not torch.equal(got, lanes):
                    sys.exit(f"{name} at k {k}, n {n}: not bit-exact")
        print("every (k, n): K2 and K4 restore the chunk bit for bit",
              flush=True)
        for k, n in grid + grid[::-1]:
            lib = libs[(k, n)]
            taken = [lib.tpuhuff_decode_rows_tile(B, W, LANE),
                     lib.tpuhuff_decode_rows_general_tile(B, W, LANE)]
            ms = {name: cuda_ms(torch, lambda: run(lib, name, k), reps=20)
                  for name in trees}
            print(f"k {k}, n {n} (taken {taken[0]}/{taken[1]}): K2 "
                  f"{ms['K2']:.4f} ms, K4 {ms['K4']:.4f} ms [{card}]",
                  flush=True)
        k = dec.LUT_BITS
        lib = libs[(k, 768)]
        for name in trees:
            ms = cuda_ms(torch, lambda: run(lib, name, k, "full"), reps=20)
            print(f"{name} at K1's full width ({ops[name]['full'].shape[1]} "
                  f"words), k {k}, n 768: {ms:.4f} ms [{card}]", flush=True)


if __name__ == "__main__":
    main()
