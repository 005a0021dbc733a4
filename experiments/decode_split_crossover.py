#!/usr/bin/env python3
"""Which rows the decoders K2 and K4 should send to their global-rows route.

The decoders have two routes (``csrc/decode_common.cuh``): rows staged in
shared memory, one thread per Huffman block, and the global-rows route,
one thread block per Huffman block, its bits split into subsequences that
synchronise themselves (``csrc/decode_split.cuh``).  Rows of which not one
fits in shared memory must take the second; this script times both routes
where the staged route fits only a few rows to a thread block, to set the
rule ``TPUHUFF_DECODE_SPLIT_BELOW`` (rows that the staged route fits fewer
than this many to a thread block take the global-rows route).

It prints ``nvcc -Xptxas -v`` for the two decode sources (registers and
spills of both instances), then builds ``csrc/decode.cu`` and
``csrc/decode_general.cu`` once per (rule, subsequence bits), with
``-DTPUHUFF_DECODE_SPLIT_BELOW=`` 1 (only rows that do not fit) or 33, and
``-DTPUHUFF_DECODE_SPLIT_BITS=`` 256, 512, 1024 or 2048, and, given the
root of another checkout (the parent commit), its two sources as they are,
and the checkout's own as they are (all side by side).  With the parent,
it first times the staged route at the main path's shape (262,144 blocks
of 256 bytes), parent, this, this, parent.  The shapes are those that the
staged route fits up to 32 to a thread block, among them phase-7b
launches of ``chip_smoke.py``: 4096-byte blocks of 8-bit (32 to a thread
block), 13-14-bit and 25-32-bit codes, 65536-byte blocks of 8-bit and of
13-14-bit codes, and 16 blocks of 65536 codes of 15-24 and of 25-32
bits.  For each it prints the staged route's rows per thread block,
checks every library's output against the source (whole blocks), and
times K2 (canonical tree) and K4 (the mirrored tree) with CUDA events,
each library in turn and again in reverse order.  Last, the sync rounds of the split body, counted by the
CPU harness of ``tests/test_torch_decode_split.py`` (the header's own code,
built with g++) at the launch's threads per thread block, on these rows
and on rows of 60,000 random words like phase 3's.

Run from the root of a checkout on a machine with an NVIDIA card, nvcc and
g++:

    python3 experiments/decode_split_crossover.py [PARENT_CHECKOUT]
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

from chip_smoke import cuda_ms, make_textlike, wide_code_blocks  # noqa: E402
from test_torch_decode_split import build_harness  # noqa: E402
from tpuhuff_torch import native  # noqa: E402
from tpuhuff_torch.core.canonical import (  # noqa: E402
    build_tree_for_device,
    canonicalize,
)
from tpuhuff_torch.core.tree import HuffTree  # noqa: E402
from tpuhuff_torch.core.weights import ByteWeights  # noqa: E402
from tpuhuff_torch.kernels import _build, decoder_for  # noqa: E402
from tpuhuff_torch.kernels.decode import payload_to_lane_words  # noqa: E402

SOURCES = [os.path.join(ROOT, "tpuhuff_torch", "csrc", name)
           for name in ("decode.cu", "decode_general.cu")]
VARIANTS = [(below, bits) for below in (1, 33) for bits in (256, 512, 1024, 2048)]
LANE = 256  # the main path's blocks


def ptxas_report() -> None:
    with tempfile.TemporaryDirectory() as tmp:
        for src in SOURCES:
            r = subprocess.run(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                 "-o", os.path.join(tmp, "x.o"), src],
                capture_output=True, text=True, check=True)
            for line in r.stderr.splitlines():
                if "Compiling" in line or "Used" in line or "spill" in line:
                    print(f"{os.path.basename(src)}: {line.strip()}",
                          flush=True)


def build_all(tmp: str, parent: str | None) -> dict:
    """One library of both decode kernels per variant, one as the checkout
    builds them (key "this") and one of the sources under ``parent`` (key
    "parent"), built side by side."""
    targets = {v: os.path.join(tmp, f"dec_{v[0]}_{v[1]}.so") for v in VARIANTS}
    cmds = [[_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
             f"-DTPUHUFF_DECODE_SPLIT_BELOW={below}",
             f"-DTPUHUFF_DECODE_SPLIT_BITS={bits}", "-o", target, *SOURCES]
            for (below, bits), target in targets.items()]
    targets["this"] = os.path.join(tmp, "dec_this.so")
    cmds.append([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                 targets["this"], *SOURCES])
    if parent:
        targets["parent"] = os.path.join(tmp, "dec_parent.so")
        cmds.append([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                     targets["parent"],
                     *(os.path.join(parent, "tpuhuff_torch", "csrc", name)
                       for name in ("decode.cu", "decode_general.cu"))])
    _build._run(cmds)
    libs = {}
    for v, target in targets.items():
        lib = ctypes.CDLL(target)
        for name, argtypes in _build._SIGNATURES.items():
            if name.startswith("tpuhuff_decode"):
                getattr(lib, name).argtypes = argtypes
                getattr(lib, name).restype = ctypes.c_int
        libs[v] = lib
    return libs


def uniform_blocks(n_blocks: int, block_len: int) -> dict:
    """Blocks of uniform random bytes under the tree of equal counts
    (8-bit codes), as ``wide_code_blocks`` returns them."""
    tree = canonicalize(build_tree_for_device(
        ByteWeights(np.ones(256, dtype=np.int64)), 32)[0])
    data = np.random.default_rng(2).integers(0, 256, n_blocks * block_len,
                                             dtype=np.uint8)
    cases = {}
    for key, t in (("decode", tree),
                   ("decode_general", HuffTree(tree.right, tree.left,
                                               tree.letters, tree.weights,
                                               tree.root))):
        payload, _, bits = native.encode_blocks_host(data, block_len,
                                                     *t.encode_tables())
        ends = np.cumsum(bits.astype(np.int64))
        rows, bit0 = payload_to_lane_words(payload, ends - bits.astype(np.int64),
                                           ends, block_len)
        cases[key] = (t, data, rows, bit0, bits.astype(np.int32))
    return cases


def call(lib, key, tab, rows, bit0, nbits, out, block_len, route=None):
    """One launch of K2 (key "decode") or K4 from ``lib``'s C entries."""
    B, W = rows.shape
    head = (rows.data_ptr(), bit0.data_ptr(), nbits.data_ptr())
    tail = (tab.lut.data_ptr(), out.data_ptr(), B, W, block_len)
    where = ctypes.addressof(route) if route is not None else None
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    if key == "decode":
        err = lib.tpuhuff_decode_rows(
            *head, tab.ub.data_ptr(), tab.dd.data_ptr(), tab.perm.data_ptr(),
            *tail, tab.max_len, where, stream)
    else:
        err = lib.tpuhuff_decode_rows_general(
            *head, tab.thr.data_ptr(), tab.sym.data_ptr(), tab.len.data_ptr(),
            *tail, where, stream)
    if err:
        raise RuntimeError(f"{key}: CUDA error {err}")


def staged_against_parent(libs: dict, dev, card: str) -> None:
    """The staged route at the main path's shape (262,144 blocks of 256
    bytes of textlike data, rows as the file path gathers them), this
    checkout's build against the parent's: parent, this, this, parent."""
    text = make_textlike(64 << 20, np)
    tree = canonicalize(build_tree_for_device(
        ByteWeights(np.bincount(text, minlength=256)), 32)[0])
    mine = libs["this"]
    for key, t in (("decode", tree),
                   ("decode_general", HuffTree(tree.right, tree.left,
                                               tree.letters, tree.weights,
                                               tree.root))):
        payload, _, bits = native.encode_blocks_host(text, LANE,
                                                     *t.encode_tables())
        ends = np.cumsum(bits.astype(np.int64))
        rows_np, bit0_np = payload_to_lane_words(
            payload, ends - bits.astype(np.int64), ends, LANE)
        rows = torch.from_numpy(rows_np.view(np.int32)).to(dev)
        bit0 = torch.from_numpy(bit0_np).to(dev)
        nbits = torch.from_numpy(bits.astype(np.int32)).to(dev)
        tab = decoder_for(t)[1].to(dev)
        out = torch.empty((rows.shape[0], LANE), dtype=torch.uint8, device=dev)
        want = torch.from_numpy(text.reshape(-1, LANE)).to(dev)
        for lib in (libs["parent"], mine):
            out.fill_(0xA5)
            call(lib, key, tab, rows, bit0, nbits, out, LANE)
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                sys.exit(f"main shape {key}: not exact")
        name = "K2" if key == "decode" else "K4"
        for label in ("parent", "this", "this", "parent"):
            lib = libs["parent"] if label == "parent" else mine
            ms = cuda_ms(torch, lambda: call(lib, key, tab, rows, bit0, nbits,
                                             out, LANE), reps=20)
            print(f"main shape ({rows.shape[0]} blocks of {LANE} B, rows of "
                  f"{rows.shape[1]} words), staged {name}, {label}: "
                  f"{ms:.4f} ms [{card}]", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    parent = sys.argv[1] if len(sys.argv) > 1 else None
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    ptxas_report()
    dev = torch.device("cuda", 0)
    shapes = {  # name: (block_len, cases)
        "4096-byte blocks, 8-bit codes": (4096, uniform_blocks(16384, 4096)),
        "4096-byte blocks, 13-14-bit codes": (
            4096, wide_code_blocks(np, 16384, block_len=4096, lengths=(13, 14))),
        "4096-byte blocks, 25-32-bit codes": (
            4096, wide_code_blocks(np, 16384, block_len=4096, lengths=(25, 32))),
        "65536-byte blocks, 8-bit codes": (65536, uniform_blocks(1024, 65536)),
        "65536-byte blocks, 13-14-bit codes": (
            65536, wide_code_blocks(np, 1024, lengths=(13, 14))),
        "7b (iii): 16 blocks of 65536 codes of 15-24 bits": (
            65536, wide_code_blocks(np, 16, lengths=(15, 24))),
        "7b (iv): 16 blocks of 65536 codes of 25-32 bits": (
            65536, wide_code_blocks(np, 16)),
    }
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all(tmp, parent)
        if parent:
            staged_against_parent(libs, dev, card)
        staged_only = libs[(1, 512)]
        for shape, (block_len, cases) in shapes.items():
            for key, (tree, data, rows_np, bit0_np, bits_np) in cases.items():
                name = "K2" if key == "decode" else "K4"
                tab = decoder_for(tree)[1].to(dev)
                rows = torch.from_numpy(rows_np.view(np.int32)).to(dev)
                bit0 = torch.from_numpy(bit0_np).to(dev)
                nbits = torch.from_numpy(bits_np).to(dev)
                B, W = rows.shape
                out = torch.empty((B, block_len), dtype=torch.uint8, device=dev)
                want = torch.from_numpy(data.reshape(B, block_len)).to(dev)
                route = ctypes.c_int(0)

                def run(lib):
                    call(lib, key, tab, rows, bit0, nbits, out, block_len,
                         route)

                tile = (staged_only.tpuhuff_decode_rows_tile if key == "decode"
                        else staged_only.tpuhuff_decode_rows_general_tile)(
                            B, W, block_len)
                routes = {}
                for v in VARIANTS:
                    lib = libs[v]
                    out.fill_(0xA5)
                    run(lib)
                    torch.cuda.synchronize()
                    if not torch.equal(out, want):
                        sys.exit(f"{shape} {name} {v}: not exact")
                    routes[v] = "global" if route.value else "staged"
                print(f"{shape}, {name}: {B} blocks, rows of {W} words, staged "
                      f"fit {tile} per thread block; every variant exact",
                      flush=True)
                reps = 3 if B * block_len >= (1 << 26) else 5
                for v in VARIANTS + VARIANTS[::-1]:
                    ms = cuda_ms(torch, lambda: run(libs[v]), reps=reps)
                    print(f"  SPLIT_BELOW {v[0]:2d}, SPLIT_BITS {v[1]:4d} "
                          f"({routes[v]}): {ms:.4f} ms [{card}]", flush=True)
                del rows, out, want

    sync_rounds(shapes)


def sync_rounds(shapes: dict) -> None:
    """The split body's sync rounds per block (at most the first 64 of a
    shape), on the CPU harness at the launch's threads per thread block;
    then on rows of 60,000 random words like phase 3's, under a textlike
    tree and its mirror, at block_len 300."""
    gxx = shutil.which("g++")
    if gxx is None:
        sys.exit("g++ is not installed: no sync rounds")
    rng = np.random.default_rng(60_000)
    B, W = 64, 60_000
    random_rows = (rng.integers(0, 1 << 32, (B, W), dtype=np.uint64)
                   .astype(np.uint32),
                   rng.integers(0, 32 * W, B).astype(np.int32),
                   rng.integers(0, 32 * W, B).astype(np.int32))
    text = make_textlike(1 << 22, np)
    text_tree = canonicalize(build_tree_for_device(
        ByteWeights(np.bincount(text, minlength=256)), 32)[0])
    runs = []
    for shape, (block_len, cases) in shapes.items():
        for key, (tree, _, rows, bit0, bits) in cases.items():
            n = min(rows.shape[0], 64)
            runs.append((shape, key, tree, block_len, rows[:n], bit0[:n],
                         bits[:n]))
    for key, tree in (("decode", text_tree),
                      ("decode_general", HuffTree(
                          text_tree.right, text_tree.left, text_tree.letters,
                          text_tree.weights, text_tree.root))):
        runs.append(("phase 3's 64 x 60,000 random words, textlike tree, "
                      "block_len 300", key, tree, 300, *random_rows))
    with tempfile.TemporaryDirectory() as tmp:
        harness = build_harness(gxx, Path(tmp))
        for shape, key, tree, block_len, rows, bit0, bits in runs:
            T = harness.split_threads(rows.shape[1])
            _, rounds = harness(rows, bit0, bits, decoder_for(tree)[1],
                                block_len, T)
            few = np.bincount(np.minimum(rounds, 3), minlength=4).tolist()
            print(f"sync rounds, {shape}, {'K2' if key == 'decode' else 'K4'}"
                  f": {rows.shape[0]} blocks on {T} threads: most "
                  f"{int(rounds.max())}, mean {rounds.mean():.3f}, blocks at "
                  f"0/1/2/3+ rounds {few}", flush=True)


if __name__ == "__main__":
    main()
