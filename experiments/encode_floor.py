#!/usr/bin/env python3
"""What the encode kernels' time (K1, K5) is made of at the main path's shape.

Builds ``tpuhuff_torch/csrc/encode.cu`` as it is and patched copies,
written to a temporary directory (the source is not touched):

* ``no lane work``: the per-lane body (lookup, scan, packing) replaced by a
  trivial use of the loaded bytes, so that the kernel only streams its
  tiles in and copies the (zeroed) output tiles out: the floor of the tile
  structure, with the same bytes moved;
* ``wide table only``: the 8-byte (code, length) table even where every
  code fits the 4-byte one;
* what K5's count of the bytes it holds costs (these copies' counts are
  wrong by design, and only their times are read): ``no count`` drops the
  shared ``atomicAdd`` per byte; ``plain increments`` makes it a plain
  shared read-modify-write (racy), so that the atomic's own cost shows;
  ``one bin array per thread block`` gives all warps one set of bins in
  place of one set each, so that contention on the bins shows.

Works on one 64 MiB chunk of the main path (262,144 lanes of 256 bytes of
textlike data under its canonical tree), checks the unpatched build
bit-exact against the plain version, and times every build's K1 and K5
(``hist_data`` = the lanes) with CUDA events in turns, forward and back,
beside a ``torch`` ``copy_`` that reads and writes as many bytes in all as
K1 does.  The C entry points are called directly, so no Python wrapper
time is in the numbers.

Run from the root of a checkout on a machine with an NVIDIA card and nvcc:

    python3 experiments/encode_floor.py
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

LANE = 256
CSRC = os.path.join(ROOT, "tpuhuff_torch", "csrc")
# variant: (text in encode.cu, what replaces it)
PATCHES = {
    "as it is": None,
    "no lane work": (
        """      uint32_t total, nmiss;
      tpuhuff_encode::encode_lane<P>(wp, s, S, b, nvalid, table,
                                     s_out + l * p.R, active, total, nmiss);""",
        """      const uint32_t total = b.w[0] + nvalid, nmiss = 0;"""),
    "wide table only": (
        "__syncthreads_or(my_len > tpuhuff_encode::kNarrowMaxLen) != 0",
        "__syncthreads_or(1) != 0"),
    "no count": ("    atomicAdd(&bins[v], 1u);\n#endif",
                 "    (void)v;\n#endif"),
    "plain increments": ("    atomicAdd(&bins[v], 1u);\n#endif",
                         "    bins[v] += 1u;\n#endif"),
    "one bin array per thread block": (
        "uint32_t* bins = s_bins + warp * 256;", "uint32_t* bins = s_bins;"),
}


def build_all(tmp: str) -> dict:
    """One library per variant, built side by side."""
    with open(os.path.join(CSRC, "encode.cu")) as fp:
        source = fp.read()
    targets, cmds = {}, []
    for i, (name, patch) in enumerate(PATCHES.items()):
        src = os.path.join(tmp, f"encode_{i}.cu")
        text = source
        if patch is not None:
            if patch[0] not in source:
                sys.exit(f"{name}: the text to patch is not in encode.cu")
            text = source.replace(patch[0], patch[1])
        with open(src, "w") as fp:
            fp.write(text)
        targets[name] = os.path.join(tmp, f"encode_{i}.so")
        cmds.append([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", CSRC,
                     "-o", targets[name], src])
    _build._run(cmds)
    libs = {}
    for name, target in targets.items():
        lib = ctypes.CDLL(target)
        for fn, argtypes in _build._SIGNATURES.items():
            if fn.startswith("tpuhuff_encode"):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


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
    words = torch.empty((B, R), dtype=torch.int32, device=dev)
    bits = torch.empty(B, dtype=torch.int32, device=dev)
    miss = torch.empty(B, dtype=torch.int32, device=dev)
    counts = torch.zeros(256, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (lanes.data_ptr(), valid.data_ptr(), etab.lens.data_ptr(),
            etab.acodes.data_ptr(), words.data_ptr(), bits.data_ptr(),
            miss.data_ptr(), B, LANE, R)

    def run(lib, hist: bool) -> None:
        if hist:
            err = lib.tpuhuff_encode_lanes_hist(
                *args, lanes.data_ptr(), lanes.numel(), counts.data_ptr(),
                stream)
        else:
            err = lib.tpuhuff_encode_lanes(*args, stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    with tempfile.TemporaryDirectory() as tmp:
        libs = build_all(tmp)
        counts.zero_()
        run(libs["as it is"], True)
        want = encode_blocks_reference(lanes, valid, etab, hist_data=lanes)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in
                   zip((words, bits, miss, counts), want)):
            sys.exit("the unpatched build is not bit-exact")
        moved = lanes.numel() + words.numel() * 4  # K1's bytes in and out
        src = torch.empty(moved // 2, dtype=torch.uint8, device=dev)
        dst = torch.empty_like(src)
        names = list(libs)
        for name in names + names[::-1]:
            k1 = cuda_ms(torch, lambda: run(libs[name], False), reps=20)
            k5 = cuda_ms(torch, lambda: run(libs[name], True), reps=20)
            print(f"{name}: K1 {k1:.4f} ms, K5 {k5:.4f} ms ({B} lanes of "
                  f"{LANE} B) [{card}]", flush=True)
        copy_ms = cuda_ms(torch, lambda: dst.copy_(src), reps=20)
        print(f"copy_ of {moved // 2} B, {moved} B read and written (as "
              f"K1): {copy_ms:.4f} ms [{card}]", flush=True)


if __name__ == "__main__":
    main()
