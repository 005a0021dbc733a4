#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``tpuhuff_torch``) on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA card, the CUDA
toolkit (``nvcc``) and PyTorch built for CUDA:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. environment: the card's name and power limit, torch and CUDA versions;
2. build of the three CUDA kernels from ``tpuhuff_torch/csrc``;
3. each kernel against its plain PyTorch version on the card, bit-exact,
   on textlike, uniform-random, single-symbol and Fibonacci (32-bit code)
   inputs with ragged lanes and missing letters, plus histograms from 1 B
   to 100 MiB; kernel and plain times at the main path's shapes;
4. the main path: the ``.hf2`` device round trip through
   ``tpuhuff_torch.io`` on 100 MiB of textlike data (seed 42), a 16 MiB
   uniform-random file and the ~15 MB Fibonacci file.  Each container must
   have the SHA-256 of the host C++ writer's (``block_len=256,
   max_code_len=32``), and each decode must restore the source; every
   kernel's launch count must rise;
5. wall-clock rates of port compress and decompress beside the host C++
   writer and reader and a device-to-device copy of the same bytes.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Nothing of JAX is imported.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

MAIN_MB = 100          # config 2: 100 MiB of enwik-like text
RANDOM_MB = 16
LANE = 256             # the device writer's default block_len


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def make_textlike(n: int, np):
    """Config 2's enwik-like bytes (the recipe of bench.py's make_textlike)."""
    rng = np.random.default_rng(42)
    text = (
        b"the of and to in a is that it was for on are as with his they at "
        b"<page><title>Benchmark</title><revision><text xml:space=\"preserve\">"
        b"In information theory, a Huffman code is a particular type of optimal "
        b"prefix code that is commonly used for lossless data compression. "
    )
    base = np.frombuffer(text * (n // len(text) + 1), dtype=np.uint8)[:n].copy()
    idx = rng.integers(0, n, n // 64)
    base[idx] = rng.integers(0, 256, idx.size, dtype=np.uint8)
    return base


def make_fib(np):
    """~15 MB whose histogram is fib(1..34): an optimal tree 33 deep, so the
    device writer length-limits it to 32-bit codes."""
    fib = [1, 1]
    while len(fib) < 34:
        fib.append(fib[-1] + fib[-2])
    data = np.repeat(np.arange(34, dtype=np.uint8), fib)
    np.random.default_rng(21).shuffle(data)
    return data


def cuda_ms(torch, fn, reps: int = 5) -> float:
    """Mean device time of ``fn`` in ms, CUDA events around ``reps`` runs."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_err(torch, got, want) -> int:
    if got.shape != want.shape:
        fail(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    if got.numel() == 0:
        return 0
    return int((got.long() - want.long()).abs().max())


def sha(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fp:
        for piece in iter(lambda: fp.read(1 << 24), b""):
            h.update(piece)
    return h.hexdigest()


def same_file(a: str, b: str) -> bool:
    if os.path.getsize(a) != os.path.getsize(b):
        return False
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x, y = fa.read(1 << 24), fb.read(1 << 24)
            if x != y:
                return False
            if not x:
                return True


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import tpuhuff_torch  # noqa: F401
    except ImportError as e:
        fail(f"tpuhuff_torch is not importable ({e}): run from a checkout")
    from tpuhuff.core.canonical import build_tree_for_device, canonicalize
    from tpuhuff.core.weights import ByteWeights
    from tpuhuff.io import stream as host_stream
    from tpuhuff_torch.io import read_compress_write_hf2, read_decompress_write_hf2
    from tpuhuff_torch.kernels import (
        _build,
        decode_rows,
        decode_rows_reference,
        encode_blocks,
        encode_blocks_reference,
        histogram,
        histogram_reference,
        make_canonical_decode_tables,
        make_encode_tables,
    )

    # -- phase 1: environment ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
    if not card:
        fail(f"nvidia-smi gave no card: {smi.stderr.strip()}")
    dev = torch.device("cuda", torch.cuda.current_device())
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(dev)}, count "
        f"{torch.cuda.device_count()}, python {sys.version.split()[0]}")

    # -- phase 2: build ------------------------------------------------------
    t0 = time.perf_counter()
    _build.lib()
    log(f"phase 2: kernels built and loaded in {time.perf_counter() - t0:.3f} s "
        f"(nvcc {_build.build_seconds} s; None = cached build)")

    # -- phase 3: kernels against their plain versions -----------------------
    text = make_textlike(MAIN_MB << 20, np)
    fib = make_fib(np)
    rng = np.random.default_rng(7)

    def tree_of(data):
        return canonicalize(build_tree_for_device(
            ByteWeights(np.bincount(data, minlength=256)), 32)[0])

    main_lanes = (64 << 20) // LANE  # one 64 MiB chunk of pass 2
    head = text[: 1 << 20]
    cases = {
        "textlike": (text[: main_lanes * LANE], tree_of(text)),
        "random": (rng.integers(0, 256, 4 << 20, dtype=np.uint8), None),
        "single": (np.full(1 << 20, 65, np.uint8), None),
        "fib": (fib[: (fib.size // LANE) * LANE], tree_of(fib)),
        # a tree of the bytes < 128 only: the random bytes >= 128 have no code
        "missing": (head, tree_of(head[head < 128])),
    }
    errs = {"encode": 0, "decode": 0, "histogram": 0}
    shapes = {}
    for name, (data, tree) in cases.items():
        tree = tree if tree is not None else tree_of(data)
        etab = make_encode_tables(*tree.encode_tables()).to(dev)
        B = data.size // LANE
        lanes = torch.from_numpy(data.reshape(B, LANE)).to(dev)
        valid = torch.full((B,), LANE, dtype=torch.int32, device=dev)
        valid[1::5] = torch.from_numpy(
            rng.integers(0, LANE, valid[1::5].numel()).astype(np.int32)).to(dev)
        got = encode_blocks(lanes, valid, etab)
        want = encode_blocks_reference(lanes, valid, etab)
        torch.cuda.synchronize()
        err = max(max_err(torch, g, w) for g, w in zip(got, want))
        errs["encode"] = max(errs["encode"], err)
        words, bits, miss = got
        n_miss = int(miss.sum())
        if (n_miss > 0) != (name == "missing"):
            fail(f"encode {name}: {n_miss} missing letters")
        rows = torch.nn.functional.pad(words, (0, 1))
        bit0 = torch.zeros(B, dtype=torch.int32, device=dev)
        nbits = bits.clone()
        nbits[2::7] = (nbits[2::7] - 9).clamp(min=0)  # blocks cut short
        dtab = make_canonical_decode_tables(tree).to(dev)
        out = decode_rows(rows, bit0, nbits, dtab, LANE)
        plain = decode_rows_reference(rows, bit0, nbits, dtab, LANE)
        torch.cuda.synchronize()
        errs["decode"] = max(errs["decode"], max_err(torch, out, plain))
        if name != "missing":
            full = (valid == LANE) & (nbits == bits)
            if not torch.equal(out[full], lanes[full]):
                fail(f"decode {name}: the full lanes do not round-trip")
        log(f"phase 3: {name}: {B} lanes, max code {etab.max_len} bits, "
            f"encode err {err}, decode err {max_err(torch, out, plain)}, "
            f"missing {n_miss}")
        if name == "textlike":
            shapes = {"lanes": lanes, "valid": valid, "etab": etab,
                      "rows": rows, "bit0": bit0, "nbits": bits, "dtab": dtab}
    text_dev = torch.from_numpy(text).to(dev)
    for n in (1, 15, 4097, (1 << 20) + 3, MAIN_MB << 20):
        for off in (0, 3):
            view = text_dev[off: off + n]
            h = histogram(view)
            hp = histogram_reference(view)
            torch.cuda.synchronize()
            errs["histogram"] = max(errs["histogram"], max_err(torch, h, hp))
    log(f"phase 3: histogram over 1 B .. {MAIN_MB} MiB, max err "
        f"{errs['histogram']}")
    if any(errs.values()):
        fail(f"kernels disagree with their plain versions: {errs}")

    s = shapes
    hist_chunk = text_dev[: 64 << 20]
    timing = {
        "encode": (cuda_ms(torch, lambda: encode_blocks(
                       s["lanes"], s["valid"], s["etab"])),
                   cuda_ms(torch, lambda: encode_blocks_reference(
                       s["lanes"], s["valid"], s["etab"]), reps=2)),
        "decode": (cuda_ms(torch, lambda: decode_rows(
                       s["rows"], s["bit0"], s["nbits"], s["dtab"], LANE)),
                   cuda_ms(torch, lambda: decode_rows_reference(
                       s["rows"], s["bit0"], s["nbits"], s["dtab"], LANE),
                       reps=2)),
        "histogram": (cuda_ms(torch, lambda: histogram(hist_chunk)),
                      cuda_ms(torch, lambda: histogram_reference(hist_chunk))),
    }
    for k, (ms, plain_ms) in timing.items():
        log(f"phase 3: {k} at the main path's shapes: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms [{card}]")
    del shapes, s, text_dev, hist_chunk
    torch.cuda.synchronize()

    # -- phase 4: the main path ----------------------------------------------
    work = tempfile.mkdtemp(prefix="tpuhuff_chip_smoke_")
    try:
        files = {"textlike": text,
                 "random": np.random.default_rng(42).integers(
                     0, 256, RANDOM_MB << 20, dtype=np.uint8),
                 "fib": fib}
        for name, data in files.items():
            with open(os.path.join(work, f"{name}.bin"), "wb") as fp:
                fp.write(data.tobytes())
        del text, files
        counters = (encode_blocks, decode_rows, histogram)
        for fn in counters:
            fn.launches = 0
        for name in ("textlike", "random", "fib"):
            src = os.path.join(work, f"{name}.bin")
            dst, ref = src + ".hf2", src + ".ref.hf2"
            out, out_ref = src + ".out", src + ".ref.out"
            read_compress_write_hf2(src, dst, device=dev)
            read_decompress_write_hf2(dst, out, device=dev)
            host_stream.read_compress_write_hf2(src, ref, device=False,
                                                block_len=LANE, max_code_len=32)
            read_decompress_write_hf2(ref, out_ref, device=dev)
            if sha(dst) != sha(ref):
                fail(f"{name}: port container differs from the host writer's")
            if not same_file(out, src) or not same_file(out_ref, src):
                fail(f"{name}: device decode does not restore the source")
            log(f"phase 4: {name}: {os.path.getsize(src)} B -> "
                f"{os.path.getsize(dst)} B, sha256 {sha(dst)[:16]} == host "
                f"writer's, decode restores the source")
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in counters}
        log(f"phase 4: launches during the main path: {launches}")
        if not all(launches.values()):
            fail(f"a kernel of the main path never launched: {launches}")

        # -- phase 5: rates --------------------------------------------------
        src = os.path.join(work, "textlike.bin")
        size = os.path.getsize(src)
        best = {"port compress": [], "port decompress": [],
                "host compress": [], "host decompress": []}
        for _ in range(3):
            t0 = time.perf_counter()
            read_compress_write_hf2(src, src + ".p", device=dev)
            t1 = time.perf_counter()
            read_decompress_write_hf2(src + ".p", src + ".po", device=dev)
            t2 = time.perf_counter()
            host_stream.read_compress_write_hf2(src, src + ".h", device=False,
                                                block_len=LANE, max_code_len=32)
            t3 = time.perf_counter()
            host_stream.read_decompress_write_hf2(src + ".h", src + ".ho")
            t4 = time.perf_counter()
            for key, dt in zip(best, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                best[key].append(dt)
        a = torch.empty(size, dtype=torch.uint8, device=dev)
        b = torch.empty_like(a)
        copy_ms = cuda_ms(torch, lambda: b.copy_(a), reps=20)
        for key, dts in best.items():
            log(f"phase 5: {key}: {size / min(dts) / 1e9:.4f} GB/s wall, "
                f"best of {len(dts)} on {size} B [{card}]")
        log(f"phase 5: device-to-device copy_: {size / copy_ms / 1e6:.2f} GB/s "
            f"({copy_ms:.4f} ms for {size} B) [{card}]")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    if "jax" in sys.modules:
        fail("jax was imported")
    sources = {"encode": ("tpuhuff_torch/csrc/encode.cu",
                          "tpuhuff/kernels/pallas_encode2.py:210", encode_blocks),
               "decode": ("tpuhuff_torch/csrc/decode.cu",
                          "tpuhuff/kernels/pallas_decode.py:227", decode_rows),
               "histogram": ("tpuhuff_torch/csrc/histogram.cu",
                             "tpuhuff/kernels/pallas_histogram.py:139", histogram)}
    kernels = [{"name": k, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[fn.__name__], "max_abs_err": errs[k],
                "ms": timing[k][0], "plain_ms": timing[k][1]}
               for k, (src, rep, fn) in sources.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
