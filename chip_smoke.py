#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``tpuhuff_torch``) on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA card, the CUDA
toolkit (``nvcc``), ``g++`` and PyTorch built for CUDA:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. environment: the card's name and power limit, torch and CUDA versions;
2. build of the CUDA kernels from ``tpuhuff_torch/csrc`` (one ``nvcc``
   per source, side by side) and of the port's C++ host runtime
   (``cpp/huffc.cpp`` with ``g++``);
3. each kernel against its plain PyTorch version on the card, bit-exact:
   encode (K1), encode + histogram (K5, ``hist_data`` the lanes or a
   distinct operand 3 bytes past a 16-byte boundary) and canonical decode
   (K2) on textlike, uniform-random, single-symbol and Fibonacci (32-bit
   code) inputs with ragged lanes and missing letters; K5 also on an
   odd-length prefix of the lanes' storage (counted from the bytes the
   encode holds) and on a view of the lanes one byte in (read apart); K1
   and K5 with the allocator's blocks of the words' size filled with 0xFF
   first (every word must be written); K1 at lanes of 8, 4 and 2 bytes
   (the shapes of the TPU's flat-layout kernel, K6) and K1 and K5 at lanes
   of 8, 32 and 1024 bytes under the Fibonacci tree; general-tree
   decode (K4) with non-canonical trees on textlike at the main path's
   shape, 4 MiB uniform random, a 2-letter alphabet, the Fibonacci file
   (32-bit codes) and blocks cut short; K2 and K4 on rows of random words
   that are not codes, and on host-written ``.hf2`` payloads at
   ``block_len`` 1000 and 2048; K4 on a tree of two leaves (one-bit
   codes), either way round; K2 and K4 on rows of 60,000 random words,
   too wide for shared memory (their global-rows route: one thread block
   per Huffman block, split into self-synchronising subsequences), and on
   16 blocks of 65536 codes of 25-32 bits (the shape of a phase-7b launch
   on that route, timed there, also alone); histograms (K3) from 1 B to
   100 MiB of each of ``HIST_KINDS`` (textlike, uniform random, runs of
   0x00 and of 0xff, geometric) at three starts, and added into running
   counts (``out=``) over 15 MiB pieces; K3 timed on 64 MiB of each kind
   (card, alone, the wrapper's host time per call, ``torch.bincount``, the
   bound) beside its launch's grid; the device stitch (S1) on K1's
   output of the textlike, uniform-random, single-symbol and Fibonacci
   inputs with ragged and empty lanes behind every carry of 0-7 bits, a
   chunk of fewer than 8 bits, the host C++ stitch's bytes, and the main
   chunk as one stitch and as a chain of 5 chunks through the carry left on
   the card; the device row gather (S2) on that payload (the host gather's
   rows), one byte off its alignment, and random blocks over payloads of
   1 B to 1 MiB (their ends read as 0); both timed beside K1 (card, alone,
   the wrapper's host time per call, plain; S2 also the PyTorch index
   gather with its byteswap).  The decoders' first-level table size k, rows per thread block n and
   the share of the main input's symbols that escape the table; kernel,
   plain and library-call times at the main path's shapes, and K1 and K5 at
   lanes of 8 bytes; for every kernel also a second reading, the device's
   time alone (the runs enqueued behind a spin on the device) beside the
   wrapper's host time per call;
4. the main paths, ``tpuhuff_torch.io`` on the device, each run with every
   launch count set to 0 just before it and read just after:
   (a) canonical containers of 100 MiB of textlike data (seed 42), a
   16 MiB uniform-random file and the ~15 MB Fibonacci file: K1, K2, K3,
   K3 exactly once per piece of pass 1, K1 and S1 once per pass-2 chunk,
   S2 and K2 once per decode group, and no host stitch, shifting sink
   write, lane padding or host row gather called on the card's path
   (there, and in (b)-(d), each such call fails the run); then the textlike file in 16 MiB
   chunks under ``torch.profiler`` in a child process, whose trace must
   show pass 1 as one
   ``hist256_kernel`` per piece, at most the fill of its counts, and no
   add;
   (b) ``canonical=False`` containers of the textlike and Fibonacci files,
   and of the Fibonacci file under a non-canonical 32-bit tree: K4 and no
   K2 where the tree is not canonical.  Each container must have the
   SHA-256 of the port's host C++ writer's (``block_len=256,
   max_code_len=32``), and each device decode must restore the source;
   (c) config 4, a dataset of 6 drifting 100 MiB textlike shards: shared
   mode (one tree; K1, K2, no K5, no K3), adaptive mode (a tree per shard
   from the previous shard's histogram, counted by K5), and ``.hff``
   shards; every container SHA-equal to the host writer's under the same
   tree, every shard restored, adaptive ratio below the stale tree's;
   (d) a 16 MiB uniform-random ``.hf2`` with ``block_len=1000`` (8-byte
   lanes, the TPU's K6 route), SHA-equal to the host writer and restored;
   (e) the first 64 MiB of the textlike file as 262,144 lanes of 256 B on
   the card, under (a)'s canonical tree and under a tree without the
   chunk's three rarest letters: ``kernels.block_bit_lengths`` equal to
   K1's ``bits`` lane by lane, to its result on CPU tensors and, as
   uint32, to its result on the tree's uint8 LUT,
   ``kernels.count_missing`` equal to K1's summed ``miss``, to its result
   on CPU tensors and to the count the histogram gives (0, then > 0), and
   ``kernels.words_to_payload`` of 16 of K1's lanes equal to each lane's
   stitched bytes and to the host encoder's; both timed beside K1;
   (f) the textlike file at config 2's 64 KiB blocks and at 1 MiB blocks,
   written by the host writer (K2) and by the ``.hff`` to ``.hf2``
   transcode (K4: its tree is not canonical), each decoded on the card by
   ``read_decompress_write_hf2`` with every count set to 0 just before
   it: no call handed to the host decoder, no host stage, S2 and the
   decoder once per decode group, every block on the global-rows route,
   exact; then K2 and K4 on S2's rows of the first decode group of each
   64 KiB container (1,024 blocks of ~9,300 words) against their plain
   versions and the source, timed (card, alone, plain, the bound of the
   group's bytes);
5. wall-clock rates of port compress and decompress (canonical and not)
   and of dataset compress (shared and adaptive) beside the host C++
   writers and reader, and a device-to-device copy;
6. the command line on the card, ``tpuhuff_torch.cli.main`` called in this
   process (each call's counts set to 0 just before it and read just
   after), each call's wall seconds and rate printed: ``--hf2 --device``
   compress and decompress of the 100 MiB textlike file (K3, K1, K2, no
   K4; SHA-equal to the host writer's); its ``.hff`` (K1), whose first
   decode writes the ``.hf2x`` sidecar (byte-equal to
   ``transcode_hff_to_hf2``) and whose second reuses it, and
   ``--no-auto-index``; ``--reindex --hf2-block 256`` of that ``.hff``
   decoded with ``-d --hf2 --device`` (K4, no K2); ``--dataset --adaptive
   --device`` on three 8 MiB shards (K5), each shard decoded back;
   ``--warmup``; and ``--profile DIR``, whose trace must hold a CUDA kernel
   event of a port kernel;
7. the last modules (each run counted from 0 as in phase 4): (a) config 3,
   a 1 GiB mixed binary corpus (a third textlike, a third uniform random,
   a third geometric), through ``dist.compress_sharded`` at 64 KiB blocks
   on ``make_mesh()`` (the card) and on ``[cuda:0] * 4``: each container
   equal to the host codec's (``tpuhuff_torch.compress``), each
   ``decompress`` exact, K3 and K1 once per shard, walls and rates beside
   the host codec's; (b) ``dist.sharded_decode_blocks`` on the 4-entry
   mesh: the corpus's stream cut into blocks of 4096 and 65536 bytes under
   its own (non-canonical) tree, K4 alone, and under the canonical tree,
   K2 alone, all exact (the corpus's codes stop at about 10 bits: one
   tree over a uniform random third has none past 14); then 64 blocks of
   65536 codes of 15-24 bits each way (every code past the first-level
   table; rows that the staged route fits fewer than 32 to a thread block,
   so the global-rows route of K2 and K4) and 64 of 25-32 bits, whose rows
   are too wide for shared memory (the global-rows route), exact, and
   ``decode_tile_rows`` at 4096 and 65536 bytes for 8-, 14- and 32-bit
   codes; (c) config 5 on one card: two processes in a gloo group, both on
   cuda:0, each with a timeout, run ``dist.multihost.compress_file_multihost``
   (64 MiB super-chunks) and ``decompress_file_multihost`` on 256 MiB +
   12,345 B of textlike data at ``block_len`` 65536 (decoded on the host)
   and 1024 (K2 in each process); every ``.hf2`` SHA-equal to the
   single-process device writer's, every round trip exact, each child's
   launch counts printed on a line of its own.

Every phase's launch counts include S1 and S2 (``kernels.stitch_lanes``,
``kernels.lane_rows``): one S1 for each K1 or K5 launch of a device writer,
one S2 for each decoder launch of the device reader.

The line before the last is ``{"kernels": [...]}`` (the five kernels, the
decoders' two global-rows routes as phase 4f measures them, ``stitch`` and
``lane_rows``); the last line is
``{"ok": true, "device": {...}}``.  Nothing of JAX, and nothing of the JAX
package, is imported.
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
SHARD_MB = 100         # config 4: 10 GB of shards cut to 6 x 100 MiB
N_SHARDS = 6
LANE = 256             # the device writer's default block_len
CONFIG3_MB = 1024      # config 3: a 1 GB mixed binary corpus
MULTI_MB = 256         # config 5 on one card: the file of two processes
HBM_BYTES_PER_MS = 3.35e9  # H100 SXM: 3.35 TB/s (NVIDIA's data sheet)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def make_textlike(n: int, np, seed: int = 42):
    """Config 2's enwik-like bytes (the recipe of bench.py's make_textlike)."""
    rng = np.random.default_rng(seed)
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


def make_shard(k: int, np):
    """Config 4's shard k: textlike bytes (seed 42 + k) of which a random
    k / N_SHARDS share is moved by 128 (mod 256).  Neighbouring shards are
    alike and distant ones are not: the drift adaptive mode exists for."""
    data = make_textlike(SHARD_MB << 20, np, seed=42 + k)
    moved = np.random.default_rng(1000 + k).integers(
        0, N_SHARDS, data.size, dtype=np.uint8) < k
    data[moved] += np.uint8(128)
    return data


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


def spin_ms(torch, fn, reps: int = 5) -> tuple[float, float]:
    """``cuda_ms`` with the runs enqueued behind a spin on the device that
    outlasts the host's time to enqueue them (twice the first run's, at
    2 GHz): the device's time alone, where the host's time per call (a
    wrapper's checks, allocations and launch) is shorter than it.  Returns
    (device ms per run, host ms per call while enqueueing)."""
    t0 = time.perf_counter()
    fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * reps * host * 2e9) + 1_000_000)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / reps
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, host


def max_err(torch, got, want) -> int:
    if got.shape != want.shape:
        fail(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    if got.numel() == 0:
        return 0
    return int((got.long() - want.long()).abs().max())


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def payload_bytes(bit0, nbits) -> int:
    """Bytes of the row words a decoder must read: the words that hold each
    block's bits, from ``bit0`` to ``bit0 + nbits``."""
    return int(((bit0.long() + nbits.long() + 31) // 32).sum()) * 4


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


# the port's kernel names, as a device trace shows them
KERNEL_NAMES = ("encode_tiles", "decode_rows_kernel",
                "decode_rows_general_kernel", "hist256_kernel",
                "stitch_kernel", "lane_rows_kernel")


def phase6_cli(work: str, dev, card: str, reset, read, np) -> None:
    """Phase 6: the command line on the card, called in this process so
    that the launch counters can be read; every step fails the run on a
    wrong byte or a wrong launch count."""
    import contextlib
    import io

    from tpuhuff_torch.cli import main as cli
    from tpuhuff_torch.core.tree import HuffTree
    from tpuhuff_torch.io import read_compress_write, transcode_hff_to_hf2
    from tpuhuff_torch.io.host import (
        AUTO_INDEX_MIN,
        _read_hff_header,
        read_compress_write_hf2_host,
    )
    from tpuhuff_torch.kernels import decode_rows, decoder_for
    from tpuhuff_torch.profiling import TRACE_FILE

    def run(label, argv, nbytes):
        """One call, counted from 0: exit 0, its standard output, its wall
        seconds and rate logged.  Returns (output, launches)."""
        out = io.StringIO()
        reset()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli(argv)
        dt = time.perf_counter() - t0
        counts = read()
        text = out.getvalue()
        if rc != 0:
            fail(f"6 {label}: exit {rc}; output: {text!r}")
        log(f"phase 6: {label}: {dt:.4f} s wall, {nbytes / dt / 1e9:.4f} "
            f"GB/s on {nbytes} B, launches {counts} [{card}]")
        for line in text.splitlines():
            log(f"phase 6:   | {line}")
        return text, counts

    def restores(path, src, label):
        if not same_file(path, src):
            fail(f"6 {label}: {path} does not restore {src}")

    d = os.path.join(work, "cli")
    os.makedirs(d)
    src = os.path.join(work, "textlike.bin")
    size = os.path.getsize(src)

    # (a) the .hf2 round trip: K3, K1 and K2; no K4
    t = os.path.join(d, "t")
    _, c1 = run("--hf2 --device -n --stats (compress)",
                ["--hf2", "--device", "-n", "--stats", src, t], size)
    _, c2 = run("-d --hf2 --device (decompress)",
                ["-d", "--hf2", "--device", "-n", t + ".hf2", t + ".out"], size)
    read_compress_write_hf2_host(src, t + ".ref", block_len=LANE,
                                 max_code_len=32)
    if sha(t + ".hf2") != sha(t + ".ref"):
        fail("6a: the CLI's container differs from the host writer's")
    restores(t + ".out", src, "6a")
    if not (c1["histogram"] and c1["encode"] and c1["stitch"] and c2["decode"]
            and c2["lane_rows"]) or (c1["decode_general"]
                                     or c2["decode_general"]):
        fail(f"6a: wrong kernels: compress {c1}, decompress {c2}")
    log("phase 6a: container sha256 == host writer's, round trip exact")

    # (b) the .hff path: K1, then the sidecar created and reused
    x = os.path.join(d, "x")
    hff = x + ".hff"
    _, c = run("--device -n (.hff compress)", ["--device", "-n", src, x], size)
    if not c["encode"] or c["stitch"] != c["encode"]:
        fail(f"6b: K1 and S1 did not launch alike: {c}")
    with open(hff, "rb") as fp:
        tree, _, header_len = _read_hff_header(fp, hff)
    payload = os.path.getsize(hff) - header_len
    if payload < AUTO_INDEX_MIN:
        fail(f"6b: a payload of {payload} B is under AUTO_INDEX_MIN")
    text, _ = run("-d (.hff, first)", ["-d", "-n", hff, x + ".o1"], size)
    sidecar = hff + ".hf2x"
    if "indexed" not in text or not os.path.exists(sidecar):
        fail("6b: the first decode did not write the sidecar")
    transcode_hff_to_hf2(hff, x + ".t.hf2", block_len=65536)
    if not same_file(sidecar, x + ".t.hf2"):
        fail("6b: the sidecar differs from transcode_hff_to_hf2's container")
    text, _ = run("-d (.hff, second)", ["-d", "-n", hff, x + ".o2"], size)
    if "using block-index sidecar" not in text:
        fail("6b: the second decode did not reuse the sidecar")
    os.remove(sidecar)
    run("-d --no-auto-index (.hff)",
        ["-d", "-n", "--no-auto-index", hff, x + ".o3"], size)
    if os.path.exists(sidecar):
        fail("6b: --no-auto-index wrote a sidecar")
    for k in (1, 2, 3):
        restores(f"{x}.o{k}", src, "6b")
    log(f"phase 6b: .hff payload {payload} B >= AUTO_INDEX_MIN "
        f"{AUTO_INDEX_MIN}; sidecar created (== transcode_hff_to_hf2's), "
        "then reused; --no-auto-index wrote none; every decode exact")

    # (c) the .hff re-indexed into 256-byte blocks: K4, no K2
    if decoder_for(tree)[0] is decode_rows:
        log("phase 6c: the .hff writer's tree of this input is canonical; "
            "the .hff is written again under its mirror")
        hff = x + ".mirror.hff"
        read_compress_write(src, hff, device=dev, tree=HuffTree(
            tree.right, tree.left, tree.letters, tree.weights, tree.root))
    y = os.path.join(d, "y")
    run("--reindex --hf2-block 256",
        ["--reindex", "-n", "--hf2-block", "256", hff, y + ".hf2"], size)
    _, c = run("-d --hf2 --device (reindexed)",
               ["-d", "--hf2", "--device", "-n", y + ".hf2", y + ".out"], size)
    if not c["decode_general"] or c["decode"]:
        fail(f"6c: the reindexed container did not decode with K4 alone: {c}")
    restores(y + ".out", src, "6c")
    log("phase 6c: reindexed .hf2 decoded by K4 alone, exact")

    # (d) an adaptive dataset of three small shards: K5
    shards = []
    for k in range(3):
        path = os.path.join(d, f"shard{k}.bin")
        make_textlike(8 << 20, np, seed=100 + k).tofile(path)
        shards.append(path)
    out_dir = os.path.join(d, "ds")
    _, c = run("--dataset --adaptive --device",
               ["--dataset", *shards, "--adaptive", "--device", "--out-dir",
                out_dir, "-n", "--stats"],
               sum(os.path.getsize(p) for p in shards))
    if not c["encode_hist"]:
        fail(f"6d: K5 never launched: {c}")
    for path in shards:
        hf2 = os.path.join(out_dir, os.path.basename(path) + ".hf2")
        run("-d --hf2 --device (shard)",
            ["-d", "--hf2", "--device", "-n", hf2, path + ".out"],
            os.path.getsize(path))
        restores(path + ".out", path, "6d")
    log("phase 6d: every shard restored")

    # (e) --warmup, and (f) a trace that names a port kernel
    run("--warmup", ["--warmup"], 1 << 20)
    rand = os.path.join(work, "random.bin")
    trace_dir = os.path.join(d, "trace")
    run("--profile DIR --hf2 --device",
        ["--profile", trace_dir, "--hf2", "--device", "-n", rand,
         os.path.join(d, "r")], os.path.getsize(rand))
    with open(os.path.join(trace_dir, TRACE_FILE)) as fp:
        events = json.load(fp)["traceEvents"]
    kernels = sorted({e.get("name", "") for e in events
                      if e.get("cat") == "kernel"})
    ours = [n for n in kernels if any(k in n for k in KERNEL_NAMES)]
    if not ours:
        fail(f"6f: no port kernel in the trace's CUDA kernel events: "
             f"{kernels[:10]}")
    log(f"phase 6f: the trace holds {len(kernels)} CUDA kernel names, of "
        f"which the port's: {ours}")
    shutil.rmtree(d)


def phase3_host_stages(dev, card: str, np, torch, cases: dict, tree_of,
                       errs: dict) -> tuple[dict, dict]:
    """Phase 3 for the kernels that took the host stages onto the card:
    the stitch S1 and the row gather S2, each against its plain version on
    the card, bit-exact, then timed at the main path's shapes beside K1.
    ``cases`` maps a name to ``(data, tree or None)`` (phase 3's inputs);
    the errors go into ``errs["stitch"]`` and ``errs["lane_rows"]``.
    Returns ``(timing, moved)``: per kernel (card ms, plain ms, library ms
    or None), and the bytes of its bound."""
    from tpuhuff_torch.dist import stitch_words
    from tpuhuff_torch.kernels import (
        _build,
        encode_blocks,
        lane_rows,
        lane_rows_reference,
        make_encode_tables,
        new_carry,
        payload_to_lane_words,
        stitch_lanes,
        stitch_lanes_reference,
    )

    rng = np.random.default_rng(14)

    def k1(data, tree, valid=None):
        """K1 over ``data`` as LANE-byte lanes: (lanes, valid, etab, words,
        bits)."""
        etab = make_encode_tables(*tree.encode_tables()).to(dev)
        B = data.size // LANE
        lanes = torch.from_numpy(data[: B * LANE].reshape(B, LANE)).to(dev)
        if valid is None:
            valid = torch.full((B,), LANE, dtype=torch.int32, device=dev)
        words, bits, _ = encode_blocks(lanes, valid, etab)
        return lanes, valid, etab, words, bits

    def carry_of(n):
        byte = int(rng.integers(0, 256))  # the bits past n must be ignored
        return torch.tensor([byte, n], dtype=torch.int32, device=dev)

    def check_s1(name, words, bits, carry):
        got = stitch_lanes(words, bits, carry)
        want = stitch_lanes_reference(words, bits, carry)
        torch.cuda.synchronize()
        err = max(max_err(torch, g, w) for g, w in zip(got, want))
        errs["stitch"] = max(errs["stitch"], err)
        return got, err

    # K1's output of each input, ragged lanes and lanes of no bits, behind
    # every carry of 0-7 bits
    for name in ("textlike", "random", "single", "fib"):
        data, tree = cases[name]
        tree = tree if tree is not None else tree_of(data)
        B = data.size // LANE
        valid = torch.from_numpy(rng.integers(0, LANE + 1, B).astype(
            np.int32)).to(dev)
        valid[::9] = 0
        valid[1::9] = LANE
        _, _, etab, words, bits = k1(data, tree, valid)
        err = max(check_s1(name, words, bits, carry_of(n))[1]
                  for n in range(8))
        if name == "textlike":  # the host C++ stitch of the same lanes
            (payload, _), _ = check_s1(name, words, bits, new_carry(dev))
            want, _ = stitch_words(words.cpu().numpy().view(np.uint32),
                                   bits.cpu().numpy().astype(np.uint64))
            if payload[: len(want)].cpu().numpy().tobytes() != want:
                fail("stitch: the textlike payload differs from the host "
                     "stitch's")
        log(f"phase 3: stitch {name}: {B} lanes (ragged, every 9th empty), "
            f"max code {etab.max_len} bits, carries 0-7: err {err}")
    # a chunk of fewer than 8 bits: one byte of a short code
    text, _ = cases["textlike"]
    one = torch.ones(1, dtype=torch.int32, device=dev)
    _, _, _, w1, b1 = k1(text[:LANE], tree_of(text), one)
    for n in range(8):
        (_, out), err = check_s1("short", w1, b1, carry_of(n))
        if int(b1[0]) >= 8 or int(out[1]) != (n + int(b1[0])) % 8:
            fail(f"stitch: a chunk of {int(b1[0])} bits behind {n}: {out}")
    log(f"phase 3: stitch of a chunk of {int(b1[0])} bits behind carries "
        f"0-7: err {errs['stitch']}")
    # the main path's chunk, full lanes, and the same lanes as a chain of
    # 5 chunks (one empty) through the carry left on the card
    lanes, valid, etab, words, bits = k1(text, tree_of(text))
    B = words.shape[0]
    whole, _ = check_s1("main", words, bits, new_carry(dev))
    total = int(bits.sum())
    cuts = [0, 1000, 1000, 99_999, 200_000, B]
    carry, chain, carried = new_carry(dev), [], 0
    for lo, hi in zip(cuts, cuts[1:]):
        (payload, carry), _ = check_s1("chain", words[lo:hi], bits[lo:hi],
                                       carry)
        got = carried + int(bits[lo:hi].sum())
        chain.append(payload[: got // 8].cpu())
        carried = got % 8
    if carried:
        chain.append(carry[:1].cpu().to(torch.uint8))
    if not torch.equal(torch.cat(chain), whole[0][: (total + 7) // 8].cpu()):
        fail("stitch: the chain of 5 chunks differs from one stitch")
    log(f"phase 3: stitch of {B} lanes as one chunk == as a chain of 5 "
        f"(cuts {cuts[1:-1]}): {total} bits, err {errs['stitch']}")

    # S2: the main chunk's payload cut into its blocks' rows (unaligned
    # starts, the last block at the payload's end), the same payload one
    # byte off its alignment, and random blocks over payloads of every
    # length mod 4
    pay_bytes = (total + 7) // 8
    pay = whole[0][:pay_bytes]
    ends = np.cumsum(bits.cpu().numpy().astype(np.int64))
    starts = ends - bits.cpu().numpy()

    def check_s2(name, payload, starts, ends):
        got = lane_rows(payload, starts, ends)
        want = lane_rows_reference(payload, starts, ends)
        torch.cuda.synchronize()
        err = max(max_err(torch, g, w) for g, w in zip(got, want))
        errs["lane_rows"] = max(errs["lane_rows"], err)
        return got, err

    (rows, bit0), err = check_s2("main", pay, starts, ends)
    host_rows, host_bit0 = payload_to_lane_words(pay.cpu().numpy(), starts,
                                                 ends, LANE)
    if not (np.array_equal(rows.cpu().numpy().view(np.uint32), host_rows)
            and np.array_equal(bit0.cpu().numpy(), host_bit0)):
        fail("lane_rows: the main chunk's rows differ from the host gather's")
    store = torch.zeros(pay_bytes + 1, dtype=torch.uint8, device=dev)
    store[1:] = pay
    _, err1 = check_s2("unaligned", store[1:], starts, ends)
    for n in (1, 2, 3, 4, 4097, 4098, 4099, 1 << 20):
        payload = torch.from_numpy(rng.integers(0, 256, n, dtype=np.uint8)
                                   ).to(dev)
        cut = np.sort(rng.integers(0, 8 * n - int(rng.integers(0, 8)) + 1,
                                   max(2, n // 40)))
        check_s2(f"{n} B", payload, cut[:-1], cut[1:])
    log(f"phase 3: lane_rows of the main chunk ({B} blocks, {pay_bytes} B, "
        f"rows of {rows.shape[1]} words) == the host gather's; err {err}, "
        f"one byte off {err1}, random blocks over 1 B .. 1 MiB: "
        f"{errs['lane_rows']}")

    # timing at the main path's shapes, beside K1 on the same lanes
    c0 = new_carry(dev)
    k1_ms = cuda_ms(torch, lambda: encode_blocks(lanes, valid, etab))
    live = int(((bits.long() + 31) // 32).sum()) * 4
    moved = {
        # the words that hold bits, the counts, the carry; the payload and
        # the carry out
        "stitch": live + nbytes(bits) + 8 + pay_bytes + 8,
        # the payload and the start bits; the rows and bit0
        "lane_rows": pay.numel() + 8 * B + nbytes(rows, bit0),
    }
    W = rows.shape[1]
    idx = torch.from_numpy(starts // 32).to(dev)[:, None] + torch.arange(
        W, device=dev)[None, :]
    padded = torch.zeros(4 * (int(idx.max()) + 1), dtype=torch.uint8,
                         device=dev)
    padded[:pay_bytes] = pay
    words_le = padded.view(torch.int32)

    def library_rows():
        """The PyTorch index gather of the rows, then their byteswap."""
        return words_le[idx].view(torch.uint8).view(B, W, 4).flip(-1)

    if not torch.equal(library_rows().contiguous().view(torch.int32).view(
            B, W), rows):
        fail("lane_rows: the library gather's rows differ from the kernel's")
    timing = {
        "stitch": (cuda_ms(torch, lambda: stitch_lanes(words, bits, c0)),
                   cuda_ms(torch, lambda: stitch_lanes_reference(
                       words, bits, c0), reps=2), None),
        "lane_rows": (cuda_ms(torch, lambda: lane_rows(pay, starts, ends)),
                      cuda_ms(torch, lambda: lane_rows_reference(
                          pay, starts, ends), reps=2),
                      cuda_ms(torch, library_rows)),
    }
    # S2's wrapper waits for its previous call's copy of the start bits
    # (a pinned buffer it keeps), so behind a device spin it would wait for
    # the spin: its device time alone is read from its C entry, the start
    # bits already on the card, and its host time per call from the
    # wrapper called back to back
    d_starts = torch.from_numpy(starts).to(dev)
    r_out, b_out = torch.empty_like(rows), torch.empty_like(bit0)

    def rows_entry():
        _build.launch("tpuhuff_lane_rows", dev, pay.data_ptr(), pay.numel(),
                      d_starts.data_ptr(), r_out.data_ptr(), b_out.data_ptr(),
                      B, W)

    rows_entry()
    torch.cuda.synchronize()
    if not (torch.equal(r_out, rows) and torch.equal(b_out, bit0)):
        fail("lane_rows: its C entry differs from the wrapper")
    t0 = time.perf_counter()
    for _ in range(5):
        lane_rows(pay, starts, ends)
    rows_host = (time.perf_counter() - t0) * 1e3 / 5
    torch.cuda.synchronize()
    alone = {"stitch": spin_ms(torch, lambda: stitch_lanes(words, bits, c0)),
             "lane_rows": (spin_ms(torch, rows_entry)[0], rows_host)}
    for k, (ms, plain_ms, lib_ms) in timing.items():
        log(f"phase 3: {k} at the main path's shapes: kernel {ms:.4f} ms, "
            f"alone {alone[k][0]:.4f} ms, the wrapper's host time per call "
            f"{alone[k][1]:.4f} ms, plain {plain_ms:.4f} ms, library "
            f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
            f"{moved[k] / HBM_BYTES_PER_MS:.4f} ms ({moved[k]} B at 3.35 "
            f"TB/s); K1 on the same lanes {k1_ms:.4f} ms [{card}]")
    return timing, moved


def pass2_chunks(src: str, block_len: int = LANE) -> int:
    """The chunks pass 2 of the ``.hf2`` device writer encodes ``src`` in
    (default chunk, CRC column on): one K1 and one S1 launch each."""
    from tpuhuff_torch.io.host import _chunk_step

    step = _chunk_step(block_len, None, True)[0]
    return -(-os.path.getsize(src) // step)


def decode_groups(src: str, block_len: int = LANE) -> int:
    """The groups the device reader decodes ``src``'s ``.hf2`` in (default
    chunk): one S2 and one decoder launch each."""
    from tpuhuff_torch.io.host import _CHUNK
    from tpuhuff_torch.io.stream import _group_blocks

    blocks = -(-os.path.getsize(src) // block_len)
    return -(-blocks // _group_blocks(block_len, _CHUNK))


class host_stages_forbidden:
    """While active, the host stages that the card's path no longer runs
    fail the run if anything calls them: the host stitch
    (``dist.stitch_words``, ``native.stitch_blocks``), the shifting sink
    write (``_BitSink.write``), the lane padding (``pad_to_blocks``) and
    the host row gather (``payload_to_lane_words``, ``native.extract_rows``)."""

    def __enter__(self):
        import tpuhuff_torch.dist as dist
        import tpuhuff_torch.dist.block as block
        import tpuhuff_torch.kernels as kernels
        import tpuhuff_torch.kernels.decode as decode
        from tpuhuff_torch import native
        from tpuhuff_torch.io import host

        self.saved = []
        for owner, name in ((dist, "stitch_words"), (native, "stitch_blocks"),
                            (host._BitSink, "write"), (dist, "pad_to_blocks"),
                            (block, "pad_to_blocks"),
                            (kernels, "payload_to_lane_words"),
                            (decode, "payload_to_lane_words"),
                            (native, "extract_rows")):
            self.saved.append((owner, name, getattr(owner, name)))

            def forbidden(*args, _name=name, **kw):
                fail(f"the card's path called the host stage {_name}")

            setattr(owner, name, forbidden)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self.saved:
            setattr(owner, name, fn)


def pass1_pieces(src: str, chunk_bytes: int | None = None,
                 hist_sample: int = 1) -> int:
    """The pieces pass 1 of the ``.hf2`` writer reads ``src`` in: its
    chunks, or with ``hist_sample > 1`` pieces of at most
    ``_PASS1_PIECE``."""
    from tpuhuff_torch.io.host import _PASS1_PIECE, _chunk_step

    piece = _chunk_step(LANE, chunk_bytes, True)[0]
    if hist_sample > 1:
        piece = min(piece, _PASS1_PIECE)
    return -(-os.path.getsize(src) // piece)


def pass1_trace(work: str) -> None:
    """Phase 4a's trace: the textlike file through the ``.hf2`` writer in
    16 MiB chunks under ``torch.profiler``, in a child process of its own
    (a second profiler session in one process loses CUDA events, and phase
    6f holds one).  Pass 1's kernels are those that start before the first
    device-to-host copy (its counts' transfer): one K3 per piece, at most
    the fill that zeroes the counts once, and no add."""
    from tpuhuff_torch.profiling import TRACE_FILE

    src = os.path.join(work, "textlike.bin")
    dst, trace_dir = f"{src}.pass1.hf2", os.path.join(work, "pass1_trace")
    env = dict(os.environ, TPUHUFF_REPO=os.path.dirname(os.path.abspath(__file__)),
               SRC=src, DST=dst, TRACE_DIR=trace_dir)
    env.pop("PYTHONPATH", None)
    try:
        child = subprocess.run([sys.executable, "-c", _PASS1_CHILD], env=env,
                               capture_output=True, text=True, timeout=600)
    except subprocess.TimeoutExpired:
        fail("4a: the traced child timed out")
    if child.returncode != 0:
        fail(f"4a: the traced child exited {child.returncode}:\n"
             f"{child.stdout[-2000:]}{child.stderr[-2000:]}")
    with open(os.path.join(trace_dir, TRACE_FILE)) as fp:
        events = json.load(fp)["traceEvents"]
    shutil.rmtree(trace_dir)
    d2h = [e["ts"] for e in events
           if e.get("cat") == "gpu_memcpy" and "DtoH" in e.get("name", "")]
    if not d2h:
        fail(f"4a: no device-to-host copy in the trace; categories "
             f"{sorted({str(e.get('cat')) for e in events})}")
    names = [e["name"] for e in sorted(events, key=lambda e: e.get("ts", 0))
             if e.get("cat") == "kernel" and e["ts"] < min(d2h)]
    hist = sum("hist256_kernel" in n for n in names)
    others = [n for n in names if "hist256_kernel" not in n]
    pieces = pass1_pieces(src, 16 << 20)
    if hist != pieces or len(others) > 1 or any("Fill" not in n
                                                for n in others):
        fail(f"4a: pass 1's kernels are not one K3 per piece ({pieces}) and "
             f"at most the counts' fill: {names}")
    if sha(dst) != sha(f"{src}.canonical.ref.hf2"):
        fail("4a: the traced container differs from the host writer's")
    os.remove(dst)
    log(f"phase 4a: traced pass 1 in 16 MiB chunks: {hist} hist256_kernel "
        f"for {pieces} pieces, beside them only {[n[:60] for n in others]}; "
        f"the container equals the host writer's")


def phase4e_guards(work: str, dev, card: str, np, torch, mb: int = 64) -> None:
    """``count_missing``, ``block_bit_lengths`` and ``words_to_payload`` at
    the main path's shapes, held against K1 on the same lanes and against
    their own results on CPU tensors."""
    from tpuhuff_torch import native
    from tpuhuff_torch.core.canonical import build_tree_for_device, canonicalize
    from tpuhuff_torch.core.weights import ByteWeights
    from tpuhuff_torch.dist import stitch_words
    from tpuhuff_torch.io.hff import read_hf2_header
    from tpuhuff_torch.kernels import (
        block_bit_lengths,
        count_missing,
        encode_blocks,
        make_encode_tables,
        words_to_payload,
    )
    from tpuhuff_torch.kernels.encode import as_u32

    src = os.path.join(work, "textlike.bin")
    with open(src + ".canonical.hf2", "rb") as fp:
        tree = read_hf2_header(fp).tree  # phase 4a's canonical tree
    n_lanes = (mb << 20) // LANE  # the main path's first 64 MiB chunk
    chunk = np.fromfile(src, dtype=np.uint8, count=n_lanes * LANE)
    lanes_cpu = torch.from_numpy(chunk.reshape(n_lanes, LANE))
    lanes = lanes_cpu.to(dev)
    valid = torch.full((n_lanes,), LANE, dtype=torch.int32, device=dev)
    counts = np.bincount(chunk, minlength=256)
    held = np.flatnonzero(counts)
    gone = held[np.argsort(counts[held], kind="stable")[:3]]
    part = counts.copy()
    part[gone] = 0
    trees = {"full": (tree, 0),
             f"without letters {gone.tolist()}": (
                 canonicalize(build_tree_for_device(ByteWeights(part), 32)[0]),
                 int(counts[gone].sum()))}
    for name, (t, want_miss) in trees.items():
        lens_lut, codes_lut = t.encode_tables()
        etab = make_encode_tables(lens_lut, codes_lut).to(dev)
        words, bits, miss = encode_blocks(lanes, valid, etab)
        got = block_bit_lengths(lanes, etab.lens)
        got_cpu = block_bit_lengths(lanes_cpu, etab.lens.cpu())
        if got.device != lanes.device or got.dtype != got_cpu.dtype:
            fail(f"4e {name}: block_bit_lengths on {got.device}, {got.dtype}")
        if not torch.equal(got.long(), bits.long()):
            fail(f"4e {name}: block_bit_lengths differs from K1's bits")
        if not torch.equal(got.cpu(), got_cpu):
            fail(f"4e {name}: block_bit_lengths differs on CPU tensors")
        # the tree's own uint8 LUT: a uint32 result, as the JAX function's
        got_u = block_bit_lengths(lanes, torch.from_numpy(lens_lut).to(dev))
        if got_u.dtype != torch.uint32 or not torch.equal(
                got_u.view(torch.int32), got):
            fail(f"4e {name}: block_bit_lengths of the uint8 LUT differs")
        n_miss = count_missing(lanes, etab.lens, valid)
        n_miss_cpu = count_missing(lanes_cpu, etab.lens.cpu(), valid.cpu())
        k1_miss = int(miss.sum())
        if not n_miss == n_miss_cpu == k1_miss == want_miss:
            fail(f"4e {name}: count_missing {n_miss} (CPU {n_miss_cpu}), K1 "
                 f"{k1_miss}, histogram {want_miss}")
        log(f"phase 4e: {name} tree: block_bit_lengths == K1's bits on "
            f"{n_lanes} lanes ({int(bits.long().sum())} bits) and == its CPU "
            f"result; count_missing {n_miss} == K1's miss == CPU == histogram")
        if name != "full":
            continue
        host_words, host_bits = as_u32(words), bits.cpu().numpy()
        for k in np.linspace(0, n_lanes - 1, 16).astype(np.int64):
            payload = words_to_payload(words[k], int(bits[k]))
            stitched, _ = stitch_words(host_words[k : k + 1],
                                       host_bits[k : k + 1])
            encoded, _ = native.encode(chunk[k * LANE : (k + 1) * LANE],
                                       lens_lut, codes_lut)
            if not payload == stitched == encoded:
                fail(f"4e: words_to_payload of lane {k} differs")
        log("phase 4e: words_to_payload of 16 lanes == each lane's stitched "
            "bytes == the host encoder's")
        k1_ms = cuda_ms(torch, lambda: encode_blocks(lanes, valid, etab))
        cm_ms = cuda_ms(torch, lambda: count_missing(lanes, etab.lens, valid))
        bb_ms = cuda_ms(torch, lambda: block_bit_lengths(lanes, etab.lens))
        log(f"phase 4e: at {n_lanes} lanes of {LANE} B: count_missing "
            f"{cm_ms:.4f} ms, block_bit_lengths {bb_ms:.4f} ms, K1 {k1_ms:.4f} "
            f"ms (cuda_ms; the lanes read once at 3.35 TB/s: "
            f"{lanes.numel() / HBM_BYTES_PER_MS:.4f} ms) [{card}]")


CONFIG2_BLOCK = 65536  # config 2's published blocks
WIDE_BLOCKS = (CONFIG2_BLOCK, 1 << 20)


def phase4f_wide_blocks(work: str, dev, card: str, reset, read, errs: dict,
                        np, torch) -> tuple[dict, dict]:
    """Phase 4f: the textlike file at config 2's 64 KiB blocks and at 1 MiB
    blocks, written by the host writer (canonical codes: K2) and by the
    ``.hff`` to ``.hf2`` transcode (the ``.hff`` writer's tree, which is
    not canonical: K4), each decoded by ``read_decompress_write_hf2`` on
    the card with every count set to 0 just before it.  No call reaches
    the host decoder (no ``host_route_bytes``), no host stage runs, S2 and
    the decoder launch once per decode group, every block takes the
    global-rows route (``global_blocks``, the tracer's
    ``global_rows_blocks``), and the output restores the source.  Then, on
    the first decode group of each 64 KiB container (S2's rows of 1,024
    blocks on the card), the decoder against its plain version, and timed:
    kernel, alone, plain, and the bound of the group's payload words,
    block bit counts, tables and output.  Returns the 64 KiB calls'
    global-rows launches and those timings, for the kernels line, keyed
    ``decode_global_rows`` and ``decode_general_global_rows``."""
    from tpuhuff_torch.io import read_decompress_write_hf2, stream
    from tpuhuff_torch.io import transcode_hff_to_hf2
    from tpuhuff_torch.io.hff import read_hf2_header
    from tpuhuff_torch.io.host import (
        _CHUNK,
        read_compress_write_hf2_host,
        read_compress_write_host,
    )
    from tpuhuff_torch.kernels import (
        decode_rows,
        decode_rows_general,
        decode_rows_general_reference,
        decode_rows_reference,
        decode_tile_rows,
        decoder_for,
        lane_rows,
    )
    from tpuhuff_torch.profiling import StageTimer, tracing

    wrappers = {"decode": decode_rows, "decode_general": decode_rows_general}
    plain = {"decode": decode_rows_reference,
             "decode_general": decode_rows_general_reference}
    attrs = ("blocks", "global_blocks")
    launches, timing = {}, {}

    def group_check(key, hdr, hf2, src_data):
        """The decoder on S2's rows of the first decode group of ``hf2``,
        against its plain version and the source; timed."""
        glob = f"{key}_global_rows"
        g1 = min(stream._group_blocks(hdr.block_len, _CHUNK), hdr.num_blocks)
        ends = hdr.end_bits.astype(np.int64)[:g1]
        starts = np.concatenate([[0], ends[:-1]])
        with open(hf2, "rb") as fp:
            fp.seek(hdr.payload_offset)
            payload = np.frombuffer(fp.read((int(ends[-1]) + 7) // 8),
                                    dtype=np.uint8)
        rows, b0 = lane_rows(torch.from_numpy(payload.copy()).to(dev),
                             starts, ends)
        nb = torch.from_numpy((ends - starts).astype(np.int32)).to(dev)
        tab = decoder_for(hdr.tree)[1].to(dev)
        fn = wrappers[key]

        def run():
            return fn(rows, b0, nb, tab, hdr.block_len)

        tile = decode_tile_rows(g1, rows.shape[1], hdr.block_len,
                                key == "decode_general", dev)
        out = run()
        ms = cuda_ms(torch, run)
        alone_ms, host_ms = spin_ms(torch, run)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = plain[key](rows, b0, nb, tab, hdr.block_len)
        end.record()
        end.synchronize()
        plain_ms = start.elapsed_time(end)
        err = max_err(torch, out, want)
        errs[glob] = max(errs[glob], err)
        if err or tile:
            fail(f"4f {glob}: err {err} against the plain version, "
                 f"{tile} blocks per thread block (0: the global-rows route)")
        n = g1 * hdr.block_len
        if not np.array_equal(out.reshape(-1).cpu().numpy(), src_data[:n]):
            fail(f"4f {glob}: the group does not restore its source")
        tables = ((tab.ub, tab.dd, tab.perm) if key == "decode"
                  else (tab.thr, tab.sym, tab.len))
        moved = (payload_bytes(b0, nb) + 8 * g1 + nbytes(*tables) + n)
        timing[glob] = (ms, plain_ms, moved / HBM_BYTES_PER_MS)
        log(f"phase 4f: {glob} on the first decode group of the "
            f"{hdr.block_len >> 10} KiB container ({g1} blocks, S2's rows of {rows.shape[1]} words, "
            f"max code {hdr.tree.max_code_len()} bits): kernel {ms:.4f} ms, "
            f"alone {alone_ms:.4f} ms (the wrapper's host time per call "
            f"{host_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
            f"{moved / HBM_BYTES_PER_MS:.4f} ms ({moved} B at 3.35 TB/s), "
            f"err {err} [{card}]")

    src = os.path.join(work, "textlike.bin")
    src_data = np.fromfile(src, dtype=np.uint8)
    hff = src + ".4f.hff"
    read_compress_write_host(src, hff)
    for block_len in WIDE_BLOCKS:
        for writer, key in (("host writer", "decode"),
                            ("transcode", "decode_general")):
            hf2 = f"{src}.4f.{block_len}.{writer.split()[0]}.hf2"
            if writer == "host writer":
                read_compress_write_hf2_host(src, hf2, block_len=block_len)
            else:
                transcode_hff_to_hf2(hff, hf2, block_len=block_len)
            with open(hf2, "rb") as fp:
                hdr = read_hf2_header(fp)
            B = hdr.num_blocks
            groups = -(-B // stream._group_blocks(block_len, _CHUNK))
            label = f"{writer}, block_len {block_len}, {key}"
            if decoder_for(hdr.tree)[0] is not wrappers[key]:
                fail(f"4f {label}: decoder_for picked "
                     f"{decoder_for(hdr.tree)[0].__name__}")
            reset()
            for fn in wrappers.values():
                for a in attrs:
                    setattr(fn, a, 0)
            traced = StageTimer()
            with host_stages_forbidden(), tracing(traced):
                read_decompress_write_hf2(hf2, hf2 + ".out", device=dev)
            c = read()
            c.update({f"{k}.{a}": getattr(fn, a)
                      for k, fn in wrappers.items() for a in attrs})
            rec, = traced.records
            if "host_route_bytes" in rec.counters:
                fail(f"4f {label}: the call went to the host decoder")
            other = "decode_general" if key == "decode" else "decode"
            want = {key: groups, f"{key}_global_rows": groups,
                    f"{key}.blocks": B, f"{key}.global_blocks": B,
                    "lane_rows": groups, other: 0, f"{other}_global_rows": 0,
                    f"{other}.blocks": 0, f"{other}.global_blocks": 0}
            got = {k: c[k] for k in want}
            if got != want or any(c[k] for k in c if k not in want):
                fail(f"4f {label}: launches {c}, want {want} and no other")
            glob = rec.counters.get("global_rows_blocks")
            if glob is None or glob.n != B:
                fail(f"4f {label}: global_rows_blocks "
                     f"{None if glob is None else glob.n}, want {B}")
            if not same_file(hf2 + ".out", src):
                fail(f"4f {label}: the decode does not restore the source")
            log(f"phase 4f: {label}: {B} blocks in {groups} groups, every "
                f"one on the global-rows route, no host decoder, exact; "
                f"launches {c}")
            if block_len == CONFIG2_BLOCK:
                launches[f"{key}_global_rows"] = c[f"{key}_global_rows"]
                group_check(key, hdr, hf2, src_data)
            os.unlink(hf2)
            os.unlink(hf2 + ".out")
    os.unlink(hff)
    return launches, timing


def make_config3(n: int, np, seed: int = 3):
    """Config 3's mixed binary corpus from the seed: a third textlike, a
    third uniform random bytes and a third drawn from a geometric law
    (most bytes small, a long tail of rare ones), made in 64 MiB pieces."""
    rng = np.random.default_rng(seed)
    third = n // 3
    out = np.empty(n, dtype=np.uint8)
    out[:third] = make_textlike(third, np, seed=seed)
    out[third: 2 * third] = rng.integers(0, 256, third, dtype=np.uint8)
    out[2 * third:] = make_geometric(n - 2 * third, np, rng)
    return out


def make_geometric(n: int, np, rng):
    """n bytes of the geometric law P(byte >= k) = 0.98^k, capped at 255,
    drawn by its inverse CDF at 16-bit resolution (so the draws stay
    16-bit), in 64 MiB pieces."""
    u = (np.arange(1 << 16) + 0.5) / (1 << 16)
    lut = np.minimum(np.floor(np.log1p(-u) / np.log1p(-0.02)), 255
                     ).astype(np.uint8)
    out = np.empty(n, dtype=np.uint8)
    for lo in range(0, n, 64 << 20):
        hi = min(lo + (64 << 20), n)
        out[lo:hi] = lut[rng.integers(0, 1 << 16, hi - lo, dtype=np.uint16)]
    return out


# K3's inputs: its time must not depend on them
HIST_KINDS = ("textlike", "uniform", "run of 0x00", "run of 0xff",
              "geometric")


def make_hist_input(kind: str, n: int, np, seed: int = 0):
    """n bytes of one of HIST_KINDS, from the seed."""
    rng = np.random.default_rng(seed)
    if kind == "textlike":
        return make_textlike(n, np, seed=seed)
    if kind == "uniform":
        return rng.integers(0, 256, n, dtype=np.uint8)
    if kind == "geometric":
        return make_geometric(n, np, rng)
    if kind in ("run of 0x00", "run of 0xff"):
        return np.full(n, 0 if kind == "run of 0x00" else 255, dtype=np.uint8)
    raise ValueError(f"unknown input kind {kind!r}")


def wide_code_blocks(np, n_blocks: int, block_len: int = 65536,
                     lengths=(25, 32)) -> dict:
    """Blocks of ``block_len`` letters drawn from the letters of the
    Fibonacci weights' 32-bit tree whose codes are ``lengths[0]`` to
    ``lengths[1]`` bits long: at 25 to 32 bits, rows of ~59,000 words, too
    wide for shared memory; at 15 to 24, rows of ~40,000 words, staged
    there, every code past the first-level table.  ``{"decode": case,
    "decode_general": case}``, case ``(tree, data, rows, bit0, bits)``
    under the canonical tree (K2) and under its mirror (K4)."""
    import tpuhuff_torch
    from tpuhuff_torch.core.canonical import build_tree_for_device, canonicalize
    from tpuhuff_torch.core.tree import HuffTree
    from tpuhuff_torch.core.weights import ByteWeights
    from tpuhuff_torch.kernels import payload_to_lane_words

    fib = [1, 1]
    while len(fib) < 34:
        fib.append(fib[-1] + fib[-2])
    counts = np.zeros(256, dtype=np.int64)
    counts[:34] = fib
    tree = canonicalize(build_tree_for_device(ByteWeights(counts), 32)[0])
    lens = tree.encode_tables()[0]
    rare = np.flatnonzero((lens >= lengths[0]) & (lens <= lengths[1])
                          ).astype(np.uint8)
    data = rare[np.random.default_rng(8).integers(0, rare.size,
                                                  n_blocks * block_len)]
    cases = {}
    for key, t in (("decode", tree),
                   ("decode_general", HuffTree(tree.right, tree.left,
                                               tree.letters, tree.weights,
                                               tree.root))):
        payload = tpuhuff_torch.compress_with_tree(data, t).comp_bytes
        bits = t.encode_tables()[0][data].reshape(n_blocks, block_len).sum(
            axis=1, dtype=np.int64)
        ends = np.cumsum(bits)
        rows, bit0 = payload_to_lane_words(payload, ends - bits, ends, block_len)
        cases[key] = (t, data, rows, bit0, bits.astype(np.int32))
    return cases


def phase7_mesh(dev, card: str, reset, read, np, torch) -> None:
    """Phases 7a and 7b: config 3 on a mesh of the card, and the sharded
    decoders."""
    import tpuhuff_torch
    from tpuhuff_torch.dist import compress_sharded, make_mesh, sharded_decode_blocks
    from tpuhuff_torch.core.canonical import canonicalize
    from tpuhuff_torch.kernels import (
        decode_rows,
        decode_rows_general,
        decode_tile_rows,
        decoder_for,
        make_canonical_decode_tables,
        payload_to_lane_words,
    )

    n = CONFIG3_MB << 20
    t0 = time.perf_counter()
    data = make_config3(n, np)
    log(f"phase 7a: config 3 corpus, {n} B made in "
        f"{time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    host = tpuhuff_torch.compress(data)
    host_s = time.perf_counter() - t0
    want = host.to_bytes()
    tree = host.huff_tree
    log(f"phase 7a: host codec tpuhuff_torch.compress: {host_s:.4f} s wall, "
        f"{n / host_s / 1e9:.4f} GB/s, {n} B -> {len(want)} B, max code "
        f"{tree.max_code_len()} bits [{card}]")
    meshes = {"make_mesh() (the card)": make_mesh(),
              "[cuda:0] * 4": make_mesh([dev] * 4)}
    for name, mesh in meshes.items():
        reset()
        t0 = time.perf_counter()
        got = compress_sharded(data, block_len=65536, mesh=mesh)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = read()
        if got.to_bytes() != want:
            fail(f"7a {name}: compress_sharded differs from the host codec")
        if counts["histogram"] != len(mesh) or counts["encode"] != len(mesh):
            fail(f"7a {name}: K3/K1 not once per shard: {counts}")
        t0 = time.perf_counter()
        back = tpuhuff_torch.decompress(got)
        back_s = time.perf_counter() - t0
        if not np.array_equal(np.frombuffer(back, np.uint8), data):
            fail(f"7a {name}: decompress does not restore the corpus")
        del back
        log(f"phase 7a: compress_sharded on {name}: {dt:.4f} s wall, "
            f"{n / dt / 1e9:.4f} GB/s (host codec {n / host_s / 1e9:.4f}), "
            f"to_bytes() == the host codec's, decompress exact "
            f"({back_s:.4f} s), launches {counts} [{card}]")
    del got

    # 7b: the corpus's stream decoded by blocks on the 4-entry mesh: cut at
    # 4096 and 65536 bytes (a block's bits are its letters' code lengths)
    mesh = meshes["[cuda:0] * 4"]

    per_letter = tree.encode_tables()[0][data]  # the same for the mirror
    block_bits = {L: per_letter.reshape(-1, L).sum(axis=1, dtype=np.int64)
                  for L in (4096, 65536)}  # n is a multiple of both
    del per_letter

    def decode_check(label, payload, block_len, tree, want_fn):
        bits = block_bits[block_len]
        B4 = bits.size  # a multiple of the mesh's 4 entries
        ends = np.cumsum(bits)
        starts = ends - bits
        rows, bit0 = payload_to_lane_words(payload, starts, ends, block_len)
        wrapper = decoder_for(tree)[0]
        if wrapper is not want_fn:
            fail(f"7b {label}: decoder_for picked {wrapper.__name__}")
        tile = decode_tile_rows(B4 // len(mesh), rows.shape[1], block_len,
                                wrapper is decode_rows_general, dev)
        reset()
        t0 = time.perf_counter()
        out = sharded_decode_blocks(rows, bit0, bits.astype(np.int32), tree,
                                    block_len, mesh)
        dt = time.perf_counter() - t0
        counts = read()
        if not np.array_equal(out.reshape(-1)[:n], data):
            fail(f"7b {label}: the decode is not exact")
        other = "decode" if want_fn is decode_rows_general else "decode_general"
        mine = "decode_general" if want_fn is decode_rows_general else "decode"
        if counts[mine] != len(mesh) or counts[other]:
            fail(f"7b {label}: wrong launches {counts}")
        log(f"phase 7b: {label} at block_len {block_len}: {B4} blocks of "
            f"{rows.shape[1]} words, {tile} blocks per thread block "
            f"(0: rows from device memory), exact, {dt:.4f} s wall, launches "
            f"{counts} [{card}]")

    if make_canonical_decode_tables(tree) is not None:
        fail("7b: the host codec's tree of the corpus is canonical")
    ctree = canonicalize(tree)
    cpayload = tpuhuff_torch.compress_with_tree(data, ctree).comp_bytes
    for block_len in (4096, 65536):
        decode_check("K4, the stream of 7a (its own tree, not canonical)",
                     host.comp_bytes, block_len, tree, decode_rows_general)
        decode_check("K2, the corpus under the canonical tree", cpayload,
                     block_len, ctree, decode_rows)
    del host, want, cpayload, data

    # 7b (iii): blocks of 65536 codes of 15 to 24 bits (the corpus's tree
    # has none past 14), every code escaping the first-level table: rows
    # that the staged route would fit one to a thread block, fewer than 32,
    # so they take the global-rows route
    for key, (t, long_, rows, bit0, bits) in wide_code_blocks(
            np, 64, lengths=(15, 24)).items():
        glob = f"{key}_global_rows"
        tile = decode_tile_rows(rows.shape[0] // len(mesh), rows.shape[1],
                                65536, key == "decode_general", dev)
        reset()
        t0 = time.perf_counter()
        got = sharded_decode_blocks(rows, bit0, bits, t, 65536, mesh)
        dt = time.perf_counter() - t0
        c = read()
        if not np.array_equal(got.reshape(-1), long_):
            fail(f"7b {key} on 15-24-bit codes: the decode is not exact")
        if tile != 0 or c[glob] != len(mesh) or c[key] != len(mesh):
            fail(f"7b {key} on 15-24-bit codes: not the global-rows route "
                 f"({tile} blocks per thread block): {c}")
        log(f"phase 7b: {key}: {rows.shape[0]} blocks of 65536 codes of "
            f"15-24 bits, rows of {rows.shape[1]} words, global-rows route, "
            f"exact, {dt:.4f} s wall, launches {c} [{card}]")

    # 7b (iv): blocks of 65536 codes of 25 to 32 bits: rows too wide for
    # shared memory take the decoders' global-rows route
    for key, (t, wide, rows, bit0, bits) in wide_code_blocks(np, 64).items():
        glob = f"{key}_global_rows"
        reset()
        got = sharded_decode_blocks(rows, bit0, bits, t, 65536, mesh)
        c = read()
        if not np.array_equal(got.reshape(-1), wide):
            fail(f"7b {glob}: the decode is not exact")
        if c[glob] != len(mesh) or c[key] != len(mesh):
            fail(f"7b {glob}: the global-rows route did not launch: {c}")
        log(f"phase 7b: {glob}: {rows.shape[0]} blocks of 65536 codes of "
            f"25-32 bits, rows of {rows.shape[1]} words, exact, launches {c} "
            f"[{card}]")
    for L in (4096, 65536):
        for c_bits in (8, 14, 32):
            W = -(-L * c_bits // 32) + 2
            log(f"phase 7b: decode_tile_rows at block_len {L}, {c_bits}-bit "
                f"codes (W {W}): K2 {decode_tile_rows(1 << 14, W, L, False, dev)}"
                f", K4 {decode_tile_rows(1 << 14, W, L, True, dev)} (0: rows "
                "from device memory)")


_PASS1_CHILD = r"""
import os, sys
sys.path.insert(0, os.environ["TPUHUFF_REPO"])
from tpuhuff_torch.io import read_compress_write_hf2
from tpuhuff_torch.profiling import device_trace
with device_trace(os.environ["TRACE_DIR"]):
    read_compress_write_hf2(os.environ["SRC"], os.environ["DST"],
                            device="cuda", chunk_bytes=16 << 20)
"""

_CHILD = r"""
import json, os, sys, time
sys.path.insert(0, os.environ["TPUHUFF_REPO"])
import torch
from tpuhuff_torch.dist import multihost as mh
from tpuhuff_torch.kernels import (decode_rows, decode_rows_general,
                                   encode_blocks, histogram)
mh.initialize()
rank = torch.distributed.get_rank()
fns = {"encode": (encode_blocks, "launches"), "decode": (decode_rows, "launches"),
       "decode_general": (decode_rows_general, "launches"),
       "histogram": (histogram, "launches")}
def counted(fn, *args, **kw):
    for f, a in fns.values():
        setattr(f, a, 0)
    t0 = time.perf_counter()
    fn(*args, **kw)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, {k: getattr(f, a) for k, (f, a) in fns.items()}
src = os.environ["SRC"]
for bl in (65536, 1024):
    dst = f"{src}.{bl}.mh.hf2"
    cs, cc = counted(mh.compress_file_multihost, src, dst, block_len=bl,
                     chunk_bytes=64 << 20)
    ds, dc = counted(mh.decompress_file_multihost, dst, f"{dst}.rt")
    print("CHILD " + json.dumps({"rank": rank, "block_len": bl,
          "device": str(torch.cuda.current_device()),
          "compress_s": cs, "compress": cc, "decompress_s": ds,
          "decompress": dc}), flush=True)
"""


def phase7_multiprocess(work: str, dev, card: str, np) -> None:
    """Phase 7c: config 5 on one card, two processes in a gloo group, each
    launching its own kernels on cuda:0."""
    import socket

    from tpuhuff_torch.io import read_compress_write_hf2

    n = (MULTI_MB << 20) + 12345  # not a multiple of block_len * 2
    src = os.path.join(work, "multi.bin")
    make_textlike(n, np, seed=77).tofile(src)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ, TPUHUFF_REPO=os.path.dirname(os.path.abspath(__file__)),
               TPUHUFF_COORDINATOR=f"127.0.0.1:{port}",
               TPUHUFF_NUM_PROCESSES="2", SRC=src)
    env.pop("PYTHONPATH", None)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD],
                              env=dict(env, TPUHUFF_PROCESS_ID=str(k)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for k in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    except subprocess.TimeoutExpired:
        fail("7c: a child process timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    reports = []
    for k, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            fail(f"7c: child {k} exited {p.returncode}:\n{out[-3000:]}")
        for line in out.splitlines():
            if line.startswith("CHILD "):
                log(f"phase 7c: child {k}: {line[6:]} [{card}]")
                reports.append(json.loads(line[6:]))
    if len(reports) != 4:
        fail(f"7c: expected 4 child reports, got {len(reports)}")
    for bl in (65536, 1024):
        dst = f"{src}.{bl}.mh.hf2"
        ref = f"{src}.{bl}.ref.hf2"
        t0 = time.perf_counter()
        read_compress_write_hf2(src, ref, block_len=bl, device=dev)
        ref_s = time.perf_counter() - t0
        if sha(dst) != sha(ref):
            fail(f"7c: the two processes' .hf2 at block_len {bl} differs from "
                 "the single-process device writer's")
        if not same_file(f"{dst}.rt", src):
            fail(f"7c: the two processes' decode at block_len {bl} is not exact")
        for r in (x for x in reports if x["block_len"] == bl):
            if not r["compress"]["encode"]:
                fail(f"7c: child {r['rank']} never launched K1: {r}")
            k2, k4 = r["decompress"]["decode"], r["decompress"]["decode_general"]
            if bl > 2048 and (k2 or k4):
                fail(f"7c: block_len {bl} must decode on the host: {r}")
            if bl <= 2048 and not k2:
                fail(f"7c: child {r['rank']} did not decode with K2: {r}")
        comp = max(x["compress_s"] for x in reports if x["block_len"] == bl)
        dec = max(x["decompress_s"] for x in reports if x["block_len"] == bl)
        log(f"phase 7c: block_len {bl}: .hf2 sha256 {sha(dst)[:16]} == the "
            f"single-process device writer's, round trip exact; two processes "
            f"compress {comp:.4f} s ({n / comp / 1e9:.4f} GB/s), decompress "
            f"{dec:.4f} s ({n / dec / 1e9:.4f} GB/s; "
            f"{'host route' if bl > 2048 else 'K2'}); one process "
            f"{ref_s:.4f} s ({n / ref_s / 1e9:.4f} GB/s) [{card}]")
    log(f"phase 7c: the children's wall, start to exit: {wall:.4f} s")


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
    from tpuhuff_torch import native
    from tpuhuff_torch.core.canonical import build_tree_for_device, canonicalize
    from tpuhuff_torch.core.tree import HuffTree
    from tpuhuff_torch.core.weights import ByteWeights
    from tpuhuff_torch.io import (
        build_shared_tree,
        compress_dataset,
        decompress_dataset,
        read_compress_write_hf2,
        read_decompress_write_hf2,
        stream,
        tree_from_counts,
    )
    from tpuhuff_torch.io.hff import read_hf2_header
    from tpuhuff_torch.profiling import StageTimer, tracing
    from tpuhuff_torch.io.host import (
        read_compress_write_host,
        read_compress_write_hf2_host,
        read_decompress_write_hf2_host,
    )
    from tpuhuff_torch.kernels import (
        LUT_BITS,
        _build,
        decode_rows,
        decode_rows_general,
        decode_rows_general_reference,
        decode_rows_reference,
        decode_tile_rows,
        decoder_for,
        encode_blocks,
        encode_blocks_reference,
        histogram,
        histogram_grid,
        histogram_reference,
        lane_rows,
        make_canonical_decode_tables,
        make_decode_tables,
        make_encode_tables,
        out_words,
        payload_to_lane_words,
        stitch_lanes,
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
        f"{torch.cuda.device_count()}, python {sys.version.split()[0]}, "
        f"{os.cpu_count()} host cores")

    # -- phase 2: build ------------------------------------------------------
    t0 = time.perf_counter()
    _build.lib()
    log(f"phase 2: kernels built and loaded in {time.perf_counter() - t0:.3f} s "
        f"(nvcc {_build.build_seconds} s; None = cached build)")
    t0 = time.perf_counter()
    native.lib()
    log(f"phase 2: host runtime built and loaded in "
        f"{time.perf_counter() - t0:.3f} s (g++ {native.build_seconds} s; "
        f"None = cached build)")

    # -- phase 3: kernels against their plain versions -----------------------
    text = make_textlike(MAIN_MB << 20, np)
    fib = make_fib(np)
    rng = np.random.default_rng(7)

    def device_tree(data):
        """The device writer's tree of ``data``, before canonicalisation."""
        return build_tree_for_device(
            ByteWeights(np.bincount(data, minlength=256)), 32)[0]

    def tree_of(data):
        return canonicalize(device_tree(data))

    def general_tree_of(data):
        """A non-canonical tree of ``data``: the device writer's tree, or,
        where that is canonical by construction (length-limited, or a tiny
        alphabet), its mirror (every code's bits inverted)."""
        tree = device_tree(data)
        if make_canonical_decode_tables(tree) is not None:
            tree = HuffTree(tree.right, tree.left, tree.letters, tree.weights,
                            tree.root)
        if make_canonical_decode_tables(tree) is not None:
            fail("general_tree_of gave a canonical tree")
        return tree

    def encode_rows(data, tree, valid=None):
        """K1 over ``data`` as LANE-byte lanes: ``(lanes, valid, tables,
        (words, bits, miss), rows, bit0)``, the rows ready for a decoder."""
        etab = make_encode_tables(*tree.encode_tables()).to(dev)
        B = data.size // LANE
        lanes = torch.from_numpy(data[: B * LANE].reshape(B, LANE)).to(dev)
        if valid is None:
            valid = torch.full((B,), LANE, dtype=torch.int32, device=dev)
        words, bits, miss = encode_blocks(lanes, valid, etab)
        # the words that hold bits, and one slack word: the width that the
        # file path's row gather gives these blocks
        used = max(1, (int(bits.max()) + 31) // 32)
        rows = torch.nn.functional.pad(words[:, :used], (0, 1)).contiguous()
        bit0 = torch.zeros(B, dtype=torch.int32, device=dev)
        return lanes, valid, etab, (words, bits, miss), rows, bit0

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
    rng_k5 = np.random.default_rng(5)  # the earlier phases keep their inputs
    errs = {"encode": 0, "encode_hist": 0, "decode": 0, "decode_general": 0,
            "histogram": 0, "decode_global_rows": 0,
            "decode_general_global_rows": 0, "stitch": 0, "lane_rows": 0}

    def poison(lanes, etab):
        """Fill the allocator's blocks of the words' size with 0xFF and free
        them: the next encode's `words` then starts as 0xFF, so a word the
        kernel leaves unwritten shows against the plain version."""
        shape = (lanes.shape[0], out_words(lanes.shape[1], etab.max_len))
        junk = [torch.empty(shape, dtype=torch.int32, device=dev).fill_(-1)
                for _ in range(2)]
        torch.cuda.synchronize()
        del junk

    def check_k1(name, lanes, valid, etab, poisoned=False):
        """K1 against its plain version: words, bits and miss."""
        if poisoned:
            poison(lanes, etab)
        got = encode_blocks(lanes, valid, etab)
        want = encode_blocks_reference(lanes, valid, etab)
        torch.cuda.synchronize()
        err = max(max_err(torch, g, w) for g, w in zip(got, want))
        errs["encode"] = max(errs["encode"], err)
        log(f"phase 3: encode {name}: {lanes.shape[0]} lanes of "
            f"{lanes.shape[1]} B, max code {etab.max_len} bits, err {err}")

    def check_k5(name, lanes, valid, etab, hist, poisoned=False):
        """K5 against its plain version: words, bits, miss and counts."""
        if poisoned:
            poison(lanes, etab)
        got = encode_blocks(lanes, valid, etab, hist_data=hist)
        want = encode_blocks_reference(lanes, valid, etab, hist_data=hist)
        torch.cuda.synchronize()
        err = max(max_err(torch, g, w) for g, w in zip(got, want))
        errs["encode_hist"] = max(errs["encode_hist"], err)
        # the kernel counts the bytes it holds where the operand starts at
        # the lanes' first byte, and reads any other operand apart
        route = ("in the lanes" if hist.numel()
                 and hist.data_ptr() == lanes.data_ptr() else "distinct")
        log(f"phase 3: encode_hist {name}: {lanes.shape[0]} lanes of "
            f"{lanes.shape[1]} B, operand {hist.numel()} B at address % 16 "
            f"= {hist.data_ptr() % 16} ({route} route), err {err}")

    for name, (data, tree) in cases.items():
        tree = tree if tree is not None else tree_of(data)
        B = data.size // LANE
        valid = torch.full((B,), LANE, dtype=torch.int32, device=dev)
        valid[1::5] = torch.from_numpy(
            rng.integers(0, LANE, valid[1::5].numel()).astype(np.int32)).to(dev)
        lanes, valid, etab, got, rows, bit0 = encode_rows(data, tree, valid)
        want = encode_blocks_reference(lanes, valid, etab)
        torch.cuda.synchronize()
        err = max(max_err(torch, g, w) for g, w in zip(got, want))
        errs["encode"] = max(errs["encode"], err)
        words, bits, miss = got
        n_miss = int(miss.sum())
        if (n_miss > 0) != (name == "missing"):
            fail(f"encode {name}: {n_miss} missing letters")
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
        check_k5(f"{name} (operand = the lanes)", lanes, valid, etab, lanes)
        if name == "textlike":
            # a distinct operand of B*N - 13 bytes, 3 bytes past a 16-byte
            # boundary: the unaligned head and the ragged tail
            other = torch.from_numpy(rng_k5.integers(
                0, 256, lanes.numel() + 16, dtype=np.uint8)).to(dev)
            check_k5(f"{name} (distinct operand)", lanes, valid, etab,
                     other[3: 3 + lanes.numel() - 13])
            del other
            flat = lanes.reshape(-1)
            # the lanes' own storage cut short at an odd length, and a view
            # of it one byte in
            check_k5(f"{name} (odd prefix of the lanes)", lanes, valid, etab,
                     flat[: flat.numel() - 2 * LANE - 1])
            check_k5(f"{name} (the lanes one byte in)", lanes, valid, etab,
                     flat[1:])
            # the allocator's blocks full of 0xFF before the call
            check_k1(f"{name} (words' block poisoned)", lanes, valid, etab,
                     poisoned=True)
            check_k5(f"{name} (words' block poisoned)", lanes, valid, etab,
                     lanes, poisoned=True)

    # K1 at lanes of 8, 4 and 2 bytes: the shapes the TPU gave its
    # flat-layout kernel (K6); here K1's kernel serves every power-of-two
    # lane.  K1 and K5 at lanes of 8, 32 and 1024 bytes under the Fibonacci
    # tree (32-bit codes), K5 on each of its routes, and with the words'
    # block poisoned
    def ragged(B, n_lane):
        valid = torch.full((B,), n_lane, dtype=torch.int32, device=dev)
        valid[1::5] = torch.from_numpy(rng_k5.integers(
            0, n_lane, valid[1::5].numel()).astype(np.int32)).to(dev)
        return valid

    text_tab = make_encode_tables(*tree_of(text).encode_tables()).to(dev)
    for n_lane in (8, 4, 2):
        lanes = torch.from_numpy(text[: 4 << 20].reshape(-1, n_lane)).to(dev)
        check_k1(f"textlike at lanes of {n_lane} B", lanes,
                 ragged(lanes.shape[0], n_lane), text_tab)
    fib_tab = make_encode_tables(*tree_of(fib).encode_tables()).to(dev)
    for n_lane in (8, 32, 1024):
        B = fib.size // n_lane
        lanes = torch.from_numpy(fib[: B * n_lane].reshape(B, n_lane)).to(dev)
        valid = ragged(B, n_lane)
        flat = lanes.reshape(-1)
        check_k1(f"fib at lanes of {n_lane} B", lanes, valid, fib_tab,
                 poisoned=True)
        for op_name, op in (("the lanes", lanes),
                            ("odd prefix of the lanes",
                             flat[: flat.numel() - n_lane - 1]),
                            ("the lanes one byte in", flat[1:])):
            check_k5(f"fib at lanes of {n_lane} B ({op_name})", lanes, valid,
                     fib_tab, op, poisoned=op_name == "the lanes")

    # K4: non-canonical trees; full blocks must decode to their source
    rand4 = rng.integers(0, 256, 4 << 20, dtype=np.uint8)
    two = rng.integers(97, 99, 1 << 20, dtype=np.uint8)
    general = {  # name: (data, the bytes whose counts make the tree)
        "textlike": (text[: main_lanes * LANE], text),
        "random": (rand4, rand4),
        "two letters": (two, two),
        "fib": (fib[: (fib.size // LANE) * LANE], fib),  # 32-bit codes
    }
    for name, (data, counted) in general.items():
        tree = general_tree_of(counted)
        lanes, _, etab, (_, bits, _), rows, bit0 = encode_rows(data, tree)
        nbits = bits.clone()
        nbits[2::7] = (nbits[2::7] - 9).clamp(min=0)  # blocks cut short
        gtab = make_decode_tables(tree).to(dev)
        out = decode_rows_general(rows, bit0, nbits, gtab, LANE)
        plain = decode_rows_general_reference(rows, bit0, nbits, gtab, LANE)
        torch.cuda.synchronize()
        err = max_err(torch, out, plain)
        errs["decode_general"] = max(errs["decode_general"], err)
        full = nbits == bits
        if not torch.equal(out[full], lanes[full]):
            fail(f"decode_general {name}: the full blocks do not round-trip")
        log(f"phase 3: decode_general {name}: {lanes.shape[0]} blocks, max "
            f"code {etab.max_len} bits, non-canonical tree, err {err}")
        if name == "textlike":
            gtab_text = gtab
    # K4 on trees of two leaves (one-bit codes), either way round: the tree
    # the TPU's general decoder cannot trace at one level
    pair = np.where(np.random.default_rng(2).random(1 << 20) < 0.7, 0,
                    255).astype(np.uint8)
    pair_tree = HuffTree.from_weights(ByteWeights(np.bincount(pair,
                                                              minlength=256)))
    for way, tree in (("as built", pair_tree),
                      ("mirrored", HuffTree(pair_tree.right, pair_tree.left,
                                            pair_tree.letters,
                                            pair_tree.weights,
                                            pair_tree.root))):
        lanes, _, etab, (_, bits, _), rows, bit0 = encode_rows(pair, tree)
        nbits = bits.clone()
        nbits[2::7] = (nbits[2::7] - 9).clamp(min=0)  # blocks cut short
        gtab = make_decode_tables(tree).to(dev)
        out = decode_rows_general(rows, bit0, nbits, gtab, LANE)
        plain = decode_rows_general_reference(rows, bit0, nbits, gtab, LANE)
        torch.cuda.synchronize()
        err = max_err(torch, out, plain)
        errs["decode_general"] = max(errs["decode_general"], err)
        full = nbits == bits
        if not torch.equal(out[full], lanes[full]):
            fail(f"decode_general 2-leaf tree ({way}): the full blocks do "
                 "not round-trip")
        log(f"phase 3: decode_general on a 2-leaf tree ({way}, "
            f"{'canonical' if make_canonical_decode_tables(tree) else 'not canonical'}"
            f"): {lanes.shape[0]} blocks, max code {etab.max_len} bit, "
            f"err {err}")
    # rows of random words: not codes, but each kernel must still agree
    # with its plain version
    B, W = 1 << 14, 40
    rows = torch.from_numpy(rng.integers(0, 1 << 32, (B, W), dtype=np.uint64)
                            .astype(np.uint32).view(np.int32)).to(dev)
    bit0 = torch.from_numpy(rng.integers(0, 32, B).astype(np.int32)).to(dev)
    nbits = torch.from_numpy(rng.integers(0, 32 * (W - 1), B)
                             .astype(np.int32)).to(dev)
    decoders = {  # key: (wrapper, plain version)
        "decode": (decode_rows, decode_rows_reference),
        "decode_general": (decode_rows_general,
                           decode_rows_general_reference)}
    dtab_text = make_canonical_decode_tables(tree_of(text)).to(dev)
    for key, tab in (("decode", dtab_text), ("decode_general", gtab_text)):
        decode, plain_fn = decoders[key]
        out = decode(rows, bit0, nbits, tab, LANE)
        plain = plain_fn(rows, bit0, nbits, tab, LANE)
        torch.cuda.synchronize()
        err = max_err(torch, out, plain)
        errs[key] = max(errs[key], err)
        log(f"phase 3: {key} on {B} rows of random words: err {err}")
    # rows too wide for shared memory: the decoders' global-rows route
    B, W = 64, 60_000
    rows = torch.from_numpy(rng.integers(0, 1 << 32, (B, W), dtype=np.uint64)
                            .astype(np.uint32).view(np.int32)).to(dev)
    bit0 = torch.from_numpy(rng.integers(0, 32 * W, B).astype(np.int32)).to(dev)
    nbits = torch.from_numpy(rng.integers(0, 32 * W, B).astype(np.int32)).to(dev)
    for key, tab in (("decode", dtab_text), ("decode_general", gtab_text)):
        decode, plain_fn = decoders[key]
        if decode_tile_rows(B, W, 300, key == "decode_general", dev) != 0:
            fail(f"{key}: rows of {W} words fit in shared memory")
        before = decode.global_launches
        out = decode(rows, bit0, nbits, tab, 300)
        plain = plain_fn(rows, bit0, nbits, tab, 300)
        torch.cuda.synchronize()
        if decode.global_launches != before + 1:
            fail(f"{key}: rows of {W} words did not take the global-rows route")
        err = max_err(torch, out, plain)
        errs[f"{key}_global_rows"] = err
        log(f"phase 3: {key} on {B} rows of {W} random words (global-rows "
            f"route), block_len 300: err {err}")

    # host-written .hf2 payloads at block_len 1000 and 2048, gathered into
    # rows as the file path does: K2 on the canonical tree, K4 on the
    # non-canonical one; whole blocks must restore their source
    head4 = text[: 4 << 20]
    with tempfile.TemporaryDirectory(prefix="tpuhuff_chip_smoke_") as tmp:
        src = os.path.join(tmp, "src.bin")
        head4.tofile(src)
        general = {"canonical": False, "tree": general_tree_of(head4)}
        for block_len in (1000, 2048):
            for key, kw in (("decode", {}), ("decode_general", general)):
                dst = os.path.join(tmp, f"{block_len}.hf2")
                read_compress_write_hf2_host(src, dst, block_len=block_len,
                                             max_code_len=32, **kw)
                with open(dst, "rb") as fp:
                    hdr = read_hf2_header(fp)
                    fp.seek(hdr.payload_offset)
                    payload = fp.read()
                decode, plain_fn = decoders[key]
                if decoder_for(hdr.tree)[0] is not decode:
                    fail(f"{key} at block_len {block_len}: wrong decoder")
                tab = decoder_for(hdr.tree)[1].to(dev)
                ends = hdr.end_bits.astype(np.int64)
                starts = np.concatenate([[0], ends[:-1]])
                rows_np, bit0_np = payload_to_lane_words(payload, starts, ends,
                                                         block_len)
                rows = torch.from_numpy(rows_np.view(np.int32)).to(dev)
                bit0 = torch.from_numpy(bit0_np).to(dev)
                nbits = torch.from_numpy((ends - starts).astype(np.int32)
                                         ).to(dev)
                nbits[2::7] = (nbits[2::7] - 9).clamp(min=0)  # cut short
                out = decode(rows, bit0, nbits, tab, block_len)
                plain = plain_fn(rows, bit0, nbits, tab, block_len)
                torch.cuda.synchronize()
                err = max_err(torch, out, plain)
                errs[key] = max(errs[key], err)
                B = out.shape[0] - 1  # the last block is short
                keep = np.ones(B, bool)
                keep[2::7] = False
                if not np.array_equal(out[:B].cpu().numpy()[keep],
                                      head4[: B * block_len].reshape(
                                          B, block_len)[keep]):
                    fail(f"{key} at block_len {block_len}: whole blocks do "
                         "not restore their source")
                n = decode_tile_rows(*rows.shape, block_len,
                                     key == "decode_general", dev)
                log(f"phase 3: {key} at block_len {block_len}: "
                    f"{rows.shape[0]} blocks of {rows.shape[1]} words, "
                    f"k {LUT_BITS}, n {n} blocks per thread block, err {err}")

    text_dev = torch.from_numpy(text).to(dev)
    hist_inputs = {kind: text_dev if kind == "textlike" else torch.from_numpy(
        make_hist_input(kind, MAIN_MB << 20, np, seed=11)).to(dev)
        for kind in HIST_KINDS}
    for kind, data in hist_inputs.items():
        for n in (1, 15, 4097, (1 << 20) + 3, 64 << 20, MAIN_MB << 20):
            for off in (0, 3, 13):
                view = data[off: off + n]
                h = histogram(view)
                hp = histogram_reference(view)
                torch.cuda.synchronize()
                errs["histogram"] = max(errs["histogram"],
                                        max_err(torch, h, hp))
        # added into running counts over pieces, as pass 1 does
        acc = torch.full((256,), 7, dtype=torch.int64, device=dev)
        for lo in range(0, data.numel(), (15 << 20) + 5):
            histogram(data[lo: lo + (15 << 20) + 5], out=acc)
        errs["histogram"] = max(errs["histogram"], max_err(
            torch, acc - 7, histogram_reference(data)))
    log(f"phase 3: histogram over 1 B .. {MAIN_MB} MiB of {HIST_KINDS}, "
        f"starts 0, 3 and 13 bytes past a 16-byte boundary, and into running "
        f"counts over 15 MiB pieces: max err {errs['histogram']}")
    # the host stages on the card: the stitch S1 and the row gather S2
    stage_timing, stage_moved = phase3_host_stages(dev, card, np, torch, cases,
                                                   tree_of, errs)
    if any(errs.values()):
        fail(f"kernels disagree with their plain versions: {errs}")

    # timing at the main path's shapes: one 64 MiB chunk of full 256-byte
    # blocks, encoded under the canonical tree (K1, K2) and under the same
    # code lengths in the device writer's own, non-canonical order (K4)
    main = text[: main_lanes * LANE]
    lanes, valid, etab, (words, bits, _), rows, bit0 = encode_rows(
        main, tree_of(text))
    gtree = general_tree_of(text)
    _, _, _, (gwords, gbits, _), grows, _ = encode_rows(main, gtree)
    s = {"lanes": lanes, "valid": valid, "etab": etab, "words": words,
         "rows": rows, "bit0": bit0, "nbits": bits,
         "dtab": make_canonical_decode_tables(tree_of(text)).to(dev),
         "grows": grows, "gnbits": gbits,
         "gtab": make_decode_tables(gtree).to(dev)}
    if not torch.equal(bits, gbits):  # same code lengths, same bit counts
        fail("canonical and non-canonical trees give other bit counts")
    # the decoders' first-level table: a symbol escapes it where its code is
    # longer than k bits (both trees have the same code lengths)
    code_lens = tree_of(text).encode_tables()[0].astype(np.int64)
    counts = np.bincount(main, minlength=256)
    escape = counts[code_lens > LUT_BITS].sum() / counts.sum()
    n2, n4 = (decode_tile_rows(*r.shape, LANE, general, dev)
              for r, general in ((rows, False), (grows, True)))
    log(f"phase 3: decoders' first-level table k {LUT_BITS} "
        f"({1 << LUT_BITS} entries): {escape:.6%} of the main input's "
        f"symbols escape it (max code {code_lens.max()} bits); n {n2} (K2) "
        f"and {n4} (K4) blocks per thread block at W {rows.shape[1]}, "
        f"block_len {LANE}")
    hist_chunk = text_dev[: 64 << 20]
    hist_acc = torch.zeros(256, dtype=torch.int64, device=dev)
    timing = {  # (kernel ms, plain ms, library ms or None)
        "encode": (cuda_ms(torch, lambda: encode_blocks(
                       s["lanes"], s["valid"], s["etab"])),
                   cuda_ms(torch, lambda: encode_blocks_reference(
                       s["lanes"], s["valid"], s["etab"]), reps=2), None),
        # K5 with the adaptive path's operand, the lanes themselves; no one
        # PyTorch call computes it (K1 + K3 is printed as the yardstick)
        "encode_hist": (cuda_ms(torch, lambda: encode_blocks(
                            s["lanes"], s["valid"], s["etab"],
                            hist_data=s["lanes"])),
                        cuda_ms(torch, lambda: encode_blocks_reference(
                            s["lanes"], s["valid"], s["etab"],
                            hist_data=s["lanes"]), reps=2), None),
        "decode": (cuda_ms(torch, lambda: decode_rows(
                       s["rows"], s["bit0"], s["nbits"], s["dtab"], LANE)),
                   cuda_ms(torch, lambda: decode_rows_reference(
                       s["rows"], s["bit0"], s["nbits"], s["dtab"], LANE),
                       reps=2), None),
        "decode_general": (
            cuda_ms(torch, lambda: decode_rows_general(
                s["grows"], s["bit0"], s["gnbits"], s["gtab"], LANE)),
            cuda_ms(torch, lambda: decode_rows_general_reference(
                s["grows"], s["bit0"], s["gnbits"], s["gtab"], LANE), reps=2),
            None),
        # as pass 1 calls it: adding into running counts
        "histogram": (cuda_ms(torch, lambda: histogram(hist_chunk,
                                                       out=hist_acc)),
                      cuda_ms(torch, lambda: histogram_reference(
                          hist_chunk, out=hist_acc)),
                      cuda_ms(torch, lambda: torch.bincount(hist_chunk,
                                                            minlength=256))),
    }
    # the least time for the same work: each input read once and each
    # output written once at 3.35 TB/s (the tables, 1-2 KiB, are counted too)
    out_b = main_lanes * LANE
    moved = {
        "encode": nbytes(s["lanes"], s["valid"], s["etab"].lens,
                         s["etab"].acodes, s["words"]) + 8 * main_lanes,
        # the operand is the lanes, already counted: only the counts added
        "encode_hist": nbytes(s["lanes"], s["valid"], s["etab"].lens,
                              s["etab"].acodes, s["words"]) + 8 * main_lanes
                       + 256 * 8,
        "decode": payload_bytes(s["bit0"], s["nbits"]) + 8 * main_lanes
                  + nbytes(s["dtab"].ub, s["dtab"].dd, s["dtab"].perm) + out_b,
        "decode_general": payload_bytes(s["bit0"], s["gnbits"])
                          + 8 * main_lanes + nbytes(s["gtab"].thr,
                                                    s["gtab"].sym,
                                                    s["gtab"].len) + out_b,
        "histogram": hist_chunk.numel() + 2 * 256 * 8,  # counts in and out
    }
    bound = {k: b / HBM_BYTES_PER_MS for k, b in moved.items()}
    for k, (ms, plain_ms, lib_ms) in timing.items():
        log(f"phase 3: {k} at the main path's shapes: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, library "
            f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
            f"{bound[k]:.4f} ms ({moved[k]} B at 3.35 TB/s) [{card}]")
    distinct = (moved["encode_hist"] + s["lanes"].numel()) / HBM_BYTES_PER_MS
    other = torch.empty_like(s["lanes"])  # the distinct route, same size
    k5_distinct = cuda_ms(torch, lambda: encode_blocks(
        s["lanes"], s["valid"], s["etab"], hist_data=other))
    log(f"phase 3: encode_hist beside its unfused yardstick: K5 "
        f"{timing['encode_hist'][0]:.4f} ms (operand the lanes), "
        f"{k5_distinct:.4f} ms (a distinct operand of the same size), K1 + "
        f"K3 {timing['encode'][0] + timing['histogram'][0]:.4f} ms (K1 "
        f"{timing['encode'][0]:.4f} + K3 {timing['histogram'][0]:.4f} on "
        f"{hist_chunk.numel()} B); bound {distinct:.4f} ms were the operand "
        f"a distinct tensor of the same size [{card}]")
    # K1 and K5 at lanes of 8 bytes: the same 64 MiB as 8,388,608 lanes
    lanes8 = s["lanes"].reshape(-1, 8)
    valid8 = torch.full((lanes8.shape[0],), 8, dtype=torch.int32, device=dev)
    k1_8 = cuda_ms(torch, lambda: encode_blocks(lanes8, valid8, s["etab"]))
    k5_8 = cuda_ms(torch, lambda: encode_blocks(lanes8, valid8, s["etab"],
                                                hist_data=lanes8))
    R8 = out_words(8, s["etab"].max_len)
    bound8 = (nbytes(lanes8, valid8, s["etab"].lens, s["etab"].acodes)
              + (4 * R8 + 8) * lanes8.shape[0]) / HBM_BYTES_PER_MS
    log(f"phase 3: encode at lanes of 8 B ({lanes8.shape[0]} lanes, {R8} "
        f"words each): K1 {k1_8:.4f} ms, K5 (operand the lanes) {k5_8:.4f} "
        f"ms, bound {bound8:.4f} ms [{card}]")
    # K3 on 64 MiB of each input kind: its time must not depend on them
    grid, per_sm = histogram_grid(64 << 20, dev)
    log(f"phase 3: histogram launch over 64 MiB: {grid} thread blocks, "
        f"{per_sm} to an SM")
    for kind, data in hist_inputs.items():
        chunk = data[: 64 << 20]
        ms = cuda_ms(torch, lambda: histogram(chunk, out=hist_acc))
        alone_ms, host = spin_ms(torch, lambda: histogram(chunk, out=hist_acc))
        lib_ms = cuda_ms(torch, lambda: torch.bincount(chunk, minlength=256))
        log(f"phase 3: K3 on 64 MiB of {kind}: card {ms:.4f} ms, alone "
            f"{alone_ms:.4f} ms, the wrapper's host time per call {host:.4f} "
            f"ms, torch.bincount {lib_ms:.4f} ms, bound "
            f"{bound['histogram']:.4f} ms [{card}]")
    del hist_inputs, chunk, data
    # every kernel's second reading: the device's time alone, beside the
    # wrapper's host time per call (the times above hold the larger)
    alone = {
        "K2": lambda: decode_rows(s["rows"], s["bit0"], s["nbits"],
                                  s["dtab"], LANE),
        "K4": lambda: decode_rows_general(s["grows"], s["bit0"], s["gnbits"],
                                          s["gtab"], LANE),
        "K1": lambda: encode_blocks(s["lanes"], s["valid"], s["etab"]),
        "K5": lambda: encode_blocks(s["lanes"], s["valid"], s["etab"],
                                    hist_data=s["lanes"]),
        "K5 (a distinct operand)": lambda: encode_blocks(
            s["lanes"], s["valid"], s["etab"], hist_data=other),
        "K1 at lanes of 8 B": lambda: encode_blocks(lanes8, valid8, s["etab"]),
        "K5 at lanes of 8 B": lambda: encode_blocks(
            lanes8, valid8, s["etab"], hist_data=lanes8),
    }
    for k, fn in alone.items():
        ms, host = spin_ms(torch, fn)
        log(f"phase 3: {k}, the device's time alone (behind a device spin): "
            f"{ms:.4f} ms; the wrapper's host time per call {host:.4f} ms "
            f"[{card}]")
    del other, lanes8, valid8, alone
    # the decoders on rows as wide as K1's output (and one slack word): the
    # time of the row-staging kernels grows with the row width
    wide = {"decode": (decode_rows, s["words"], s["nbits"], s["dtab"]),
            "decode_general": (decode_rows_general, gwords, s["gnbits"],
                               s["gtab"])}
    for k, (fn, w, nb, tab) in wide.items():
        w = torch.nn.functional.pad(w, (0, 1))
        ms = cuda_ms(torch, lambda: fn(w, s["bit0"], nb, tab, LANE))
        log(f"phase 3: {k} on rows of K1's full width ({w.shape[1]} words, "
            f"not {s['rows'].shape[1]}): kernel {ms:.4f} ms [{card}]")
    # the global-rows route at the shape phase 7b gives one launch: a shard
    # of 16 blocks of 65536 codes of 25-32 bits.  The plain version takes
    # tens of seconds here: one call, timed with events, which also gives
    # the error at this shape (the kernels line times the route on phase
    # 4f's real text group)
    for key, (t, _, rows_np, bit0_np, bits_np) in wide_code_blocks(np, 16).items():
        decode, plain_fn = decoders[key]
        tab = decoder_for(t)[1].to(dev)
        r = torch.from_numpy(rows_np.view(np.int32)).to(dev)
        b0 = torch.from_numpy(bit0_np).to(dev)
        nb = torch.from_numpy(bits_np).to(dev)
        ms = cuda_ms(torch, lambda: decode(r, b0, nb, tab, 65536))
        alone_ms, _ = spin_ms(torch, lambda: decode(r, b0, nb, tab, 65536))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = plain_fn(r, b0, nb, tab, 65536)
        end.record()
        end.synchronize()
        plain_ms = start.elapsed_time(end)
        err = max_err(torch, decode(r, b0, nb, tab, 65536), want)
        glob = f"{key}_global_rows"
        errs[glob] = max(errs[glob], err)
        tables = ((tab.ub, tab.dd, tab.perm) if key == "decode"
                  else (tab.thr, tab.sym, tab.len))
        moved = (payload_bytes(b0, nb) + 8 * r.shape[0] + nbytes(*tables)
                 + r.shape[0] * 65536)
        log(f"phase 3: {glob} at the shape of a phase-7b launch ({r.shape[0]} "
            f"blocks of 65536 codes of 25-32 bits, rows of {r.shape[1]} "
            f"words): kernel {ms:.4f} ms, alone {alone_ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound "
            f"{moved / HBM_BYTES_PER_MS:.4f} ms ({moved} B at 3.35 TB/s), err "
            f"{err} [{card}]")
    if any(errs.values()):
        fail(f"kernels disagree with their plain versions: {errs}")
    del s, lanes, valid, words, rows, grows, gwords, wide, text_dev, hist_chunk
    torch.cuda.synchronize()

    # -- phase 4: the main paths ---------------------------------------------
    counters = {"stitch": (stitch_lanes, "launches"),
                "lane_rows": (lane_rows, "launches"),
                "encode": (encode_blocks, "launches"),
                "encode_hist": (encode_blocks, "hist_launches"),
                "decode": (decode_rows, "launches"),
                "decode_general": (decode_rows_general, "launches"),
                "histogram": (histogram, "launches"),
                "decode_global_rows": (decode_rows, "global_launches"),
                "decode_general_global_rows": (decode_rows_general,
                                               "global_launches")}

    def reset():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)

    def read():
        torch.cuda.synchronize()
        return {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}

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

        def round_trip(name, tag, **kw):
            """Port container == host writer's, both decode on the card to
            the source; returns the port container's path."""
            src = os.path.join(work, f"{name}.bin")
            dst, ref = f"{src}.{tag}.hf2", f"{src}.{tag}.ref.hf2"
            out, out_ref = dst + ".out", ref + ".out"
            with host_stages_forbidden():
                read_compress_write_hf2(src, dst, device=dev, **kw)
                read_decompress_write_hf2(dst, out, device=dev)
            read_compress_write_hf2_host(
                src, ref, **{"block_len": LANE, "max_code_len": 32, **kw})
            with host_stages_forbidden():
                read_decompress_write_hf2(ref, out_ref, device=dev)
            if sha(dst) != sha(ref):
                fail(f"{name} ({tag}): port container differs from the host "
                     "writer's")
            if not same_file(out, src) or not same_file(out_ref, src):
                fail(f"{name} ({tag}): device decode does not restore the "
                     "source")
            log(f"phase 4: {name} ({tag}): {os.path.getsize(src)} B -> "
                f"{os.path.getsize(dst)} B, sha256 {sha(dst)[:16]} == host "
                f"writer's, decode restores the source")
            return dst

        # (a) canonical containers: K1, K2, K3; each file fits on the
        # card, so the writer reads it once and encodes from its copy
        reset()
        traced = StageTimer()
        with tracing(traced):
            for name in ("textlike", "random", "fib"):
                round_trip(name, "canonical")
        launches = read()
        resident = [r.counters["resident_bytes"].n for r in traced.records
                    if r.op == "compress" and "resident_bytes" in r.counters]
        sizes = [os.path.getsize(os.path.join(work, f"{name}.bin"))
                 for name in ("textlike", "random", "fib")]
        if resident != sizes:
            fail(f"4a: the canonical writes encoded {resident} bytes from "
                 f"the card's copy, not their files' {sizes}")
        log(f"phase 4a: launches during the canonical path: {launches}")
        if not all(launches[k] for k in ("encode", "decode", "histogram")):
            fail(f"a kernel of the canonical path never launched: {launches}")
        pieces = sum(pass1_pieces(os.path.join(work, f"{name}.bin"))
                     for name in ("textlike", "random", "fib"))
        if launches["histogram"] != pieces:
            fail(f"4a: pass 1 launched K3 {launches['histogram']} times for "
                 f"{pieces} pieces")
        log(f"phase 4a: pass 1 launched K3 once per piece ({pieces} pieces)")
        srcs4a = [os.path.join(work, f"{name}.bin")
                  for name in ("textlike", "random", "fib")]
        chunks = sum(pass2_chunks(p) for p in srcs4a)
        groups = 2 * sum(decode_groups(p) for p in srcs4a)  # two decodes each
        if (launches["stitch"], launches["encode"]) != (chunks, chunks):
            fail(f"4a: S1 {launches['stitch']} and K1 {launches['encode']} "
                 f"launches for {chunks} pass-2 chunks")
        if (launches["lane_rows"], launches["decode"]) != (groups, groups):
            fail(f"4a: S2 {launches['lane_rows']} and K2 {launches['decode']} "
                 f"launches for {groups} decode groups")
        log(f"phase 4a: S1 once per pass-2 chunk ({chunks} chunks), S2 once "
            f"per decode group ({groups} groups); no host stitch, shifting "
            "sink write, lane padding or host row gather ran")
        # the two-pass route: no room on the card, and a sampled pass 1;
        # pass 2 reads the file again
        textlike = os.path.join(work, "textlike.bin")
        reset()
        traced = StageTimer()
        with tracing(traced):
            free_bytes = stream._device_free_bytes
            stream._device_free_bytes = lambda dev: 0
            try:
                round_trip("textlike", "two_pass")
            finally:
                stream._device_free_bytes = free_bytes
            round_trip("textlike", "sampled", hist_sample=4)
        launches = read()
        if any("resident_bytes" in r.counters for r in traced.records):
            fail("4a: a two-pass write encoded from a copy on the card")
        reads = [r.spans["read"].bytes for r in traced.records
                 if r.op == "compress"]
        if reads != [2 * os.path.getsize(textlike)] * 2:
            fail(f"4a: the two-pass writes read {reads} bytes, not their "
                 "file twice each")
        pieces = pass1_pieces(textlike) + pass1_pieces(textlike,
                                                       hist_sample=4)
        if launches["histogram"] != pieces:
            fail(f"4a: the two-pass pass 1 launched K3 "
                 f"{launches['histogram']} times for {pieces} pieces")
        log(f"phase 4a: two-pass route (no room on the card; hist_sample 4):"
            f" containers equal the host writer's, K3 once per piece "
            f"({pieces} pieces), the file read twice")
        pass1_trace(work)
        # (b) non-canonical containers: K4.  The Fibonacci file's own tree
        # is length-limited, hence canonical by construction, so its
        # canonical=False container decodes with K2; under its mirrored
        # tree (32-bit codes, not canonical) it takes K4.
        fib_src = os.path.join(work, "fib.bin")
        fib_mirror = general_tree_of(np.fromfile(fib_src, dtype=np.uint8))
        reset()
        for name, tag, kw, want_k2 in (
                ("textlike", "general", {"canonical": False}, False),
                ("fib", "general", {"canonical": False}, True),
                ("fib", "mirrored", {"canonical": False, "tree": fib_mirror},
                 False)):
            before = read()
            round_trip(name, tag, **kw)
            after = read()
            k2 = after["decode"] - before["decode"]
            k4 = after["decode_general"] - before["decode_general"]
            s2 = after["lane_rows"] - before["lane_rows"]
            log(f"phase 4b: {name} ({tag}): decode launches K2 {k2}, K4 {k4}, "
                f"S2 {s2}")
            if s2 != k2 + k4:
                fail(f"{name} ({tag}): S2 {s2} launches for {k2 + k4} decodes")
            if (k2 > 0) != want_k2 or (k4 > 0) == want_k2:
                fail(f"{name} ({tag}): wrong decoder (K2 {k2}, K4 {k4})")
        launches_b = read()
        log(f"phase 4b: launches during the non-canonical path: {launches_b}")
        if not launches_b["decode_general"]:
            fail("decode_rows_general never launched on the main path")
        launches["decode_general"] = launches_b["decode_general"]

        # (c) config 4: a dataset of drifting shards
        srcs = []
        for k in range(N_SHARDS):
            path = os.path.join(work, f"shard{k}.bin")
            make_shard(k, np).tofile(path)
            srcs.append(path)

        def tree_bin(path):
            with open(path, "rb") as fp:
                return read_hf2_header(fp).tree.as_bin().to_bytes()

        def dataset_run(mode, **kw):
            """compress_dataset + decompress_dataset on the card, counted;
            every shard must be restored.  Returns (outputs, stats,
            launches)."""
            stats = {}
            reset()
            with host_stages_forbidden():
                outs = compress_dataset(srcs[: kw.pop("n", N_SHARDS)],
                                        out_dir=os.path.join(work, mode),
                                        device=dev, stats=stats, **kw)
            decs = decompress_dataset(outs, out_dir=os.path.join(work, mode,
                                                                 "dec"),
                                      device=dev)
            counts = read()
            if counts["stitch"] != counts["encode"] + counts["encode_hist"]:
                fail(f"4c {mode}: S1 did not follow every K1/K5: {counts}")
            for src, dec in zip(srcs, decs):
                if not same_file(dec, src):
                    fail(f"4c {mode}: {dec} does not restore {src}")
                os.unlink(dec)
            log(f"phase 4c: {mode}: {len(outs)} shards, {stats}, launches "
                f"{counts}, every shard restored on the card")
            return outs, stats, counts

        def same_as_host(mode, outs, trees, writer):
            """Each container's SHA-256 == the host writer's under the
            same tree; then the mode's outputs go."""
            for k, (dst, tree) in enumerate(zip(outs, trees)):
                ref = dst + ".ref"
                writer(srcs[k], ref, tree)
                if sha(dst) != sha(ref):
                    fail(f"4c {mode}: shard {k} differs from the host writer's")
                os.unlink(ref)
            log(f"phase 4c: {mode}: {len(outs)} containers sha256-equal to "
                f"the host writer's under the same trees")
            shutil.rmtree(os.path.join(work, mode))

        def host_hf2(src, dst, tree):
            read_compress_write_hf2_host(src, dst, block_len=LANE, tree=tree)

        # (i) shared mode: one tree; K1 and K2, and no K5 or K3
        outs, stats, counts = dataset_run("shared")
        if stats["tree_builds"] != 1 or len({tree_bin(p) for p in outs}) != 1:
            fail(f"4c shared: not one tree for the dataset: {stats}")
        if not (counts["encode"] and counts["decode"]) or (
                counts["encode_hist"] or counts["histogram"]):
            fail(f"4c shared: wrong kernels {counts}")
        same_as_host("shared", outs, [build_shared_tree(srcs)] * N_SHARDS,
                     host_hf2)
        # (ii) adaptive mode: shard k's tree from shard k-1's counts (K5)
        outs, astats, counts = dataset_run("adaptive", adaptive=True)
        launches["encode_hist"] = counts["encode_hist"]
        if astats["tree_builds"] != N_SHARDS or not counts["encode_hist"]:
            fail(f"4c adaptive: {astats}, launches {counts}")
        trees = [build_shared_tree(srcs[:1])] + [
            tree_from_counts(native.hist(np.fromfile(src, dtype=np.uint8)),
                             device=True) for src in srcs[:-1]]
        same_as_host("adaptive", outs, trees, host_hf2)
        stale = {}
        compress_dataset(srcs, out_dir=os.path.join(work, "stale"),
                         tree_from=srcs[0], device=dev, stats=stale)
        shutil.rmtree(os.path.join(work, "stale"))
        log(f"phase 4c: ratio adaptive {astats['ratio']:.6f}, shared "
            f"{stats['ratio']:.6f}, stale (shard 0's tree) "
            f"{stale['ratio']:.6f}")
        if not astats["ratio"] < stale["ratio"]:
            fail("4c: the adaptive ratio is not below the stale tree's")
        # (iii) .hff shards under one shared tree: K1
        outs, _, counts = dataset_run("hff", hf2=False, n=2)
        if not counts["encode"]:
            fail(f"4c hff: K1 never launched: {counts}")
        same_as_host("hff", outs, [build_shared_tree(srcs[:2])] * 2,
                     lambda src, dst, tree: read_compress_write_host(
                         src, dst, tree=tree))

        # (d) 8-byte lanes (block_len 1000): the TPU's flat-layout route, K6
        reset()
        round_trip("random", "block1000", block_len=1000)
        counts = read()
        log(f"phase 4d: block_len 1000 (lanes of 8 B): launches {counts}")
        if not counts["encode"] or counts["stitch"] != counts["encode"]:
            fail("4d: K1 and S1 did not launch alike at 8-byte lanes")
        if counts["lane_rows"] != counts["decode"] + counts["decode_general"]:
            fail(f"4d: S2 did not precede every decode: {counts}")
        # (e) the missing-letter count and the block bit lengths beside K1
        phase4e_guards(work, dev, card, np, torch)
        # (f) config 2's 64 KiB blocks, and 1 MiB ones, decoded on the card
        wide_launches, wide_timing = phase4f_wide_blocks(
            work, dev, card, reset, read, errs, np, torch)

        # -- phase 5: rates --------------------------------------------------
        src = os.path.join(work, "textlike.bin")
        gen = src + ".general.hf2"
        size = os.path.getsize(src)
        best = {"port compress": [], "port decompress": [],
                "port decompress, non-canonical (K4)": [],
                "host compress": [], "host decompress": []}
        for _ in range(3):
            t0 = time.perf_counter()
            read_compress_write_hf2(src, src + ".p", device=dev)
            t1 = time.perf_counter()
            read_decompress_write_hf2(src + ".p", src + ".po", device=dev)
            t2 = time.perf_counter()
            read_decompress_write_hf2(gen, src + ".go", device=dev)
            t3 = time.perf_counter()
            read_compress_write_hf2_host(src, src + ".h", block_len=LANE,
                                         max_code_len=32)
            t4 = time.perf_counter()
            read_decompress_write_hf2_host(src + ".h", src + ".ho")
            t5 = time.perf_counter()
            for key, dt in zip(best, (t1 - t0, t2 - t1, t3 - t2, t4 - t3,
                                      t5 - t4)):
                best[key].append(dt)
        a = torch.empty(size, dtype=torch.uint8, device=dev)
        b = torch.empty_like(a)
        copy_ms = cuda_ms(torch, lambda: b.copy_(a), reps=20)
        for key, dts in best.items():
            log(f"phase 5: {key}: {size / min(dts) / 1e9:.4f} GB/s wall, "
                f"best of {len(dts)} on {size} B [{card}]")
        log(f"phase 5: device-to-device copy_: {size / copy_ms / 1e6:.2f} GB/s "
            f"({copy_ms:.4f} ms for {size} B) [{card}]")
        del a, b

        # dataset compress, tree builds included, beside the host writer
        # doing the same work: one sampled tree, or a tree per shard from
        # the previous shard's counts (the host writer's collect_hist)
        out_dir = os.path.join(work, "rates")
        os.makedirs(out_dir)
        dst = os.path.join(out_dir, "x.hf2")

        def host_shared():
            tree = build_shared_tree(srcs)
            for src in srcs:
                host_hf2(src, dst, tree)

        def host_adaptive():
            tree = build_shared_tree(srcs[:1])
            for k, src in enumerate(srcs):
                hist = read_compress_write_hf2_host(
                    src, dst, block_len=LANE, tree=tree,
                    collect_hist=k + 1 < N_SHARDS)
                if hist is not None:
                    tree = tree_from_counts(hist)

        runs = {
            "port dataset compress, shared": lambda: compress_dataset(
                srcs, out_dir=out_dir, device=dev),
            "host dataset compress, shared": host_shared,
            "port dataset compress, adaptive (K5)": lambda: compress_dataset(
                srcs, out_dir=out_dir, device=dev, adaptive=True),
            "host dataset compress, adaptive": host_adaptive,
        }
        dts = {key: [] for key in runs}
        for _ in range(2):
            for key, run in runs.items():
                t0 = time.perf_counter()
                run()
                dts[key].append(time.perf_counter() - t0)
        total = sum(os.path.getsize(p) for p in srcs)
        for key, d in dts.items():
            log(f"phase 5: {key}: {total / min(d) / 1e9:.4f} GB/s wall, best "
                f"of {len(d)} on {total} B ({N_SHARDS} shards) [{card}]")

        # -- phase 6: the command line ---------------------------------------
        shutil.rmtree(out_dir)
        phase6_cli(work, dev, card, reset, read, np)

        # -- phase 7: config 3 on a mesh, the sharded decoders, config 5 -----
        t7 = time.perf_counter()
        phase7_mesh(dev, card, reset, read, np, torch)
        phase7_multiprocess(work, dev, card, np)
        log(f"phase 7: {time.perf_counter() - t7:.3f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    if "jax" in sys.modules:
        fail("jax was imported")
    jax_package = sorted(m for m in sys.modules
                         if m == "tpuhuff" or m.startswith("tpuhuff."))
    if jax_package:
        fail(f"modules of the JAX package were imported: {jax_package}")
    sources = {
        "encode": ("tpuhuff_torch/csrc/encode.cu",
                   "tpuhuff/kernels/pallas_encode2.py:210 (fused, call :545); "
                   "K6 :169 (flat, call :412); K7 :169 (cell, call :599)"),
        "encode_hist": ("tpuhuff_torch/csrc/encode.cu",
                        "tpuhuff/kernels/pallas_encode2.py:210 "
                        "(with_hist, :314-332)"),
        "decode": ("tpuhuff_torch/csrc/decode.cu",
                   "tpuhuff/kernels/pallas_decode.py:227"),
        "decode_general": ("tpuhuff_torch/csrc/decode_general.cu",
                           "tpuhuff/kernels/pallas_decode.py:269"),
        "histogram": ("tpuhuff_torch/csrc/histogram.cu",
                      "tpuhuff/kernels/pallas_histogram.py:139"),
        # no Pallas kernel computes these two: the host functions they stand for
        "stitch": ("tpuhuff_torch/csrc/stitch.cu + "
                   "tpuhuff_torch/csrc/stitch_common.cuh",
                   "tpuhuff/dist/__init__.py:33 (stitch_words, host)"),
        "lane_rows": ("tpuhuff_torch/csrc/lane_rows.cu + "
                      "tpuhuff_torch/csrc/lane_rows_common.cuh",
                      "tpuhuff/kernels/decode.py:88 (payload_to_lane_words, "
                      "host)"),
    }
    timing.update(stage_timing)
    bound.update({k: b / HBM_BYTES_PER_MS for k, b in stage_moved.items()})
    kernels = [{"name": k, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[k], "max_abs_err": errs[k],
                "ms": timing[k][0], "plain_ms": timing[k][1],
                "bound_ms": bound[k], "bound_by": "bytes",
                "library_ms": timing[k][2]}
               for k, (src, rep) in sources.items()]
    # the decoders' route for rows too wide for shared memory: the main
    # path's at config 2's 64 KiB blocks (phase 4f: the launches of the 64
    # KiB calls, timed on a real 1,024-block group); its launches are also
    # in K2's and K4's
    for k in ("decode", "decode_general"):
        glob = f"{k}_global_rows"
        ms, plain_ms, bound_ms = wide_timing[glob]
        kernels.append({
            "name": glob, "route": "cuda",
            "source": f"{sources[k][0]} + tpuhuff_torch/csrc/decode_common.cuh"
                      " + tpuhuff_torch/csrc/decode_split.cuh (kGlobalRows)",
            "replaces": sources[k][1], "launches": wide_launches[glob],
            "max_abs_err": errs[glob], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
