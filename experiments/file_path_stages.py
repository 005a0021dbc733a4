#!/usr/bin/env python3
"""Where the time of the port's ``.hf2`` file path goes, stage by stage.

Times one ``read_compress_write_hf2`` and one ``read_decompress_write_hf2``
call (``device="cuda"``, canonical container, ``block_len`` 256, 64 MiB
chunks) on the 100 MiB textlike input of ``chip_smoke.make_textlike``,
with a ``perf_counter`` span around each host stage.  The spans are put
in from outside, by wrapping the functions the file path calls (whichever
of them the timed checkout has), so the same script times a parent
checkout and this one:

* ``read`` and ``file write``: the ``read``/``readinto`` and ``write`` of
  the files that ``tpuhuff_torch.io.stream`` opens;
* ``crc``: ``native.crc32_blocks`` (compress), ``_CrcVerifier.feed``
  (decompress);
* ``lane padding``: ``pad_to_blocks``;
* ``pinned staging``: the ``_Staging`` methods that fill or start pinned
  copies (``h2d``, ``d2h``, ``read_into``, ``to_device``, ``fetch``),
  less the reads and waits inside them (where a checkout reads straight
  into pinned memory, the zeroing of a chunk's tail is here);
* ``launches``: the kernel wrappers' host time (the histogram, the
  encode, the decoder; the device stitch and row gather where the
  checkout has them);
* ``kernel wait``: ``torch.cuda.Event.synchronize``, the host blocked on
  the device; ``D2H wait``: ``torch.cuda.Stream.synchronize``, the host
  blocked on a copy back;
* ``byteswap and stitch``: ``stitch_words`` (the host stitch);
* ``sink write``: ``_BitSink.write`` or ``write_aligned``, less the file
  writes inside;
* ``row gather``: ``payload_to_lane_words`` (the host gather);
* ``other``: the call's wall less every span above (tree build, prelude,
  block table, control flow).

Each span counts its own time only: a span inside another (a read inside
a staging method) is taken out of the outer one.  Each direction runs 3
times; the table is the run with the least wall.  Then one more run of
each under ``torch.profiler`` gives the device's busy time (the union of
its kernel, copy and memset intervals) over that run's wall, and the
device time of each kind.

Run from the root of a checkout on a machine with an NVIDIA card:

    python3 experiments/file_path_stages.py            # this checkout
    python3 experiments/file_path_stages.py P . . P    # in turns, each in
                                                       # its own process

where ``P`` is the root of another checkout (a ``git archive`` of the
parent, unpacked in a directory that ``.gitignore`` lists).  Each process prints its table and, last,
one JSON line; with several checkouts the script prints the tables side
by side at the end.  ``--mb`` and ``--device cpu`` shrink it for a
rehearsal without a card (no device numbers then).
"""

from __future__ import annotations

import argparse
import builtins
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = ("read", "crc", "lane padding", "pinned staging", "launches",
          "kernel wait", "D2H wait", "byteswap and stitch", "sink write",
          "file write", "row gather", "other")
RUNS = 3


class Spans:
    """Seconds and calls per stage; a span's own time excludes the spans
    that ran inside it."""

    def __init__(self):
        self.seconds = defaultdict(float)
        self.calls = defaultdict(int)
        self._inner = []  # per open span: the time of the spans inside it
        self.on = False

    def wrap(self, name, fn):
        def timed(*args, **kw):
            if not self.on:
                return fn(*args, **kw)
            self._inner.append(0.0)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                dt = time.perf_counter() - t0
                inner = self._inner.pop()
                self.seconds[name] += dt - inner
                self.calls[name] += 1
                if self._inner:
                    self._inner[-1] += dt
        timed.__wrapped__ = fn
        return timed

    def take(self, wall: float) -> dict:
        out = {k: self.seconds.get(k, 0.0) for k in STAGES if k != "other"}
        out["other"] = wall - sum(out.values())
        calls = {k: self.calls.get(k, 0) for k in STAGES}
        self.seconds.clear()
        self.calls.clear()
        return {"wall": wall, "seconds": out, "calls": calls}


class TimedFile:
    """A file whose reads and writes are spans."""

    def __init__(self, fp, spans: Spans):
        self._fp = fp
        self.read = spans.wrap("read", fp.read)
        self.readinto = spans.wrap("read", fp.readinto)
        self.write = spans.wrap("file write", fp.write)

    def __getattr__(self, name):
        return getattr(self._fp, name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._fp.close()


def instrument(spans: Spans, torch) -> None:
    """Wrap what the timed checkout's file path calls."""
    from tpuhuff_torch import native
    from tpuhuff_torch.io import host, stream

    stream.open = lambda *a, **kw: TimedFile(builtins.open(*a, **kw), spans)
    native.crc32_blocks = spans.wrap("crc", native.crc32_blocks)
    host._CrcVerifier.feed = spans.wrap("crc", host._CrcVerifier.feed)
    for name, stage in (("pad_to_blocks", "lane padding"),
                        ("stitch_words", "byteswap and stitch"),
                        ("payload_to_lane_words", "row gather"),
                        ("histogram", "launches"),
                        ("encode_blocks", "launches"),
                        ("stitch_lanes", "launches"),
                        ("lane_rows", "launches")):
        if hasattr(stream, name):
            setattr(stream, name, spans.wrap(stage, getattr(stream, name)))
    decoder_for = stream.decoder_for

    def timed_decoder_for(tree):
        decode, tables = decoder_for(tree)
        return spans.wrap("launches", decode), tables

    stream.decoder_for = timed_decoder_for
    for name in ("h2d", "d2h", "read_into", "to_device", "fetch"):
        if hasattr(stream._Staging, name):
            setattr(stream._Staging, name,
                    spans.wrap("pinned staging", getattr(stream._Staging, name)))
    for name in ("write", "write_aligned"):
        if hasattr(host._BitSink, name):
            setattr(host._BitSink, name,
                    spans.wrap("sink write", getattr(host._BitSink, name)))
    torch.cuda.Event.synchronize = spans.wrap("kernel wait",
                                              torch.cuda.Event.synchronize)
    torch.cuda.Stream.synchronize = spans.wrap("D2H wait",
                                               torch.cuda.Stream.synchronize)


def device_share(torch, run) -> dict:
    """``run()`` under ``torch.profiler``: its wall, the device's busy ms
    (the union of the CUDA intervals) and the device ms by kind."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, kinds = [], defaultdict(float)
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        lo, hi = ev.time_range.start, ev.time_range.end
        spans.append((lo, hi))
        name = ev.name
        kind = ("H2D" if "HtoD" in name else "D2H" if "DtoH" in name
                else "memset" if "Memset" in name
                else "D2D" if "DtoD" in name else f"kernel {name[:40]}")
        kinds[kind] += (hi - lo) / 1e3
    busy, end = 0.0, None
    for lo, hi in sorted(spans):
        if end is None or lo > end:
            busy += hi - lo
            end = hi
        elif hi > end:
            busy += hi - end
            end = hi
    busy_ms = busy / 1e3
    return {"wall_ms": wall_ms, "busy_ms": busy_ms if spans else None,
            "busy_share": busy_ms / wall_ms if spans else None,
            "by_kind_ms": dict(sorted(kinds.items()))}


def sha(path: str) -> str:
    h = hashlib.sha256()
    with builtins.open(path, "rb") as fp:
        for piece in iter(lambda: fp.read(1 << 24), b""):
            h.update(piece)
    return h.hexdigest()


def one(checkout: str, mb: int, device: str) -> dict:
    """Time this process's file path, with ``tpuhuff_torch`` imported from
    ``checkout``."""
    import numpy as np
    import torch

    checkout = os.path.abspath(checkout)
    sys.path.insert(0, checkout)
    import tpuhuff_torch

    if os.path.dirname(os.path.dirname(tpuhuff_torch.__file__)) != checkout:
        raise SystemExit(f"tpuhuff_torch came from {tpuhuff_torch.__file__}, "
                         f"not {checkout}")
    from tpuhuff_torch.io import read_compress_write_hf2, read_decompress_write_hf2

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cuda = device == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script measures the card")
    card = "not measured (CPU rehearsal)"
    if cuda:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        card = smi.stdout.strip().splitlines()[0]
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    work = tempfile.mkdtemp(prefix="file_path_stages_")
    src = os.path.join(work, "textlike.bin")
    smoke.make_textlike(mb << 20, np).tofile(src)
    hf2, out = src + ".hf2", src + ".out"
    compress = lambda: read_compress_write_hf2(src, hf2, device=device)  # noqa: E731
    decompress = lambda: read_decompress_write_hf2(hf2, out, device=device)  # noqa: E731
    t0 = time.perf_counter()
    compress()
    decompress()
    sync()
    warm = time.perf_counter() - t0  # the kernels' build included
    if sha(out) != sha(src):
        raise SystemExit("the round trip does not restore the source")
    spans = Spans()
    instrument(spans, torch)
    runs = {"compress": [], "decompress": []}
    for _ in range(RUNS):
        for key, fn in (("compress", compress), ("decompress", decompress)):
            spans.on = True
            t0 = time.perf_counter()
            fn()
            sync()
            wall = time.perf_counter() - t0
            spans.on = False
            runs[key].append(spans.take(wall))
    if sha(out) != sha(src):
        raise SystemExit("the round trip does not restore the source")
    result = {"checkout": checkout, "card": card, "mb": mb,
              "container_bytes": os.path.getsize(hf2),
              "container_sha256": sha(hf2), "warm_s": warm}
    for key, fn in (("compress", compress), ("decompress", decompress)):
        best = min(runs[key], key=lambda r: r["wall"])
        best["walls"] = [r["wall"] for r in runs[key]]
        best["device"] = device_share(torch, fn) if cuda else None
        result[key] = best
    for name in os.listdir(work):
        os.unlink(os.path.join(work, name))
    os.rmdir(work)
    return result


def table(results: list[dict]) -> str:
    """The stage tables of ``results`` side by side, in seconds."""
    heads = [f"{os.path.basename(r['checkout']) or r['checkout']}"
             for r in results]
    lines = []
    for key in ("compress", "decompress"):
        lines.append(f"| {key} stage | " + " | ".join(heads) + " |")
        lines.append("|---" * (len(heads) + 1) + "|")
        lines.append("| wall (best of 3) | " + " | ".join(
            f"{r[key]['wall']:.4f}" for r in results) + " |")
        for stage in STAGES:
            lines.append(f"| {stage} | " + " | ".join(
                f"{r[key]['seconds'][stage]:.4f}" for r in results) + " |")
        dev = [r[key]["device"] for r in results]
        if all(d and d["busy_ms"] is not None for d in dev):
            lines.append("| device busy (profiled run) | " + " | ".join(
                f"{d['busy_ms']:.3f} ms of {d['wall_ms']:.1f} "
                f"({d['busy_share']:.2%})" for d in dev) + " |")
            kinds = sorted({k for d in dev for k in d["by_kind_ms"]})
            for kind in kinds:
                lines.append(f"| device {kind} ms | " + " | ".join(
                    f"{d['by_kind_ms'].get(kind, 0.0):.3f}" for d in dev)
                    + " |")
        lines.append("")
    return "\n".join(lines)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("checkouts", nargs="*",
                    help="roots of checkouts to time in turns, each in its "
                         "own process (default: this one, in this process)")
    ap.add_argument("--mb", type=int, default=100)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    if not args.checkouts:
        result = one(ROOT, args.mb, args.device)
        print(result["card"])
        print(table([result]))
        print(json.dumps(result), flush=True)
        return
    results = []
    for checkout in args.checkouts:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--mb", str(args.mb),
             "--device", args.device, "--one", checkout], capture_output=True,
            text=True, timeout=1800, cwd=ROOT)
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-4000:])
            raise SystemExit(f"{checkout}: exit {proc.returncode}")
        results.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    if len({r["container_sha256"] for r in results}) != 1:
        raise SystemExit("the checkouts wrote different containers")
    print(f"in turns: {' / '.join(args.checkouts)} [{results[0]['card']}]")
    print(table(results))
    print(json.dumps({"turns": results}), flush=True)


if __name__ == "__main__":
    if "--one" in sys.argv:
        i = sys.argv.index("--one")
        checkout = sys.argv.pop(i + 1)
        sys.argv.pop(i)
        ap = argparse.ArgumentParser()
        ap.add_argument("--mb", type=int, default=100)
        ap.add_argument("--device", default="cuda")
        a = ap.parse_args()
        r = one(checkout, a.mb, a.device)
        print(table([r]))
        print(json.dumps(r), flush=True)
    else:
        main()
