"""The benchmark's general driver: one run of one cell.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration and a
traffic mix; both are data files, found by name:

* the configuration's ``file`` (``configs/<config>.json``): the corpus
  recipe (:mod:`corpus`) and the container settings the program is called
  with;
* ``workloads/<traffic>.json``: the operation (``compress``,
  ``decompress`` or ``roundtrip``: a compress, then a decompress of its
  container), the objects' sizes and how many distinct objects the calls
  rotate over, how many calls' outputs are kept for the check, and how
  long the traced run profiles the device;
* ``metrics/<metric>.py``: one small reader per metric, end-to-end or
  per-layer, with the host spans it needs.

A run makes its objects from the seed into anonymous memory files
(``os.memfd_create``, given to the program as ``/proc/self/fd/<n>``), so
that the loop writes nothing to disk; warms up with one call of the
cell's operation; then calls the program back to back, one client in a
closed loop, for ``--seconds``.  Outputs go to a ring of the last calls'
files and to a sample of all the window's calls drawn from the seed
(reservoir sampling); once the window has closed and the device's peak
memory has been read, the plain reference (:mod:`reference`) judges them.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import mmap
import os
import struct
import sys
import time
from dataclasses import dataclass, field

import numpy as np

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "tpuhuff")
GIB = float(1 << 30)


# ------------------------------------------------------------------ the cell

@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT, spec: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``spec``)."""
    if spec is None:
        with open(os.path.join(root, "BENCHMARK.json")) as fp:
            spec = json.load(fp)
    work = next((w for w in spec["workloads"] if w["name"] == name), None)
    if work is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == work["config"])
    with open(os.path.join(root, conf["file"])) as fp:
        config = json.load(fp)
    with open(os.path.join(BENCH, "workloads", work["traffic"] + ".json")) as fp:
        traffic = json.load(fp)
    return Cell(name, work["chips"], config, traffic,
                [m for m in spec["end_to_end"] if _reports(m, name)],
                [m for m in spec["per_layer"] if _reports(m, name)])


def load_metric(name: str):
    path = os.path.join(BENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------- memory files

class MemFile:
    """An anonymous file in memory, reachable by a path."""

    def __init__(self, label: str, data: np.ndarray | bytes | None = None):
        self.fd = os.memfd_create(label)
        self.path = f"/proc/self/fd/{self.fd}"
        if data is not None:
            view = memoryview(data).cast("B")
            done = 0
            while done < len(view):
                done += os.write(self.fd, view[done:])

    def size(self) -> int:
        return os.fstat(self.fd).st_size

    def head(self, n: int) -> bytes:
        return os.pread(self.fd, n, 0)

    def array(self) -> np.ndarray:
        """The bytes, mapped (no copy)."""
        n = self.size()
        if n == 0:
            return np.zeros(0, dtype=np.uint8)
        return np.frombuffer(mmap.mmap(self.fd, n, prot=mmap.PROT_READ),
                             dtype=np.uint8)

    def close(self) -> None:
        if self.fd >= 0:
            os.close(self.fd)
            self.fd = -1


def prelude_bytes(head: bytes) -> tuple[int, int]:
    """(bytes before the payload, bytes of the block table) of a
    ``.hf2`` container from its first 31 bytes."""
    if len(head) < 27:
        return len(head), 0
    flags, width = head[4], head[5]
    tree_len, _, _, _, n_blocks = struct.unpack(">IBQII", head[6:27])
    size, table = 27 + width * n_blocks + tree_len, width * n_blocks
    if flags & 2 and len(head) >= 31:
        every = struct.unpack(">I", head[27:31])[0] or 1
        size += 4 + 4 * -(-n_blocks // every)
    return size, table


# ---------------------------------------------------------- the system

class Port:
    """The system under test: the port's file-to-file ``.hf2`` entry
    points on ``device``, called with the configuration's settings."""

    def __init__(self, config: dict, device: str):
        from tpuhuff_torch.io import (read_compress_write_hf2,
                                      read_decompress_write_hf2)

        c = config["container"]
        self._c, self._d = read_compress_write_hf2, read_decompress_write_hf2
        self.ckw = {k: c[k] for k in ("block_len", "canonical", "check",
                                      "chunk_bytes") if k in c}
        self.dkw = {k: c[k] for k in ("check", "chunk_bytes") if k in c}
        self.device = device

    def compress(self, src: str, dst: str) -> None:
        self._c(src, dst, device=self.device, **self.ckw)

    def decompress(self, src: str, dst: str) -> None:
        self._d(src, dst, device=self.device, **self.dkw)


# --------------------------------------------------------------- a run

@dataclass
class Call:
    op: str
    obj: int
    t0: float
    t1: float
    in_bytes: int
    out_bytes: int
    payload_bytes: int = 0
    table_bytes: int = 0
    ok: bool = True


@dataclass
class Run:
    cell: Cell
    device: str
    calls: list = field(default_factory=list)
    objects: list = field(default_factory=list)   # size of each object
    setup_s: float = 0.0
    window_s: float = 0.0
    memory_peak: int = 0
    spans: object = None
    trace: object = None
    traced_calls: list = field(default_factory=list)
    device_kind: str = ""
    nulls: dict = field(default_factory=dict)
    checks: dict = field(default_factory=dict)
    notes: list = field(default_factory=list)
    warm_failed: int = 0

    # helpers for the metric readers
    def of(self, op: str) -> list:
        return [c for c in self.calls if c.op == op]

    def bytes(self, op: str) -> int:
        """Bytes of the data side of ``op``'s calls: the input of a
        compress, the output of a decompress."""
        calls = self.of(op)
        return sum(c.in_bytes if op == "compress" else c.out_bytes
                   for c in calls)

    def wall(self, op: str) -> float:
        return sum(c.t1 - c.t0 for c in self.of(op))

    def span_s(self, op: str, *names: str):
        missing = [n for n in names if self.spans.missing.get(n)]
        if missing:
            return None, "the program lacks " + ", ".join(
                t for n in missing for t in self.spans.missing[n])
        if not any(self.spans.calls.get((op, n)) for n in names):
            return None, f"no {'/'.join(names)} span ran in a {op} call"
        return sum(self.spans.get(op, n) for n in names), None

    def peak_Bps(self):
        with open(os.path.join(BENCH, "peaks.json")) as fp:
            peaks = json.load(fp)
        entry = peaks.get(self.device_kind)
        return entry["hbm_bytes_per_s"] if entry else None


def _objects(cell: Cell) -> list:
    t = cell.traffic
    sizes = t["object_bytes"]
    sizes = sizes if isinstance(sizes, list) else [sizes]
    return [sizes[k % len(sizes)] for k in range(t["objects"])]


class _Keep:
    """Where each call writes: a ring of the last ``ring`` calls' files,
    and a reservoir sample of ``sample`` calls drawn from the seed."""

    def __init__(self, ring: int, sample: int, rng: np.random.Generator,
                 files: int):
        self.rng = rng
        self.files = files   # files per call: 1, or 2 for a round trip
        self.ring = [self._new() for _ in range(ring)]
        self.ring_call = [None] * ring
        self.sample = [self._new() for _ in range(sample)]
        self.sample_call = [None] * sample
        self.n = 0

    def _new(self):
        return [MemFile("bench-out") for _ in range(self.files)]

    def next(self, call_index: int):
        """The files of call ``call_index`` (calls come in order)."""
        i = self.n
        self.n += 1
        k = len(self.sample)
        if i < k:
            self.sample_call[i] = call_index
            return self.sample[i]
        j = int(self.rng.integers(0, i + 1))
        if j < k:
            self.sample_call[j] = call_index
            return self.sample[j]
        r = i % len(self.ring)
        self.ring_call[r] = call_index
        return self.ring[r]

    def kept(self):
        for files, idx in list(zip(self.sample, self.sample_call)) + list(
                zip(self.ring, self.ring_call)):
            if idx is not None:
                yield idx, files

    def close(self):
        for files in self.sample + self.ring:
            for f in files:
                f.close()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", system=None, t_start: float | None = None,
             log=None) -> Run:
    """One run of ``cell``: set-up, the window, the check.  ``system``
    replaces the port (the controls); ``t_start`` is the process's start
    on ``time.perf_counter``'s clock (set-up is counted from it)."""
    import torch

    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    t_start = time.perf_counter() if t_start is None else t_start
    cuda = device.startswith("cuda")
    run = Run(cell, device)
    run.device_kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t, c = cell.traffic, cell.config
    op = t["op"]
    system = system or Port(c, device)
    run.objects = _objects(cell)

    # set-up: the objects, the containers a decompress reads, one warm call
    import corpus
    import reference

    t_objects = time.perf_counter()

    # the containers a decompress reads are the plain reference's: its
    # seconds are the check's, not set-up's, and are taken out of setup_s
    srcs, conts, ref_s = [], [], 0.0
    for k, n in enumerate(run.objects):
        data = corpus.make(c["corpus"], n, seed, k)
        srcs.append(MemFile(f"bench-src{k}", data))
        if op == "decompress":
            t_ref = time.perf_counter()
            ref = reference.encode(data, device=device,
                                   **_ref_settings(c["container"]))
            conts.append(MemFile(f"bench-hf2-{k}", ref.prelude
                                 + ref.payload.tobytes()))
            del ref
            ref_s += time.perf_counter() - t_ref
        del data
    dec_meta = [prelude_bytes(f.head(31)) + (f.size(),) for f in conts]
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t_warm = time.perf_counter()
    scratch = [MemFile("bench-warm") for _ in range(2)]
    try:
        if op in ("compress", "roundtrip"):
            system.compress(srcs[0].path, scratch[0].path)
        if op == "roundtrip":
            system.decompress(scratch[0].path, scratch[1].path)
        if op == "decompress":
            system.decompress(conts[0].path, scratch[1].path)
        sync()
    except Exception as exc:  # counted with the window's failed calls
        run.warm_failed = 1
        run.notes.append(f"the warm call raised {type(exc).__name__}: {exc}")
    for f in scratch:
        f.close()
    log(f"set-up: {t_objects - t_start:.3f} s to the objects, "
        f"{t_warm - t_objects - ref_s:.3f} s making them, "
        f"{ref_s:.3f} s in the reference's containers (not set-up), "
        f"{time.perf_counter() - t_warm:.3f} s in the warm call")

    # the window
    rng = np.random.default_rng([int(seed) % (1 << 64), 7])
    keep = _Keep(t["ring"], t["sample"], rng, 2 if op == "roundtrip" else 1)
    spans = prof = stopped = None
    trace_s = min(float(t.get("trace_seconds", seconds)), seconds)
    if trace:
        import spans as spans_mod
        from torch.profiler import ProfilerActivity, profile

        spans = spans_mod.Spans()
        targets: dict = {}
        for m in cell.per_layer:
            for name, items in getattr(load_metric(m["name"]), "SPANS",
                                       {}).items():
                targets.setdefault(name, [])
                targets[name] += [x for x in items if x not in targets[name]]
        spans.install(targets)
        spans.annotate = cuda
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=acts)
        prof.__enter__()
        window_rf = torch.profiler.record_function("bench:window")
        window_rf.__enter__()
    run.spans = spans
    run.setup_s = time.perf_counter() - t_start - ref_s
    i = 0
    w0 = time.perf_counter()
    while True:
        k = i % len(run.objects)
        files = keep.next(i)
        if spans is not None:
            spans.on = True
        if op == "roundtrip":
            _call(run, system, spans, "compress", k, srcs[k].path,
                  files[0].path, files[0], dec_meta, i)
            _call(run, system, spans, "decompress", k, files[0].path,
                  files[1].path, files[0], [], i)
        else:
            src = srcs[k].path if op == "compress" else conts[k].path
            _call(run, system, spans, op, k, src, files[0].path,
                  files[0], dec_meta, i)
        if spans is not None:
            spans.on = False
        i += 1
        now = run.calls[-1].t1
        if prof is not None and now - w0 >= trace_s:
            stopped = _stop_trace(run, prof, window_rf, sync)
            prof = None
        if now - w0 >= seconds:
            break
    run.window_s = run.calls[-1].t1 - run.calls[0].t0
    walls = sorted((c.t1 - c.t0) * 1e3 for c in run.calls)
    log(f"window: {len(run.calls)} calls in {run.window_s:.3f} s, call ms "
        f"min {walls[0]:.2f} median {walls[len(walls) // 2]:.2f} "
        f"max {walls[-1]:.2f}")
    if prof is not None:
        stopped = _stop_trace(run, prof, window_rf, sync)
    if spans is not None:
        spans.uninstall()
    if cuda:
        run.memory_peak = int(torch.cuda.max_memory_allocated())
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if stopped is not None:
        import devtrace

        t0 = time.perf_counter()
        run.trace = devtrace.read(devtrace.export(stopped))
        log(f"trace: {run.trace.n_device if run.trace else 0} device events "
            f"read in {time.perf_counter() - t0:.3f} s")
        del stopped

    # the check, once the program's state is gone
    judge(run, srcs, conts, keep, system, seed, log)
    keep.close()
    for f in srcs + conts:
        f.close()
    return run


def _stop_trace(run: Run, prof, window_rf, sync):
    import warnings

    window_rf.__exit__(None, None, None)
    sync()
    with warnings.catch_warnings():  # "Profiler clears events at the end
        warnings.simplefilter("ignore")  # of each cycle": there is one
        prof.__exit__(None, None, None)
    run.traced_calls = list(run.calls)
    return prof


def _ref_settings(container: dict) -> dict:
    return {k: container[k] for k in ("block_len", "canonical", "check")
            if k in container}


def _call(run, system, spans, kind, k, src, dst, out, dec_meta, i):
    """One call of the program, timed, with its bookkeeping; ``out`` is
    the container file (written by a compress, read by a decompress)."""
    rf = None
    if spans is not None:
        spans.op = kind
        if spans.annotate:  # labels the device's idle time inside the call
            import torch

            rf = torch.profiler.record_function(f"bench:{kind} call")
            rf.__enter__()
    ok = True
    t0 = time.perf_counter()
    try:
        (system.compress if kind == "compress" else system.decompress)(src, dst)
    except Exception as exc:  # a failed call is counted, not fatal
        ok = False
        run.notes.append(f"call {i} ({kind}) raised {type(exc).__name__}: {exc}")
    t1 = time.perf_counter()
    if rf is not None:
        rf.__exit__(None, None, None)
    n = run.objects[k]
    if dec_meta:
        pre, table, size = dec_meta[k]
    else:
        size = out.size()
        pre, table = prelude_bytes(out.head(31))
    if kind == "compress":
        run.calls.append(Call(kind, k, t0, t1, n, size, size - pre, table, ok))
    else:
        run.calls.append(Call(kind, k, t0, t1, size, n, size - pre, table, ok))


# ---------------------------------------------------------------- the check

def _differing(got: np.ndarray, want: np.ndarray) -> int:
    n = min(got.size, want.size)
    return int(np.count_nonzero(got[:n] != want[:n])) + abs(got.size - want.size)


def corrupt_accepted(system, container: MemFile, seed: int) -> int:
    """1 if ``system`` decompresses a copy of ``container`` with one
    payload byte flipped, a byte drawn from the seed, without raising
    ``CorruptData``; 0 if it refuses it.  The container's CRC column
    covers every decoded byte, and a flipped payload bit always changes
    its block's bytes, so a decompress that verifies the column refuses
    the copy."""
    data = container.array().copy()
    start = prelude_bytes(container.head(31))[0]
    if data.size - 1 <= start:
        return 1  # no payload to corrupt: the check is not shown
    rng = np.random.default_rng([int(seed) % (1 << 64), 11])
    # short of the last byte, whose low bits may be padding
    data[int(rng.integers(start, data.size - 1))] ^= 0x20
    bad, out = MemFile("bench-corrupt", data), MemFile("bench-corrupt-out")
    try:
        system.decompress(bad.path, out.path)
        return 1
    except Exception as exc:
        return 0 if getattr(exc, "kind", None) == "CorruptData" else 1
    finally:
        bad.close()
        out.close()


def judge(run: Run, srcs: list, conts: list, keep: _Keep, system, seed: int,
          log) -> None:
    """Hold the kept calls' outputs against the plain reference: each
    container byte for byte against the one the reference works out from
    the same input, each decoded file against its input; and have the
    program decompress one container with a byte flipped, which its CRC
    check has to refuse.  Every number compared goes into ``run.checks``
    as ``(value, limit)``."""
    import reference

    device = run.device
    op = run.cell.traffic["op"]
    settings = _ref_settings(run.cell.config["container"])
    refs: dict = {}
    diff_c = diff_o = kept = 0
    t0 = time.perf_counter()
    for idx, files in keep.kept():
        k = idx % len(run.objects)
        kept += 1
        if op in ("compress", "roundtrip"):
            if k not in refs:
                refs[k] = reference.encode(srcs[k].array(), device=device,
                                           **settings)
            diff_c += reference.differing_bytes(files[0].array(), refs[k])
        if op in ("decompress", "roundtrip"):
            out = files[1] if op == "roundtrip" else files[0]
            diff_o += _differing(out.array(), srcs[k].array())
    if op == "decompress":
        corrupt = corrupt_accepted(system, conts[0], seed)
    elif op == "roundtrip":
        corrupt = next((corrupt_accepted(system, files[0], seed)
                        for _, files in keep.kept()), 1)
    log(f"check: {kept} of {len(run.calls)} calls' outputs held against the "
        f"plain reference in {time.perf_counter() - t0:.3f} s")
    failed = sum(not c.ok for c in run.calls) + run.warm_failed
    run.checks["calls_failed"] = (failed, 0)
    if op in ("compress", "roundtrip"):
        run.checks["container_bytes_differing"] = (diff_c, 0)
    if op in ("decompress", "roundtrip"):
        run.checks["output_bytes_differing"] = (diff_o, 0)
        run.checks["corrupt_accepted"] = (corrupt, 0)


def correct(run: Run) -> bool:
    return all(v <= lim for v, lim in run.checks.values())


# ------------------------------------------------------------- the metrics

def evaluate(run: Run, metrics: list) -> dict:
    """``{name: {"value", "unit"}}`` of the metrics that could be read; a
    reader that finds nothing returns None and says why in ``run.nulls``."""
    out = {}
    for m in metrics:
        run.nulls.pop("_", None)
        value = load_metric(m["name"]).value(run)
        if value is None:
            run.nulls[m["name"]] = run.nulls.pop("_", "the reader found nothing")
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def null(run: Run, reason: str):
    """For a metric reader: no value, and why."""
    run.nulls["_"] = reason
    return None


def percentile(values: list, q: float) -> float:
    """The nearest-rank ``q``-th percentile."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100 * len(s)) - 1)]


def ms_per_gib(run: Run, op: str, *spans: str):
    """Own seconds of ``spans`` in ``op`` calls, in ms per GiB of the
    calls' data (a compress's input, a decompress's output)."""
    s, why = run.span_s(op, *spans)
    if s is None:
        return null(run, why)
    return s * 1e3 / (run.bytes(op) / GIB)


def roofline(run: Run, op: str, kernels: tuple, bytes_of) -> float | None:
    """Bytes that ``op``'s traced calls need moved (``bytes_of(call)``),
    at the card's published bandwidth, over the device time of
    ``kernels``: a percentage of the roofline."""
    tr = run.trace
    if tr is None or tr.busy_s is None:
        return null(run, "the profiler shows no device time")
    got = {k: tr.kernel_s[k] for k in kernels if k in tr.kernel_s}
    if not got:
        return null(run, f"none of {', '.join(kernels)} ran in the trace")
    peak = run.peak_Bps()
    if peak is None:
        return null(run, f"no published peak for {run.device_kind!r}")
    need = sum(bytes_of(c) for c in run.traced_calls if c.op == op)
    return 100.0 * need / peak / sum(got.values())


def idle_pct(run: Run):
    tr = run.trace
    if tr is None or tr.busy_s is None:
        return null(run, "the profiler shows no device time")
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


# ------------------------------------------------------------------- main

def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def _power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def result_of(run: Run, trace: bool) -> dict:
    cell = run.cell
    metrics = evaluate(run, cell.per_layer if trace else cell.end_to_end)
    pairs = run.cell.traffic["op"] == "roundtrip"  # one object, two calls
    attempted = len(run.calls) // 2 if pairs else len(run.calls)
    failed = sum(not c.ok for c in run.calls)
    res = {"correct": correct(run), "attempted": attempted,
           "failed": min(failed, attempted), "metrics": metrics,
           "device": {"platform": "gpu" if run.device.startswith("cuda")
                      else run.device, "kind": run.device_kind,
                      "count": cell.chips, "memory_peak_bytes": run.memory_peak}}
    if trace and run.trace is not None:
        import devtrace

        res["device"]["busy_s"] = run.trace.busy_s or 0.0
        res["device"]["window_s"] = run.trace.window_s
        res["breakdown"] = {"device_ops": devtrace.top(run.trace.ops),
                            "idle_gaps": devtrace.top(run.trace.gaps)}
    res["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in run.checks.items()}
    return res


def main(argv=None, t_start: float | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    log = lambda *a: print(*a, file=sys.stderr, flush=True)  # noqa: E731
    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    run = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   t_start=t_start, log=log)
    res = result_of(run, bool(args.trace))
    found = forbidden_modules()
    if found:
        log("the run loaded " + ", ".join(found) + ": the benchmark must "
            "import neither JAX nor the JAX package")
        return 3
    log(f"card: {_power_limit()}")
    if args.trace:
        log(f"rooflines are shares of the published {run.peak_Bps()} B/s")
    for note in run.notes[:20]:
        log(note)
    for name, why in run.nulls.items():
        log(f"{name}: null ({why})")
    for name, (v, lim) in run.checks.items():
        log(f"check {name}: {v} (limit {lim})")
    print(json.dumps(res), flush=True)
    return 0
