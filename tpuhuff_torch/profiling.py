"""The port's tracer: spans with their own time, counters and per-call
records, and the device trace of the command line.

A :class:`StageTimer` records named spans (``read``, ``tree``, ``launch``,
...).  Spans nest, and each keeps its *own* time: its wall time less the
part its child spans cover, so the spans of a file call add up to its
wall time.  A span's totals are kept per name (own seconds, bytes,
calls), and :meth:`StageTimer.report` prints them as the table of
:class:`tpuhuff.profiling.StageTimer`.  :meth:`StageTimer.count` adds to a
named counter.  Each file call of :mod:`tpuhuff_torch.io.stream` opens a
root span, ``compress`` or ``decompress``; when it closes, the timer keeps
a :class:`CallRecord` of that call alone.  While a ``torch.profiler``
records, every span is also a ``record_function`` range
``tpuhuff:<name>``, on the profiler's clock, beside the device's kernels
and copies.

The program records into the tracer made active by :func:`tracing`, for
the calls made on that thread.  With none active, each site costs one
``is None`` test: no clock read, no write, no ``record_function``.
:func:`device_trace` wraps a region in a ``torch.profiler`` trace, written
as a Chrome trace into a directory when one is given.  Nothing here
imports torch unless a trace is asked for.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

__all__ = ["StageTimer", "CallRecord", "tracing", "active", "span", "call",
           "count", "TracedFile", "device_trace", "TRACE_FILE"]

TRACE_FILE = "trace.json"  # the Chrome trace's name inside the trace directory
RANGE_PREFIX = "tpuhuff:"  # the profiler ranges of annotated spans

_clock = time.perf_counter
_NULL = contextlib.nullcontext()


@dataclass
class _Stage:
    seconds: float = 0.0  # own time
    bytes: int = 0
    calls: int = 0


@dataclass
class _Count:
    n: int = 0
    calls: int = 0


@dataclass
class CallRecord:
    """One file call: its ``op`` (the root span's name), its ``id`` within
    the timer, its wall time, the own time, bytes and calls of each span
    in it (the root's own time under ``op``), its counters, and the name
    of the exception it raised, if any."""

    id: int
    op: str
    wall_s: float = 0.0
    spans: Dict[str, _Stage] = field(default_factory=dict)
    counters: Dict[str, _Count] = field(default_factory=dict)
    error: Optional[str] = None


def _add(table: dict, name: str, seconds: float, nbytes: int) -> bool:
    """Add one span's own time into ``table``; True if the name is new."""
    s = table.get(name)
    new = s is None
    if new:
        s = table[name] = _Stage()
    s.seconds += seconds
    s.bytes += nbytes
    s.calls += 1
    return new


@dataclass
class StageTimer:
    """Accumulates own time and byte volume per named span, counters, and
    one :class:`CallRecord` per file call."""

    stages: Dict[str, _Stage] = field(default_factory=dict)
    order: List[str] = field(default_factory=list)
    counters: Dict[str, _Count] = field(default_factory=dict, init=False)
    records: List[CallRecord] = field(default_factory=list, init=False)
    # the open spans' child seconds, innermost last; the open call
    _inner: List[float] = field(default_factory=list, init=False, repr=False)
    _call: Optional[CallRecord] = field(default=None, init=False, repr=False)
    # whether the outermost open span found a profiler recording
    _annotate: bool = field(default=False, init=False, repr=False)

    # a span's clock readings enclose its profiler range, so that the
    # range's cost is the span's own time and not its parent's
    def _begin(self, name: str):
        if not self._inner:
            self._annotate = _profiler_recording()
        self._inner.append(0.0)
        t0 = _clock()
        rf = None
        if self._annotate:
            import torch.profiler

            rf = torch.profiler.record_function(RANGE_PREFIX + name)
            rf.__enter__()
        return rf, t0

    def _end(self, name: str, begun, nbytes: int) -> None:
        rf, t0 = begun
        if rf is not None:
            rf.__exit__(None, None, None)
        dt = _clock() - t0
        own = dt - self._inner.pop()
        if self._inner:
            self._inner[-1] += dt
        if _add(self.stages, name, own, nbytes):
            self.order.append(name)
        if self._call is not None:
            _add(self._call.spans, name, own, nbytes)

    @contextlib.contextmanager
    def stage(self, name: str, nbytes: int = 0) -> Iterator[None]:
        """A span: its own time, ``nbytes`` and one call go to ``name``."""
        begun = self._begin(name)
        try:
            yield
        finally:
            self._end(name, begun, nbytes)

    @contextlib.contextmanager
    def call(self, op: str) -> Iterator[None]:
        """The root span of one file call, kept as a :class:`CallRecord`
        when it closes; inside another call it is a span of that one."""
        if self._call is not None:
            with self.stage(op):
                yield
            return
        rec = self._call = CallRecord(len(self.records), op)
        t0 = _clock()
        try:
            with self.stage(op):
                yield
        except BaseException as exc:
            rec.error = type(exc).__name__
            raise
        finally:
            rec.wall_s = _clock() - t0
            self._call = None
            self.records.append(rec)

    def count(self, name: str, n: int) -> None:
        """Add ``n`` to the counter ``name`` (and one to its calls)."""
        for table in (self.counters,
                      None if self._call is None else self._call.counters):
            if table is not None:
                c = table.get(name)
                if c is None:
                    c = table[name] = _Count()
                c.n += int(n)
                c.calls += 1

    def report(self) -> str:
        lines = [f"{'stage':<12} {'time':>9} {'bytes':>12} {'GB/s':>8} {'calls':>6}"]
        total = 0.0
        for name in self.order:
            s = self.stages[name]
            total += s.seconds
            gbps = s.bytes / s.seconds / 1e9 if s.seconds and s.bytes else 0.0
            lines.append(
                f"{name:<12} {s.seconds*1e3:8.1f}ms {s.bytes:>12} "
                f"{gbps:8.2f} {s.calls:>6}"
            )
        lines.append(f"{'total':<12} {total*1e3:8.1f}ms")
        return "\n".join(lines)


def _profiler_recording() -> bool:
    """Whether a ``torch.profiler`` records on this process; False, with
    no import, where torch is not loaded."""
    prof = sys.modules.get("torch.autograd.profiler")
    return bool(getattr(prof, "_is_profiler_enabled", False))


class _Active(threading.local):
    timer: Optional[StageTimer] = None


_active = _Active()


@contextlib.contextmanager
def tracing(timer: Optional[StageTimer]) -> Iterator[Optional[StageTimer]]:
    """Make ``timer`` the active tracer of this thread's calls (None: no
    tracer) until the block ends."""
    prev, _active.timer = _active.timer, timer
    try:
        yield timer
    finally:
        _active.timer = prev


def active() -> Optional[StageTimer]:
    """This thread's active tracer, or None."""
    return _active.timer


def span(name: str, nbytes: int = 0):
    """A span of the active tracer (a no-op context without one)."""
    t = _active.timer
    return _NULL if t is None else t.stage(name, nbytes)


def call(op: str):
    """The root span of a file call on the active tracer (a no-op
    context without one)."""
    t = _active.timer
    return _NULL if t is None else t.call(op)


def count(name: str, n: int) -> None:
    """Add ``n`` to the active tracer's counter ``name``, if there is one."""
    t = _active.timer
    if t is not None:
        t.count(name, n)


class TracedFile:
    """A file whose reads and writes are ``read`` and ``write`` spans of
    ``timer``, with the bytes they moved; its close is a span of ``kind``
    (a writer's close flushes)."""

    def __init__(self, fp, timer: StageTimer, kind: str):
        self._fp, self._timer, self._kind = fp, timer, kind

    def read(self, n: int = -1) -> bytes:
        begun, data = self._timer._begin("read"), b""
        try:
            data = self._fp.read(n)
        finally:
            self._timer._end("read", begun, len(data))
        return data

    def readinto(self, buf) -> Optional[int]:
        begun, got = self._timer._begin("read"), 0
        try:
            got = self._fp.readinto(buf) or 0
        finally:
            self._timer._end("read", begun, got)
        return got

    def write(self, data) -> int:
        begun, n = self._timer._begin("write"), 0
        try:
            n = self._fp.write(data)
        finally:
            self._timer._end("write", begun, n)
        return n

    def __getattr__(self, name):
        return getattr(self._fp, name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        with self._timer.stage(self._kind):
            self._fp.close()


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str]) -> Iterator[None]:
    """A ``torch.profiler`` region of CPU activity, and of CUDA activity
    where a card is present, written to ``<trace_dir>/trace.json`` as a
    Chrome trace; without ``trace_dir``, nothing."""
    if not trace_dir:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))
