"""Per-stage timing and the device trace of the port's command line.

Every pipeline stage (``histogram``, ``pack``, ``write``, ...) can record
into a :class:`StageTimer`, which reports a table with each stage's rate
(the same table as :class:`tpuhuff.profiling.StageTimer`);
:func:`device_trace` wraps a region in a ``torch.profiler`` trace, written
as a Chrome trace into a directory when one is given.  Nothing here
imports torch unless a trace is asked for.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

__all__ = ["StageTimer", "device_trace", "TRACE_FILE"]

TRACE_FILE = "trace.json"  # the Chrome trace's name inside the trace directory


@dataclass
class _Stage:
    seconds: float = 0.0
    bytes: int = 0
    calls: int = 0


@dataclass
class StageTimer:
    """Accumulates wall time and byte volume per named stage."""

    stages: Dict[str, _Stage] = field(default_factory=dict)
    order: List[str] = field(default_factory=list)

    @contextlib.contextmanager
    def stage(self, name: str, nbytes: int = 0) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            s = self.stages.get(name)
            if s is None:
                s = self.stages[name] = _Stage()
                self.order.append(name)
            s.seconds += dt
            s.bytes += nbytes
            s.calls += 1

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
