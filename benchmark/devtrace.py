"""What the device did in the traced window, from ``torch.profiler``.

The profiler's trace is exported as Chrome JSON to a temporary file,
read back and deleted.  Device intervals are the kernel, copy and memset
events; the window is the harness's ``bench:window`` range.  From them:

* ``busy_s``: the union of the device intervals inside the window;
* ``kernel_s``: device seconds by kernel name (the identifier, without
  template arguments or parameters);
* ``ops``: device seconds by operation, copies named by direction;
* ``gaps``: the idle time inside the window, by what the host was doing,
  the innermost ``bench:`` range open at the time (a span of
  :mod:`spans`, the call, or the harness between calls).
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Trace:
    window_s: float
    busy_s: float | None
    kernel_s: dict = field(default_factory=dict)
    ops: dict = field(default_factory=dict)
    gaps: dict = field(default_factory=dict)
    n_device: int = 0


def short_name(name: str) -> str:
    """``void (anonymous namespace)::foo_kernel<...>(Args, int)`` ->
    ``foo_kernel``; copies and memsets keep their profiler names."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    head = name.replace("(anonymous namespace)::", "")
    head = re.split(r"[<(]", head, maxsplit=1)[0].strip()
    head = head.split()[-1] if head else ""
    return head.split("::")[-1] or name


def export(prof) -> list:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fp:
            return json.load(fp).get("traceEvents", [])
    finally:
        os.unlink(path)


def _union(intervals):
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            if hi > out[-1][1]:
                out[-1][1] = hi
        else:
            out.append([lo, hi])
    return out


def _innermost(ranges):
    """Nested host ranges -> consecutive (lo, hi, label) pieces, each
    labelled by the innermost range open over it."""
    pieces, stack = [], []
    edges = []
    for lo, hi, name in ranges:
        edges.append((lo, 1, -hi, name))
        edges.append((hi, 0, 0, name))
    edges.sort()
    last = None
    for t, opening, _, name in edges:
        if stack and last is not None and t > last:
            pieces.append((last, t, stack[-1]))
        if opening:
            stack.append(name)
        elif name in stack:
            # ranges nest; close the innermost of that name
            idx = len(stack) - 1 - stack[::-1].index(name)
            del stack[idx]
        last = t
    return pieces


def read(events: list) -> Trace | None:
    """The trace of the ``bench:window`` range; None without one."""
    window = None
    host, device = [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        lo, hi = float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])
        cat, name = ev.get("cat", ""), ev.get("name", "")
        if cat in DEVICE_CATS:
            device.append((lo, hi, name, cat))
        elif cat == "user_annotation" and name.startswith("bench:"):
            if name == "bench:window":
                window = (lo, hi)
            host.append((lo, hi, "harness, between calls"
                         if name == "bench:window" else name[len("bench:"):]))
    if window is None:
        return None
    w0, w1 = window
    inside = [(max(lo, w0), min(hi, w1), name, cat)
              for lo, hi, name, cat in device if hi > w0 and lo < w1]
    tr = Trace(window_s=(w1 - w0) / 1e6, busy_s=None, n_device=len(inside))
    if not inside:
        return tr
    busy = _union([(lo, hi) for lo, hi, _, _ in inside])
    tr.busy_s = sum(hi - lo for lo, hi in busy) / 1e6
    kernel_s, ops = defaultdict(float), defaultdict(float)
    for lo, hi, name, cat in inside:
        short = short_name(name)
        ops[short] += (hi - lo) / 1e6
        if cat == "kernel":
            kernel_s[short] += (hi - lo) / 1e6
    tr.kernel_s, tr.ops = dict(kernel_s), dict(ops)
    idle, t = [], w0
    for lo, hi in busy:
        if lo > t:
            idle.append((t, lo))
        t = max(t, hi)
    if t < w1:
        idle.append((t, w1))
    pieces = _innermost(host)
    gaps, j = defaultdict(float), 0
    for lo, hi in idle:
        while j < len(pieces) and pieces[j][1] <= lo:
            j += 1
        k = j
        covered = 0.0
        while k < len(pieces) and pieces[k][0] < hi:
            a, b = max(lo, pieces[k][0]), min(hi, pieces[k][1])
            if b > a:
                gaps[pieces[k][2]] += (b - a) / 1e6
                covered += b - a
            k += 1
        if hi - lo > covered:
            gaps["no host range"] += (hi - lo - covered) / 1e6
    tr.gaps = dict(gaps)
    return tr


def top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
