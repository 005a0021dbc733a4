"""Median (nearest rank) of the round-trip samples of
``roundtrip_p95_ms``, in ms: a steadier view of the same calls."""

import importlib.util
import os

from harness import percentile

_spec = importlib.util.spec_from_file_location(
    "bench_metric_roundtrip_p95_ms",
    os.path.join(os.path.dirname(__file__), "roundtrip_p95_ms.py"))
_p95 = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_p95)


def value(run):
    return percentile(_p95.samples(run), 50)
