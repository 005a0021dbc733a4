"""The harness's external spans wrap private names of the program; every
metric's ``SPANS`` target must still resolve, so that no per-layer
metric reads as ``missing``."""

import os

import harness
import spans as spans_mod


def test_every_external_span_target_still_resolves():
    names = sorted(f[:-3] for f in os.listdir(os.path.join(harness.BENCH,
                                                           "metrics"))
                   if f.endswith(".py"))
    targets: dict = {}
    for name in names:
        for span, items in getattr(harness.load_metric(name), "SPANS",
                                   {}).items():
            targets.setdefault(span, [])
            targets[span] += [t for t in items if t not in targets[span]]
    assert sum(len(v) for v in targets.values()) >= 20
    spans = spans_mod.Spans()
    try:
        spans.install(targets)
        assert dict(spans.missing) == {}
    finally:
        spans.uninstall()
