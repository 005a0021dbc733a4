"""Host spans put around the program's functions from outside.

A per-layer metric lists the functions it times as targets, each a module
and an attribute path: ``"tpuhuff_torch.io.stream:build_tree_for_device"``,
``"tpuhuff_torch.io.stream:_Staging.read_into"``, or, for the methods of
the files a module opens, ``"tpuhuff_torch.io.stream:open().readinto"``.
Each target is wrapped in a span named by the metric.  A span counts its
own time only: the time of a span that runs inside it is taken out, so the
spans of one call add up to at most its wall.  Spans are kept per
operation (compress, decompress) in memory.  When ``annotate`` is set,
each span is also a ``torch.profiler.record_function`` range
``bench:<name>``, so that the device trace can say what the host was doing
while the device was idle.

(Adapted from ``experiments/file_path_stages.py``'s ``Spans`` and
``TimedFile``.)
"""

from __future__ import annotations

import builtins
import functools
import importlib
import time
from collections import defaultdict


class Spans:
    def __init__(self):
        self.seconds = defaultdict(float)   # (op, span) -> own seconds
        self.calls = defaultdict(int)
        self.missing: dict[str, list[str]] = defaultdict(list)
        self.op = None
        self.on = False
        self.annotate = False
        self._inner: list[float] = []
        self._undo: list = []

    def wrap(self, name: str, fn):
        spans = self

        def timed(*args, **kw):
            if not spans.on:
                return fn(*args, **kw)
            rf = None
            if spans.annotate:
                import torch

                rf = torch.profiler.record_function("bench:" + name)
                rf.__enter__()
            spans._inner.append(0.0)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                dt = time.perf_counter() - t0
                inner = spans._inner.pop()
                spans.seconds[(spans.op, name)] += dt - inner
                spans.calls[(spans.op, name)] += 1
                if spans._inner:
                    spans._inner[-1] += dt
                if rf is not None:
                    rf.__exit__(None, None, None)

        # keep the function's attributes (a wrapper's ``launches`` counter
        # is updated through its module's global name)
        functools.update_wrapper(timed, fn)
        return timed

    def install(self, targets: dict[str, list[str]]) -> None:
        """Wrap every target of ``{span: [target, ...]}``; a target that
        the program no longer has is recorded in ``missing``."""
        files: dict[str, dict[str, str]] = defaultdict(dict)
        for name, items in targets.items():
            for target in items:
                mod_name, _, path = target.partition(":")
                try:
                    mod = importlib.import_module(mod_name)
                except ImportError:
                    self.missing[name].append(target)
                    continue
                if path.startswith("open()."):
                    files[mod_name][path[len("open()."):]] = name
                    continue
                *owners, attr = path.split(".")
                owner = mod
                for part in owners:
                    owner = getattr(owner, part, None)
                if owner is None or not hasattr(owner, attr):
                    self.missing[name].append(target)
                    continue
                old = getattr(owner, attr)
                # a method looked up on its class comes back unbound: wrap
                # the function as it sits in the class's namespace
                raw = vars(owner).get(attr, old) if isinstance(owner, type) else old
                setattr(owner, attr, self.wrap(name, raw))
                self._undo.append((owner, attr, raw))
        for mod_name, methods in files.items():
            mod = importlib.import_module(mod_name)
            self._undo.append((mod, "open", vars(mod).get("open", _ABSENT)))
            mod.open = self._opener(methods)

    def _opener(self, methods: dict[str, str]):
        spans = self

        def opener(*args, **kw):
            return _TimedFile(builtins.open(*args, **kw), spans, methods)

        return opener

    def uninstall(self) -> None:
        for owner, attr, old in reversed(self._undo):
            if old is _ABSENT:
                delattr(owner, attr)
            else:
                setattr(owner, attr, old)
        self._undo.clear()

    def total(self, op: str) -> float:
        return sum(s for (o, _), s in self.seconds.items() if o == op)

    def get(self, op: str, name: str) -> float:
        return self.seconds.get((op, name), 0.0)


_ABSENT = object()


class _TimedFile:
    """A file whose listed methods are spans."""

    def __init__(self, fp, spans: Spans, methods: dict[str, str]):
        self._fp = fp
        for method, name in methods.items():
            setattr(self, method, spans.wrap(name, getattr(fp, method)))

    def __getattr__(self, name):
        return getattr(self._fp, name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._fp.close()
