"""The port's ``StageTimer`` and ``device_trace`` against
``tpuhuff.profiling``: the same recorded stages give the same report."""

import json
import os
import subprocess
import sys

import pytest

from tpuhuff.profiling import StageTimer as JaxTimer

from tpuhuff_torch.profiling import TRACE_FILE, StageTimer, device_trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STAGES = [("histogram", 1.25e-3, 100_000), ("pack", 0.5, 1 << 30),
          ("write", 0.0, 0), ("pack", 2e-4, 0), ("stitch", 1e-9, 7)]


def _record(timer, stages):
    """Record ``stages`` (name, seconds, bytes) into ``timer``, each
    stage's time then set to the sum of its seconds, so that both timers
    hold the same numbers."""
    seconds = {}
    for name, dt, nbytes in stages:
        with timer.stage(name, nbytes):
            pass
        seconds[name] = seconds.get(name, 0.0) + dt
    for name, dt in seconds.items():
        timer.stages[name].seconds = dt


@pytest.mark.parametrize("n", [0, 1, 3, len(STAGES)])
def test_report_matches_jax(n):
    port, jax = StageTimer(), JaxTimer()
    _record(port, STAGES[:n])
    _record(jax, STAGES[:n])
    assert port.order == jax.order
    assert port.report() == jax.report()


def test_stage_records_time_bytes_and_calls():
    timer = StageTimer()
    for _ in range(3):
        with timer.stage("pack", 10):
            pass
    with pytest.raises(KeyError):
        with timer.stage("write", 5):
            raise KeyError("inside")
    assert timer.order == ["pack", "write"]
    assert (timer.stages["pack"].bytes, timer.stages["pack"].calls) == (30, 3)
    assert timer.stages["write"].calls == 1  # recorded on the way out
    assert timer.report().splitlines()[-1].startswith("total")


def test_device_trace_without_dir_imports_no_torch():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from tpuhuff_torch.profiling import device_trace\n"
        "for d in (None, ''):\n"
        "    with device_trace(d):\n"
        "        pass\n"
        "assert 'torch' not in sys.modules\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_device_trace_writes_a_chrome_trace(tmp_path):
    import torch

    trace_dir = tmp_path / "trace"
    with device_trace(str(trace_dir)):
        torch.ones(64).add_(1)
    trace = json.loads((trace_dir / TRACE_FILE).read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("add" in n for n in names), sorted(names)[:20]
