"""On the card: one short run of each cell through the real command, which
must end correct with every metric of its kind.  Run there with
``python -m pytest benchmark/tests -q -m cuda``."""

import json
import os
import subprocess

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
@pytest.mark.parametrize("trace", (0, 1))
def test_a_short_run_on_the_card(card, cell, trace):
    out = subprocess.run(SPEC["command"] + [
        "--workload", cell, "--seed", str(2**31 + 3), "--seconds", "2",
        "--trace", str(trace)], capture_output=True, text=True, timeout=1200,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in SPEC[kind]
            if cell in m.get("workloads", [cell])}
    assert set(res["metrics"]) == want
