"""What the benchmark's processes import, and how the real command fails
where there is no card."""

import json
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "tpuhuff")


def _modules(code: str) -> set:
    """Top-level names of the modules a fresh interpreter holds after
    ``code``."""
    script = (f"import sys; sys.path[:0] = [{BENCH!r}, {ROOT!r}]\n{code}\n"
              "import json; print(json.dumps(sorted({m.split('.')[0] "
              "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_names_are_compared_whole():
    # the port's name begins with the JAX package's
    assert "tpuhuff_torch".split(".")[0] not in FORBIDDEN


def test_the_harness_imports_no_jax():
    metrics = sorted(f[:-3] for f in os.listdir(os.path.join(BENCH, "metrics"))
                     if f.endswith(".py"))
    code = ("import harness, reference, corpus, spans, devtrace, control\n"
            "from tpuhuff_torch.io import read_compress_write_hf2\n"
            f"for m in {metrics!r}: harness.load_metric(m)\n")
    assert not _modules(code) & set(FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    found = _modules("import reference, corpus")
    assert not found & set(FORBIDDEN + ("tpuhuff_torch",))


def test_a_whole_cpu_run_imports_no_jax():
    code = ("import harness\n"
            "cell = harness.load_cell('text_hf2.compress_100m')\n"
            "cell.traffic['object_bytes'] = 1 << 14\n"
            "run = harness.run_cell(cell, 5, 0.2, True, 'cpu', "
            "log=lambda *a: None)\n"
            "assert harness.correct(run)\n"
            "assert not harness.forbidden_modules()\n")
    assert not _modules(code) & set(FORBIDDEN)


def test_without_a_card_the_command_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    out = subprocess.run(spec["command"] + [
        "--workload", spec["workloads"][0]["name"], "--seed", "1",
        "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
        timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert not out.stdout.strip()
    assert "CUDA" in out.stderr
