"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from
the root of a checkout.  Tests marked ``cuda`` need an NVIDIA card and
skip without one; whether there is one is decided in the ``card``
fixture, never while a module is imported."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return "cuda"


def candidate_spec() -> dict:
    """BENCHMARK.json's configurations with the cells of
    ``candidate_cells.json``: built, proven, and kept out of the benchmark
    for now."""
    import json

    with open(os.path.join(ROOT, "BENCHMARK.json")) as fp:
        spec = json.load(fp)
    with open(os.path.join(os.path.dirname(__file__),
                           "candidate_cells.json")) as fp:
        cand = json.load(fp)
    return {"configs": spec["configs"], "workloads": cand["workloads"],
            "end_to_end": cand["end_to_end"], "per_layer": cand["per_layer"]}


@pytest.fixture
def tiny():
    """``load_cell`` (of the benchmark or of the candidates) with every
    object cut to 64 KiB, for CPU runs."""
    import harness

    def load(name: str, size: int = 1 << 16):
        spec = candidate_spec()
        if name not in {w["name"] for w in spec["workloads"]}:
            spec = None
        cell = harness.load_cell(name, spec=spec)
        cell.traffic["object_bytes"] = size
        return cell

    return load
