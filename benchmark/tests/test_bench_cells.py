"""Each cell rehearsed on the CPU at a tiny size, through the kernels'
plain versions: the whole run, its metrics, its control, and the faults
that the check must catch."""

import numpy as np
import pytest

import control
import harness

CELLS = ("text_hf2.compress_100m", "text_hf2.decompress_100m",
         "mixed_hf2.compress_1g", "text_hf2.roundtrip_1m")
SEED = 2**31 + 77


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", (0, 1))
def test_a_cpu_run(tiny, name, trace):
    cell = tiny(name)
    run = harness.run_cell(cell, SEED, 0.3, bool(trace), "cpu",
                           log=lambda *a: None)
    res = harness.result_of(run, bool(trace))
    assert res["correct"] is True and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert all(c["value"] == 0 and c["limit"] == 0
               for c in res["checks"].values())
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    got = set(res["metrics"])
    # on the CPU nothing is traced on a device and nothing waits for one
    device_only = {n for n in want if "roofline" in n or "idle" in n
                   or n.startswith("wait_")}
    assert got == want - device_only
    assert set(run.nulls) == device_only
    assert all(v["value"] > 0 for v in res["metrics"].values())


@pytest.mark.parametrize("name,kind", [(n, "code") for n in CELLS] + [
    ("text_hf2.decompress_100m", "unchecked"),
    ("text_hf2.roundtrip_1m", "unchecked")])
def test_the_control_is_not_correct(tiny, name, kind):
    cell = tiny(name, 1 << 17)
    run = harness.run_cell(cell, SEED, 0.2, False, "cpu",
                           system=control.CONTROLS[kind](cell.config, "cpu"),
                           log=lambda *a: None)
    assert not harness.correct(run)
    assert max(v for v, _ in run.checks.values()) > 0
    if kind == "unchecked":  # only the CRC check catches it
        assert run.checks["corrupt_accepted"] == (1, 0)
        assert run.checks["output_bytes_differing"] == (0, 0)


class Fault(harness.Port):
    """The port with a fault planted where its answer is produced."""

    def __init__(self, config, kind, ops):
        super().__init__(config, "cpu")
        self.kind, self.ops = kind, ops

    def _after(self, dst):
        data = np.fromfile(dst, dtype=np.uint8)
        if self.kind == "altered":   # one bit of the answer flipped
            data[data.size // 2] ^= 0x10
        elif self.kind == "half":    # the second half of the answer dropped
            data = data[: data.size // 2]
        data.tofile(dst)

    def compress(self, src, dst):
        if self.kind == "unchanged" and "compress" in self.ops:
            return  # the output is left as it was
        super().compress(src, dst)
        if "compress" in self.ops:
            self._after(dst)

    def decompress(self, src, dst):
        if self.kind == "unchanged" and "decompress" in self.ops:
            return
        super().decompress(src, dst)
        if "decompress" in self.ops:
            self._after(dst)


@pytest.mark.parametrize("kind", ("unchanged", "half", "altered"))
@pytest.mark.parametrize("name,ops", [
    ("text_hf2.compress_100m", ("compress",)),
    ("text_hf2.decompress_100m", ("decompress",)),
    ("mixed_hf2.compress_1g", ("compress",)),
    ("text_hf2.roundtrip_1m", ("compress",)),
    ("text_hf2.roundtrip_1m", ("decompress",)),
])
def test_a_fault_is_not_correct(tiny, name, ops, kind):
    cell = tiny(name)
    run = harness.run_cell(cell, SEED, 0.2, False, "cpu",
                           system=Fault(cell.config, kind, ops),
                           log=lambda *a: None)
    assert not harness.correct(run), run.checks
