"""The cell of 64 KiB blocks (``text_hf2_64k.decompress_100m``) rehearsed
on the CPU, and its reader of the decoders' route."""

import types

import pytest

import control
import harness

CELL = "text_hf2_64k.decompress_100m"
SEED = 2**31 + 91


@pytest.mark.parametrize("trace", (0, 1))
def test_a_cpu_run_of_the_cell(tiny, trace):
    """Three blocks, the last short: correct; on the CPU the port hands
    64 KiB blocks to the host decoder, so the route's share is null."""
    cell = tiny(CELL, 3 * 65536 - 1000)
    assert cell.config["container"]["block_len"] == 65536
    run = harness.run_cell(cell, SEED, 0.3, bool(trace), "cpu",
                           log=lambda *a: None)
    res = harness.result_of(run, bool(trace))
    assert res["correct"] is True and res["failed"] == 0
    if trace:
        assert "global_rows_share.decompress" in run.nulls
        assert "read_ms_per_GiB.decompress" in res["metrics"]
    else:
        assert set(res["metrics"]) == {"decompress_GBps", "setup_s"}


def test_the_unchecked_control_is_not_correct(tiny):
    """Only the CRC check, one CRC32 a 64 KiB block here, refuses the
    corrupt container: with it off the run is not correct."""
    cell = tiny(CELL, 3 * 65536 - 1000)
    run = harness.run_cell(cell, SEED, 0.2, False, "cpu",
                           system=control.Unchecked(cell.config, "cpu"),
                           log=lambda *a: None)
    assert not harness.correct(run)
    assert run.checks["corrupt_accepted"] == (1, 0)
    assert run.checks["output_bytes_differing"] == (0, 0)


def _reader():
    return harness.load_metric("global_rows_share.decompress").value


def test_the_share_reads_the_wrappers_counters(monkeypatch):
    from tpuhuff_torch.kernels import decode

    run = types.SimpleNamespace(nulls={})
    for fn, counts in ((decode.decode_rows, (1600, 1600)),
                       (decode.decode_rows_general, (0, 0))):
        monkeypatch.setattr(fn, "blocks", counts[0])
        monkeypatch.setattr(fn, "global_blocks", counts[1])
    assert _reader()(run) == 1.0
    monkeypatch.setattr(decode.decode_rows_general, "blocks", 1600)
    assert _reader()(run) == 0.5
    for fn in (decode.decode_rows, decode.decode_rows_general):
        monkeypatch.setattr(fn, "blocks", 0)
    assert _reader()(run) is None and "no block" in run.nulls["_"]
    monkeypatch.delattr(decode.decode_rows, "global_blocks")
    assert _reader()(run) is None and "lacks" in run.nulls["_"]
