"""Seeded corruption fuzz of the port's readers: the twin of
``tests/test_fuzz.py``, with its contract and its seeds.

* ``.hf2`` with the CRC column: a decode raises :class:`StreamError` or
  gives exactly the original bytes; on the host reader (blocks of 4096,
  the JAX test's) and on the device reader (``device="cpu"``, the plain
  versions of the decoders, blocks of 256);
* ``.hf2`` without it: typed errors only;
* ``.hff``: typed errors only, on the serial reader and on the parallel
  first decode that builds the sidecar;
* the ``.hf2x`` sidecar: a corrupt sidecar never reaches the output.
"""

import os

import numpy as np
import pytest

from tpuhuff_torch.io import (
    read_compress_write_hf2,
    read_decompress_write,
    read_decompress_write_hf2,
)
from tpuhuff_torch.io import host
from tpuhuff_torch.io.host import (
    StreamError,
    read_compress_write_hf2_host,
    read_compress_write_host,
)

DATA = bytes(
    np.frombuffer(
        (b"fuzzing the containers: typed errors or exact bytes, nothing "
         b"else! 0123456789" * 2000)[: 120_003],
        dtype=np.uint8,
    )
    ^ np.arange(120_003, dtype=np.uint8)  # all 256 byte values present
)


def _mutate(buf: bytes, rng: np.random.Generator) -> bytes:
    """One seeded mutation: bitflip, truncation, or random overwrite."""
    b = bytearray(buf)
    op = int(rng.integers(0, 3))
    if op == 0:  # single bitflip
        pos = int(rng.integers(0, len(b)))
        b[pos] ^= 1 << int(rng.integers(0, 8))
    elif op == 1:  # truncation (possibly to zero)
        b = b[: int(rng.integers(0, len(b)))]
    else:  # overwrite 1..16 bytes
        pos = int(rng.integers(0, len(b)))
        n = int(rng.integers(1, 17))
        b[pos : pos + n] = bytes(rng.integers(0, 256, n, dtype=np.uint8))
    return bytes(b)


def _write_hf2(src: str, dst: str, route: str, check: bool = True) -> None:
    """The host writer at 4096-byte blocks, or the device writer's plain
    versions at 256."""
    if route == "host":
        read_compress_write_hf2_host(src, dst, block_len=4096, check=check)
    else:
        read_compress_write_hf2(src, dst, device="cpu", check=check)


@pytest.mark.parametrize("route", ["host", "device"])
def test_fuzz_hf2_detects_or_exact(tmp_path, route):
    """200 seeded mutations of a checksummed .hf2: StreamError or
    byte-exact output, never silent corruption."""
    src = tmp_path / "src.bin"
    hf2 = tmp_path / "a.hf2"
    out = tmp_path / "a.out"
    src.write_bytes(DATA)
    _write_hf2(str(src), str(hf2), route)
    pristine = hf2.read_bytes()
    rng = np.random.default_rng(0xC0FFEE)
    detected = exact = 0
    for case in range(200):
        hf2.write_bytes(_mutate(pristine, rng))
        try:
            read_decompress_write_hf2(str(hf2), str(out), device="cpu")
        except StreamError:
            detected += 1
        except Exception as e:  # noqa: BLE001 - the fuzz contract itself
            pytest.fail(f"case {case}: untyped {type(e).__name__}: {e}")
        else:
            assert out.read_bytes() == DATA, (
                f"case {case}: SILENT WRONG OUTPUT on checksummed .hf2"
            )
            exact += 1
    assert detected + exact == 200
    assert detected >= 150, (detected, exact)


@pytest.mark.parametrize("route", ["host", "device"])
def test_fuzz_hf2_unchecked_still_typed(tmp_path, route):
    """check=False: wrong bytes are allowed, but errors stay typed and
    nothing crashes or hangs."""
    src = tmp_path / "src.bin"
    hf2 = tmp_path / "a.hf2"
    out = tmp_path / "a.out"
    src.write_bytes(DATA)
    _write_hf2(str(src), str(hf2), route, check=False)
    pristine = hf2.read_bytes()
    rng = np.random.default_rng(0xBEEF)
    for case in range(60):
        hf2.write_bytes(_mutate(pristine, rng))
        try:
            read_decompress_write_hf2(str(hf2), str(out), device="cpu")
        except StreamError:
            pass
        except Exception as e:  # noqa: BLE001
            pytest.fail(f"case {case}: untyped {type(e).__name__}: {e}")


def test_fuzz_hff_typed_errors_only(tmp_path):
    """.hff carries no integrity data, so only the error's type and the
    decode's end are asserted."""
    src = tmp_path / "src.bin"
    hff = tmp_path / "a.hff"
    out = tmp_path / "a.out"
    src.write_bytes(DATA)
    read_compress_write_host(str(src), str(hff))
    pristine = hff.read_bytes()
    rng = np.random.default_rng(0xFACE)
    for case in range(120):
        hff.write_bytes(_mutate(pristine, rng))
        try:
            read_decompress_write(str(hff), str(out), auto_index=False)
        except StreamError:
            pass
        except Exception as e:  # noqa: BLE001
            pytest.fail(f"case {case}: untyped {type(e).__name__}: {e}")


def test_fuzz_sidecar_never_poisons_output(tmp_path, monkeypatch):
    """A corrupt sidecar never corrupts the decoded output: the reader
    detects it (CRC column, header checks), builds it again from the
    source and returns exact bytes."""
    monkeypatch.setattr(host, "AUTO_INDEX_MIN", 1)
    src = tmp_path / "src.bin"
    hff = tmp_path / "a.hff"
    out = tmp_path / "a.out"
    src.write_bytes(DATA)
    read_compress_write_host(str(src), str(hff))
    sidecar = str(hff) + ".hf2x"
    stats: dict = {}
    read_decompress_write(str(hff), str(out), stats=stats)
    assert stats.get("auto_index") == "created" and out.read_bytes() == DATA
    pristine = open(sidecar, "rb").read()
    rng = np.random.default_rng(0xD00D)
    for case in range(40):
        with open(sidecar, "wb") as fp:
            fp.write(_mutate(pristine, rng))
        os.utime(sidecar)  # fresh by its time: the content checks must act
        try:
            read_decompress_write(str(hff), str(out))
        except StreamError as e:
            pytest.fail(f"case {case}: corrupt SIDECAR surfaced as a "
                        f"source error: {e}")
        assert out.read_bytes() == DATA, (
            f"case {case}: corrupt sidecar poisoned the output"
        )
        with open(sidecar, "wb") as fp:
            fp.write(pristine)
        os.utime(sidecar)


def test_fuzz_hff_parallel_first_decode(tmp_path, monkeypatch):
    """Mutations through the parallel first decode (spec_index, the
    threaded block decode, the sidecar build): typed errors or an end,
    never a crash or a hang."""
    monkeypatch.setattr(host, "AUTO_INDEX_MIN", 1)
    src = tmp_path / "src.bin"
    hff = tmp_path / "a.hff"
    out = tmp_path / "a.out"
    src.write_bytes(DATA)
    read_compress_write_host(str(src), str(hff))
    pristine = hff.read_bytes()
    rng = np.random.default_rng(0x5EC)
    for case in range(80):
        hff.write_bytes(_mutate(pristine, rng))
        sc = str(hff) + ".hf2x"
        if os.path.exists(sc):
            os.remove(sc)  # a fresh parallel first decode each case
        try:
            read_decompress_write(str(hff), str(out))
        except StreamError:
            pass
        except Exception as e:  # noqa: BLE001
            pytest.fail(f"case {case}: untyped {type(e).__name__}: {e}")
