"""The port's multi-process file codec (``tpuhuff_torch.dist.multihost``):
2 and 3 processes in a gloo group on the CPU, against the JAX package's
single-process ``.hf2`` writer, and the CRC helpers it folds with.

Each child has a timeout of its own, so a hang fails its test.  Tolerance:
none; containers and decoded files must be byte-equal.
"""

import os
import socket
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

from tpuhuff.io import stream as jax_stream

from tpuhuff_torch import native
from tpuhuff_torch.dist import encode_pipeline, make_mesh, stitch_words
from tpuhuff_torch.dist.multihost import (
    compress_file_multihost,
    decompress_file_multihost,
)
from tpuhuff_torch.io import StreamError, read_compress_write_hf2
from tpuhuff_torch.io.crc import crc32_combine, crc_span_pieces

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT = 120

_CHILD = """
import os, sys
sys.path.insert(0, os.environ["REPO"])
import numpy as np
from tpuhuff_torch.dist import multihost as mh
mh.initialize()
mh.initialize()  # a second call does nothing
import torch.distributed as dist
rank, nproc = dist.get_rank(), dist.get_world_size()
assert nproc == int(os.environ["TPUHUFF_NUM_PROCESSES"])
# 64-bit values cross exactly
g = mh._allgather_i64(np.asarray([2**31 + rank, 2**40 + 7, -(2**33)]))
assert g.shape == (nproc, 3) and g.dtype == np.int64
assert g[:, 0].tolist() == [2**31 + k for k in range(nproc)]
assert (g[:, 1] == 2**40 + 7).all() and (g[:, 2] == -(2**33)).all()
src, out, bl = os.environ["SRC"], os.environ["OUT"], int(os.environ["BL"])
for k, chunk in enumerate(os.environ["CHUNKS"].split(",")):
    mh.compress_file_multihost(src, f"{out}.{k}.hf2", block_len=bl,
                               chunk_bytes=int(chunk), device="cpu")
for route in ("cpu", "host"):
    mh.decompress_file_multihost(f"{out}.0.hf2", f"{out}.{route}.rt",
                                 device=route)
data = np.fromfile(src, dtype=np.uint8)
lo, hi = mh.host_shard_range(data.size, bl)
words, bits, tree, orig = mh.compress_multihost(data[lo:hi], block_len=bl,
                                                device="cpu")
assert orig == hi - lo
np.savez(f"{out}.{rank}.npz", words=words, bits=bits,
         tree=np.frombuffer(tree.as_bin().to_bytes(), np.uint8))
print("proc", rank, "OK", flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_children(nproc: int, env: dict) -> None:
    env = dict(os.environ, REPO=REPO, TPUHUFF_NUM_PROCESSES=str(nproc),
               TPUHUFF_COORDINATOR=f"127.0.0.1:{_free_port()}", **env)
    env.pop("PYTHONPATH", None)
    native.lib()  # built once here, before the children load it
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD],
                              env=dict(env, TPUHUFF_PROCESS_ID=str(k)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for k in range(nproc)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=CHILD_TIMEOUT)
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for k, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {k} failed:\n{out[-3000:]}"
        assert f"proc {k} OK" in out


@pytest.mark.parametrize("nproc, block_len, chunks, n", [
    # 29 blocks and a ragged tail; super-chunks of 4 and 12 blocks
    (2, 1024, (4096, 12288), 29 * 1024 + 301),
    # 3 processes at 4096-byte blocks: the decoder's host route
    (3, 4096, (8192, 65536), 23 * 4096 + 777),
])
def test_processes_write_the_single_process_container(tmp_path, nproc,
                                                      block_len, chunks, n):
    rng = np.random.default_rng(nproc)
    text = np.frombuffer((b"multi host huffman " * (n // 19 + 1))[:n], np.uint8)
    data = np.where(rng.random(n) < 0.05,
                    rng.integers(0, 256, n, dtype=np.uint8), text).astype(np.uint8)
    src = tmp_path / "src.bin"
    data.tofile(src)
    out = str(tmp_path / "mh")
    _run_children(nproc, {"SRC": str(src), "OUT": out, "BL": str(block_len),
                          "CHUNKS": ",".join(map(str, chunks))})

    # byte-equal to the JAX package's writer and to the port's, one process
    jax_ref, port_ref = tmp_path / "jax.hf2", tmp_path / "port.hf2"
    jax_stream.read_compress_write_hf2(str(src), str(jax_ref),
                                       block_len=block_len, max_code_len=32)
    read_compress_write_hf2(str(src), str(port_ref), block_len=block_len,
                            device="cpu")
    want = jax_ref.read_bytes()
    assert port_ref.read_bytes() == want
    for k in range(len(chunks)):
        assert open(f"{out}.{k}.hf2", "rb").read() == want, k
    for route in ("cpu", "host"):
        assert open(f"{out}.{route}.rt", "rb").read() == data.tobytes(), route

    # the processes' compress_multihost outputs, joined, are the one
    # process pipeline's
    parts = [np.load(f"{out}.{k}.npz") for k in range(nproc)]
    words = np.concatenate([p["words"] for p in parts])
    bits = np.concatenate([p["bits"] for p in parts])
    sw, sb, tree, _ = encode_pipeline(data, block_len=block_len,
                                      mesh=make_mesh(["cpu"]))
    assert stitch_words(words, bits) == stitch_words(sw, sb)
    for p in parts:
        assert p["tree"].tobytes() == tree.as_bin().to_bytes()


@pytest.mark.parametrize("route", ["cpu", "host"])
def test_a_flipped_payload_byte_raises_the_crc_error(tmp_path, route):
    data = np.random.default_rng(5).integers(0, 60, 9 * 1024 + 5, dtype=np.uint8)
    src, hf2 = tmp_path / "s.bin", tmp_path / "s.hf2"
    data.tofile(src)
    compress_file_multihost(str(src), str(hf2), block_len=1024, device="cpu")
    decompress_file_multihost(str(hf2), str(tmp_path / "ok"), device=route)
    assert (tmp_path / "ok").read_bytes() == data.tobytes()
    raw = bytearray(hf2.read_bytes())
    raw[-700] ^= 0x10  # in the payload (the tail), not the header
    hf2.write_bytes(bytes(raw))
    with pytest.raises(StreamError, match="CRC mismatch") as e:
        decompress_file_multihost(str(hf2), str(tmp_path / "bad"), device=route)
    assert e.value.kind == "CorruptData"


def test_crc32_combine_and_span_pieces():
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, 10_000, dtype=np.uint8)
    for cut in (0, 1, 333, 9_999, 10_000):
        a, b = data[:cut].tobytes(), data[cut:].tobytes()
        assert crc32_combine(zlib.crc32(a), zlib.crc32(b), len(b)) == \
            zlib.crc32(data.tobytes()) == jax_stream.crc32_combine(
                zlib.crc32(a), zlib.crc32(b), len(b))
    for off in (0, 5, 4096, 4101):
        for span in (1024, 4096):
            got = crc_span_pieces(data, off, span)
            assert got == jax_stream.crc_span_pieces(data, off, span)
            assert sum(n for _, n in got) == data.size


def test_default_device_is_cuda(monkeypatch):
    """Without a card the default device raises; it never takes the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        compress_file_multihost(__file__, os.devnull)
