"""The port's multi-process decoder (``dist.multihost.decompress_file_multihost``)
under seeded corruptions, against the JAX package's.

A process whose share holds a bad CRC span raises between the decoder's
two barriers, and its peers then wait at the second one (gloo's default
timeout is 30 minutes), in both packages.  So a real N-process run cannot
loop over mutations.  Here every process's share runs in this one test
process with the world simulated: ``jax.process_count``/``process_index``
and ``multihost_utils.sync_global_devices`` on the JAX side,
``dist.multihost._world`` and ``torch.distributed.barrier`` on the port's.
For each mutation, 2 and 3 processes, and each ``pid`` in order, both
decoders run on the same file; their verdicts (exception class name and
``kind``, or none) must be equal, and so must the bytes each process wrote
into its range of the output.  A real gloo run of 2 port processes then
decodes the mutations on which every process gives the same verdict, and
must give the simulated verdicts and bytes.

Where the JAX host route leaves its buffers, its result is undefined and
it is not run; the port raises instead (``dist/multihost.py``):

* a share whose payload is shorter than the block table says: the JAX
  DFA reads past the payload; the port raises ``MissingHeaderInfo``;
* a share whose last block would have a negative length: the JAX DFA
  writes before its output slot; the port raises ``InvalidHeaderInfo``;
* a block that decodes to fewer bytes than its slot, where no CRC span
  catches it: the JAX decoder writes the slot's unset bytes; the port
  raises ``InvalidHeaderInfo``.

Tolerance: none; equal verdicts and equal bytes.
"""

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
from jax.experimental import multihost_utils

from tpuhuff import native as jax_native
from tpuhuff.dist import multihost as jax_mh
from tpuhuff.io import stream as jax_stream

from tpuhuff_torch import native
from tpuhuff_torch.dist import multihost as port_mh
from tpuhuff_torch.io.hff import read_hf2_header
from tpuhuff_torch.io.host import (
    read_compress_write_hf2_host,
    read_decompress_write_hf2_host,
)

from test_torch_multihost import CHILD_TIMEOUT, REPO, _free_port

NPROCS = (2, 3)
# the two containers: (source bytes, block_len); crc_every is 16 and 64
FILES = {
    "a": (101 * 4096 + 123, 4096),  # host route only (block_len > 2048)
    "b": (400 * 1024 + 517, 1024),  # B = 401
}
# the header's fields of a v2 container with CRCs, as byte offsets; the
# integers are flipped in their low byte (orig_len in its low two), so no
# field asks for a size far from the file's
HEADER_BYTES = (0, 1, 2, 3, 4, 5, 9, 10, 17, 18, 22, 26, 30)
# mutations of file (b) on the plain-decoder route, per kind: the port's
# plain decoders take ~0.25 s a share on the CPU, so a seeded subset of 25.
# No tree flips: the JAX route compiles anew for each tree (~12 s a
# mutation); the host route takes them.
PLAIN_PER_KIND = {"header": 5, "table": 4, "crc": 5, "payload": 6,
                  "truncate": 5}


def _source(n: int, seed: int) -> np.ndarray:
    """Text-like bytes holding all 256 byte values."""
    rng = np.random.default_rng(seed)
    words = [b"huffman ", b"block ", b"seam ", b"span ", b"crc ", b"the ",
             b"of ", b"process ", b"\n"]
    text = b"".join(words[k] for k in rng.integers(0, len(words), n // 3))
    data = np.frombuffer(text[:n], np.uint8).copy()
    noise = rng.random(n) < 0.03
    data[noise] = rng.integers(0, 256, int(noise.sum()), dtype=np.uint8)
    data[rng.choice(n, 256, replace=False)] = np.arange(256, dtype=np.uint8)
    return data


def _spans_across_seams(B: int, crc_every: int, nproc: int) -> set:
    """The CRC spans that two processes' shares split."""
    per = -(-B // nproc)
    return {seam // crc_every for seam in range(per, B, per)
            if seam % crc_every}


def _flip(raw: bytes, byte: int, bit: int) -> bytes:
    out = bytearray(raw)
    out[byte] ^= 1 << bit
    return bytes(out)


def _mutations(raw: bytes, hdr, rng) -> list:
    """``(kind, span or None, mutated bytes)``: flips in the header, the
    tree, the block table, the CRC column and the payload, truncations,
    and flips of the CRC and the payload of each span that a seam splits
    for 2 or 3 processes."""
    B, ce, width = hdr.num_blocks, hdr.crc_every, raw[5]
    table = 31
    crcs = table + width * B
    tree = crcs + 4 * hdr.crcs.size
    pay = hdr.payload_offset
    assert raw[:4] == b"HF2\x02" and raw[4] & 2 and pay > tree
    ends = hdr.end_bits.astype(np.int64)
    starts = np.concatenate([[0], ends[:-1]])

    def payload_flip(block: int):
        bit = int(rng.integers(starts[block], ends[block]))
        return ("payload", block // ce, _flip(raw, pay + bit // 8, 7 - bit % 8))

    def crc_flip(span: int):
        return ("crc", span, _flip(raw, crcs + 4 * span + int(rng.integers(4)),
                                   int(rng.integers(8))))

    out = [("header", None, _flip(raw, b, int(rng.integers(8))))
           for b in HEADER_BYTES]
    out += [("tree", None, _flip(raw, int(rng.integers(tree, pay)),
                                 int(rng.integers(8)))) for _ in range(4)]
    # a table entry's low byte: a block's length moves by less than 256 bits
    out += [("table", int(k) // ce, _flip(raw, table + width * int(k) + width - 1,
                                          int(rng.integers(8))))
            for k in rng.integers(0, B, 8)]
    out += [crc_flip(int(s)) for s in rng.integers(0, hdr.crcs.size, 6)]
    out += [payload_flip(int(k)) for k in rng.integers(0, B, 10)]
    cuts = [int(rng.integers(1, table)), int(rng.integers(table, crcs)),
            int(rng.integers(crcs, tree)), int(rng.integers(tree, pay)),
            len(raw) - int(rng.integers(1, 64))]
    out += [("truncate", None, raw[:cut]) for cut in cuts]
    for nproc in NPROCS:
        for span in sorted(_spans_across_seams(B, ce, nproc)):
            blocks = np.arange(span * ce, min((span + 1) * ce, B))
            out += [crc_flip(span), crc_flip(span)]
            out += [payload_flip(int(k)) for k in rng.choice(blocks, 3)]
    return out


class _World:
    """The simulated process group of both packages, and a record of the
    JAX DFA's short blocks."""

    def __init__(self, mp):
        self.nproc, self.pid, self.barriers, self.short = 1, 0, 0, False
        mp.setattr(jax, "process_count", lambda: self.nproc)
        mp.setattr(jax, "process_index", lambda: self.pid)
        mp.setattr(multihost_utils, "sync_global_devices", self._barrier)
        mp.setattr(port_mh, "_world", lambda: (self.nproc, self.pid))
        mp.setattr(port_mh.dist, "barrier", self._barrier)
        real = jax_native.decode_blocks

        def decode_blocks(comp, starts, ends, tables, offs, caps, *rest):
            out, lens = real(comp, starts, ends, tables, offs, caps, *rest)
            self.short |= not np.array_equal(lens, caps)
            return out, lens

        mp.setattr(jax_native, "decode_blocks", decode_blocks)

    def _barrier(self, *_):
        self.barriers += 1


def _verdict(fn) -> tuple:
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the verdict is the exception
        return type(e).__name__, getattr(e, "kind", None)
    return None


def _share(path: str, nproc: int, pid: int):
    """(header, lo_b, hi_b, out_lo, out_len) of ``pid``'s share, as the
    decoders read the header; None if the header does not parse."""
    try:
        with open(path, "rb") as fp:
            hdr = read_hf2_header(fp)
    except Exception:  # noqa: BLE001 - both decoders raise it too
        return None
    B, bl = hdr.num_blocks, hdr.block_len
    per = -(-B // nproc)
    lo_b, hi_b = pid * per, min((pid + 1) * per, B)
    out_lo = lo_b * bl
    return hdr, lo_b, hi_b, out_lo, min(hdr.orig_len, hi_b * bl) - out_lo


def _undefined_in_jax(path: str, nproc: int, pid: int):
    """The port's verdict where the JAX host route's DFA would leave its
    buffers for ``pid``'s share, else None."""
    share = _share(path, nproc, pid)
    if share is None:
        return None
    hdr, lo_b, hi_b, _, out_len = share
    if lo_b >= hi_b or hdr.tree.is_leaf(hdr.tree.root):
        return None
    ends = hdr.end_bits.astype(np.int64)
    byte_lo = int(np.concatenate([[0], ends[:-1]])[lo_b]) // 8
    byte_hi = (int(ends[hi_b - 1]) + 7) // 8
    if os.path.getsize(path) - hdr.payload_offset - byte_lo < byte_hi - byte_lo:
        return "StreamError", "MissingHeaderInfo"
    if out_len < (hi_b - lo_b - 1) * hdr.block_len:
        return "StreamError", "InvalidHeaderInfo"
    return None


def _written(path: str, share) -> str | None:
    """The SHA-256 of ``share``'s range of the output at ``path``."""
    if share is None or share[1] >= share[2] or not os.path.exists(path):
        return None
    with open(path, "rb") as fp:
        fp.seek(share[3])
        return hashlib.sha256(fp.read(max(share[4], 0))).hexdigest()


def _simulate(world, path: str, nproc: int, out: str, port_device,
              jax_device: bool) -> list:
    """Each pid in order through both decoders: per pid ``(port verdict,
    JAX verdict, the SHA-256 of the port's and of the JAX package's
    written range, port barriers before it returned or raised)``.  The
    JAX verdict is ``("undefined", the port's verdict)`` where its DFA
    would leave its buffers or its output holds unset bytes."""
    world.nproc = nproc
    rows = []
    for pid in range(nproc):
        world.pid = pid
        share = _share(path, nproc, pid)
        world.barriers = 0
        port = _verdict(lambda: port_mh.decompress_file_multihost(
            path, f"{out}.port", device=port_device))
        barriers = world.barriers
        undefined = None if jax_device else _undefined_in_jax(path, nproc, pid)
        world.short = False
        if undefined is not None:
            jx = ("undefined", undefined)
            if pid == 0:  # the coordinator creates the output first
                with open(f"{out}.jax", "wb") as fp:
                    fp.truncate(share[0].orig_len)
        else:
            jx = _verdict(lambda: jax_mh.decompress_file_multihost(
                path, f"{out}.jax", device=jax_device))
            if jx is None and world.short:
                jx = ("undefined", ("StreamError", "InvalidHeaderInfo"))
        rows.append((port, jx, _written(f"{out}.port", share),
                     _written(f"{out}.jax", share), barriers))
    if os.path.exists(f"{out}.jax"):
        os.unlink(f"{out}.jax")
    return rows


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Per file: the source, its container's header and the mutated
    containers on disk, as ``(kind, span, path)``."""
    tmp = tmp_path_factory.mktemp("fuzz")
    native.lib()
    out = {}
    for k, (name, (n, block_len)) in enumerate(FILES.items()):
        data = _source(n, seed=100 + k)
        src, hf2 = tmp / f"{name}.bin", tmp / f"{name}.hf2"
        data.tofile(src)
        read_compress_write_hf2_host(str(src), str(hf2), block_len=block_len)
        raw = hf2.read_bytes()
        with open(hf2, "rb") as fp:
            hdr = read_hf2_header(fp)
        muts = []
        for j, (kind, span, mutated) in enumerate(
                _mutations(raw, hdr, np.random.default_rng(200 + k))):
            path = tmp / f"{name}.{j}.hf2"
            path.write_bytes(mutated)
            muts.append((kind, span, str(path)))
        out[name] = (data, hdr, muts)
    return out


@pytest.fixture(scope="module")
def host_runs(corpus):
    """The host route (the port's ``"host"``, the JAX ``device=False``) of
    every mutation, for 2 and 3 processes: ``{(file, index, nproc): rows}``."""
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        world = _World(mp)
        for name, (_, _, muts) in corpus.items():
            for j, (_, _, path) in enumerate(muts):
                for nproc in NPROCS:
                    runs[name, j, nproc] = _simulate(
                        world, path, nproc, f"{path}.host{nproc}", "host",
                        False)
    return runs


def _assert_rows_agree(rows, what: str) -> None:
    for pid, (port, jx, port_sha, jax_sha, _) in enumerate(rows):
        if jx is not None and jx[0] == "undefined":
            assert port == jx[1], f"{what} pid {pid}: {port} where {jx[1]}"
            continue
        assert port == jx, f"{what} pid {pid}"
        if port is None:
            assert port_sha == jax_sha, f"{what} pid {pid}: bytes"


def test_mutations_cover_the_container(corpus):
    kinds = [kind for _, _, muts in corpus.values() for kind, _, _ in muts]
    assert len(kinds) >= 100
    assert {"header", "tree", "table", "crc", "payload", "truncate"} <= set(kinds)
    straddling = 0
    for name, (_, hdr, muts) in corpus.items():
        spans = set().union(*(_spans_across_seams(hdr.num_blocks,
                                                  hdr.crc_every, n)
                              for n in NPROCS))
        straddling += sum(span in spans for kind, span, _ in muts
                          if kind in ("crc", "payload"))
    assert straddling >= 10


@pytest.mark.parametrize("name", sorted(FILES))
def test_host_route_gives_the_jax_verdicts_and_bytes(corpus, host_runs, name):
    undefined = raised = 0
    for j, (kind, _, _) in enumerate(corpus[name][2]):
        for nproc in NPROCS:
            rows = host_runs[name, j, nproc]
            _assert_rows_agree(rows, f"{name} #{j} {kind} nproc {nproc}")
            undefined += sum(jx is not None and jx[0] == "undefined"
                             for _, jx, _, _, _ in rows)
            raised += sum(port is not None for port, _, _, _, _ in rows)
    assert raised > 0 and undefined < raised


def test_plain_route_gives_the_jax_verdicts_and_bytes(corpus):
    """File (b) through the port's plain decoders (``device="cpu"``) and
    the JAX ``device=True`` route, on a seeded subset of the mutations."""
    _, _, muts = corpus["b"]
    rng = np.random.default_rng(300)
    pick = [j for kind, n in PLAIN_PER_KIND.items() for j in rng.choice(
        [j for j, m in enumerate(muts) if m[0] == kind], n, replace=False)]
    assert len(pick) >= 25
    with pytest.MonkeyPatch.context() as mp:
        world = _World(mp)
        for j in sorted(pick):
            kind, _, path = muts[j]
            for nproc in NPROCS:
                rows = _simulate(world, path, nproc, f"{path}.plain{nproc}",
                                 "cpu", True)
                _assert_rows_agree(rows, f"b #{j} {kind} nproc {nproc}")


def test_split_spans_are_left_to_the_whole_file_readers(corpus, host_runs,
                                                        tmp_path):
    """A corruption in a span that a seam splits, which no process raises
    on: the output differs from the source only inside that span, and both
    packages' single-process readers raise ``CorruptData`` on the file."""
    pinned = 0
    for name, (data, hdr, muts) in corpus.items():
        span_b = hdr.crc_every * hdr.block_len
        for j, (kind, span, path) in enumerate(muts):
            if kind not in ("crc", "payload"):
                continue
            for nproc in NPROCS:
                rows = host_runs[name, j, nproc]
                if span not in _spans_across_seams(
                        hdr.num_blocks, hdr.crc_every, nproc) or any(
                        port is not None for port, _, _, _, _ in rows):
                    continue
                got = np.fromfile(f"{path}.host{nproc}.port", np.uint8)
                assert got.size == data.size
                bad = np.flatnonzero(got != data)
                assert bad.size == 0 or (bad.min() >= span * span_b
                                         and bad.max() < (span + 1) * span_b)
                for read in (
                        lambda: jax_stream.read_decompress_write_hf2(
                            path, str(tmp_path / "jax.out")),
                        lambda: read_decompress_write_hf2_host(
                            path, str(tmp_path / "port.out"))):
                    assert _verdict(read) == ("StreamError", "CorruptData")
                pinned += 1
    assert pinned >= 10


_CHILD = """
import json, os, sys
sys.path.insert(0, os.environ["REPO"])
from tpuhuff_torch.dist import multihost as mh
mh.initialize()
verdicts = []
for path in json.loads(os.environ["PATHS"]):
    try:
        mh.decompress_file_multihost(path, path + ".gloo", device="host")
        verdicts.append(None)
    except Exception as e:
        verdicts.append([type(e).__name__, getattr(e, "kind", None)])
print("VERDICTS", mh.is_coordinator(), json.dumps(verdicts), flush=True)
"""


def test_gloo_processes_give_the_simulated_verdicts(corpus, host_runs):
    """Two port processes in a gloo group on the mutations where every
    simulated process gives the same verdict: header faults that raise
    before the first barrier, and clean runs."""
    header, clean = [], []
    for name, (_, _, muts) in corpus.items():
        for j, (kind, _, path) in enumerate(muts):
            rows = host_runs[name, j, 2]
            verdicts = {port for port, _, _, _, _ in rows}
            if len(verdicts) != 1:
                continue
            if None in verdicts:
                clean.append((path, rows))
            elif all(barriers == 0 for *_, barriers in rows):
                header.append((path, rows))
    chosen = header[:4] + clean[:4]
    assert len(header) >= 2 and len(clean) >= 2 and len(chosen) >= 5
    env = dict(os.environ, REPO=REPO, TPUHUFF_NUM_PROCESSES="2",
               TPUHUFF_COORDINATOR=f"127.0.0.1:{_free_port()}",
               PATHS=json.dumps([path for path, _ in chosen]))
    env.pop("PYTHONPATH", None)
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD],
                              env=dict(env, TPUHUFF_PROCESS_ID=str(k)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for k in range(2)]
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
        line = next(s for s in out.splitlines() if s.startswith("VERDICTS"))
        got = json.loads(line.split(" ", 2)[2])
        want = [rows[k][0] for _, rows in chosen]
        assert [v if v is None else tuple(v) for v in got] == want, k
    for path, rows in chosen:
        if rows[0][0] is None:
            with open(path + ".gloo", "rb") as a, \
                    open(f"{path}.host2.port", "rb") as b:
                assert a.read() == b.read(), path
