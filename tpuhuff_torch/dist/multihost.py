"""The multi-process file codec (config 5) on ``torch.distributed``.

Counterpart of :mod:`tpuhuff.dist.multihost`.  Every process runs the same
call (SPMD) on its own device: it reads its own byte range, runs its own
kernels, and the 256 counts, the block lengths, the payloads and the CRC
pieces cross between processes as host tensors.  So the process group is
**gloo**, on CPU tensors (:func:`initialize` makes one): NCCL would add
nothing to collectives of host bytes, and refuses two ranks on one card,
while several processes sharing one card (each launching its own kernels)
is how a one-card machine runs this path.  Process 0 (the coordinator)
writes the container, in order, as the reference's single writer loop
does (``huff/src/comp.rs:207-223``).

Each process's device is an explicit ``device`` argument, by default
``cuda``, or ``cuda:{rank % device_count}`` when a process group is up.
The JAX package's ``device=True/False`` of the decoder is ``"cuda"`` /
``"host"`` here, as on the command line.  With one process every function
degenerates to the local pipeline.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .block import encode_pipeline, encode_pipeline_arrays, pad_to_blocks
from .mesh import make_mesh, resolve_device

__all__ = [
    "initialize",
    "is_coordinator",
    "host_shard_range",
    "compress_multihost",
    "compress_file_multihost",
    "decompress_file_multihost",
]


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join the gloo process group at ``coordinator_address`` (``host:port``),
    by default from ``TPUHUFF_COORDINATOR``, ``TPUHUFF_NUM_PROCESSES`` and
    ``TPUHUFF_PROCESS_ID``.  Does nothing with no coordinator (one
    process) or when a group is already up, so a second call is harmless."""
    if dist.is_initialized():
        return
    if coordinator_address is None:
        coordinator_address = os.environ.get("TPUHUFF_COORDINATOR")
    if coordinator_address is None:
        return
    if num_processes is None and "TPUHUFF_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["TPUHUFF_NUM_PROCESSES"])
    if process_id is None and "TPUHUFF_PROCESS_ID" in os.environ:
        process_id = int(os.environ["TPUHUFF_PROCESS_ID"])
    if num_processes is None or process_id is None:
        raise ValueError("initialize: a coordinator needs the number of "
                         "processes and this process's id")
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def _world() -> Tuple[int, int]:
    """(number of processes, this process's rank)."""
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _default_device(device) -> torch.device:
    if device is not None:
        return resolve_device(device)
    if dist.is_initialized() and torch.cuda.is_available():
        return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    return resolve_device("cuda")


def _allgather(t: torch.Tensor) -> np.ndarray:
    """``all_gather`` of a CPU tensor: (nproc, *t.shape) numpy."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t.contiguous())
    return torch.stack(parts).numpy()


def _allgather_i64(arr: np.ndarray) -> np.ndarray:
    """All processes' int64 ``arr``, as (nproc, *arr.shape) int64.  The
    values cross as 64-bit integers, so sizes and counts past 2^31 (a
    shard over 2 GiB) stay exact."""
    return _allgather(torch.from_numpy(
        np.ascontiguousarray(arr, dtype=np.int64)))


def is_coordinator() -> bool:
    return _world()[1] == 0


def host_shard_range(total_len: int, block_len: int) -> Tuple[int, int]:
    """``[start, end)`` bytes this process loads: whole blocks, contiguous,
    balanced across the processes."""
    nproc, pid = _world()
    n_blocks = max(1, -(-total_len // block_len))
    per = -(-n_blocks // nproc)
    lo_b, hi_b = pid * per, min((pid + 1) * per, n_blocks)
    return lo_b * block_len, min(hi_b * block_len, total_len)


def _per_host_block_quota(total_len: int, block_len: int, n_local: int) -> int:
    """Blocks each process contributes: the most any process owns, rounded
    up to a multiple of its mesh size ``n_local``.  A process with fewer
    real blocks pads with empty ones (valid 0), which emit no bits and no
    counts."""
    nproc, _ = _world()
    n_blocks = max(1, -(-total_len // block_len))
    per = -(-n_blocks // nproc)
    return -(-per // n_local) * n_local


def compress_file_multihost(
    src_path: str, dst_path: str, block_len: int = 65536,
    canonical: bool = True, chunk_bytes: int | None = None,
    check: bool = True, device=None,
) -> None:
    """Compress ``src_path`` into ``.hf2`` across the processes, streaming:
    the same bytes as the single-process writer with ``max_code_len=32``.

    * pass 1 — each process counts its own byte range
      (:func:`host_shard_range`); one all-gather of the 256 counts, and
      every process builds the same tree;
    * pass 2 — the file's blocks go in super-chunks of ``chunk_bytes``
      (64 MiB by default); super-chunk s is encoded by process ``s %
      nproc`` on its device.  Each round all-gathers one super-chunk per
      process: its payload padded to a power of two (at least 4 KiB, at
      most the super-chunk's bound), its block bit lengths and its CRC
      pieces; the coordinator appends them in order through the
      bit-carrying sink and patches the block table.  No process holds
      more than a round.

    ``check`` writes the CRC32 column: each owner CRCs its super-chunk cut
    at the global span boundaries (:func:`~tpuhuff_torch.io.crc.
    crc_span_pieces`), and the coordinator folds the pieces with
    :func:`~tpuhuff_torch.io.crc.crc32_combine`.  Every process calls this
    with the same paths; the file is complete on every process's return.
    """
    from ..core.canonical import build_tree_for_device, canonicalize
    from ..core.weights import ByteWeights
    from ..io.crc import crc32_combine, crc_span_pieces
    from ..io.hff import (
        default_crc_every, hf2_table_width, write_hf2_crc_slice,
        write_hf2_prelude, write_hf2_table_slice,
    )
    from ..io.host import _BitSink
    from ..io.stream import _DeviceBlockEncoder, _Staging

    dev = _default_device(device)
    nproc, pid = _world()
    total = os.path.getsize(src_path)
    n_blocks = max(1, -(-total // block_len)) if total else 1
    chunk = chunk_bytes if chunk_bytes is not None else (64 << 20)
    sc_blocks = max(1, chunk // block_len)  # blocks per super-chunk
    n_sc = -(-n_blocks // sc_blocks)        # super-chunks in the file

    # pass 1: each process's range, then one merge
    counts = np.zeros(256, dtype=np.int64)
    with open(src_path, "rb") as fp:
        lo, hi = host_shard_range(total, block_len)
        fp.seek(lo)
        left = hi - lo
        while left > 0:
            piece = fp.read(min(left, chunk))
            if not piece:
                break
            counts += ByteWeights.from_bytes(piece).counts
            left -= len(piece)
    if nproc > 1:
        counts = _allgather_i64(counts).sum(axis=0)
    tree, _limited = build_tree_for_device(ByteWeights(counts), max_len=32)
    if canonical:
        tree = canonicalize(tree)
    lens_lut, _ = tree.encode_tables()
    ml = int(lens_lut.max(initial=1))
    width = hf2_table_width(block_len, ml)
    enc = _DeviceBlockEncoder(tree, block_len, dev, _Staging(dev))

    ce = default_crc_every(block_len) if check else 0
    span = ce * block_len
    # the most span pieces one super-chunk gives: its whole spans + 2 edges
    n_pieces = (sc_blocks * block_len) // span + 2 if ce else 0

    # pass 2: super-chunks round robin, the coordinator writes in order
    dst = table_off = crc_off = sink = None
    run_crc = run_len = span_idx = 0  # the coordinator's fold of the pieces
    if pid == 0:
        dst = open(dst_path, "wb")
        table_off, crc_off, _ = write_hf2_prelude(
            dst, tree, total, block_len, n_blocks, width, canonical,
            crc_every=ce)
        sink = _BitSink(dst)
    cap_bytes = sc_blocks * block_len * ml // 8 + 8  # a super-chunk's bound
    try:
        with open(src_path, "rb") as fp:
            for r in range(-(-n_sc // nproc)):
                s_mine = r * nproc + pid
                my_payload = b""
                my_lens = np.zeros(sc_blocks, dtype=np.int64)
                my_pieces = np.zeros((max(n_pieces, 1), 2), dtype=np.int64)
                my_nb = 0
                if s_mine < n_sc:
                    b0 = s_mine * sc_blocks
                    b1 = min(b0 + sc_blocks, n_blocks)
                    fp.seek(b0 * block_len)
                    # straight into the encoder's slot: ``data`` is a view
                    # of it, read for its CRC pieces before the next read
                    data = enc.read(
                        fp, min(b1 * block_len, total) - b0 * block_len, 0)
                    my_nb = b1 - b0
                    if data.size:
                        # each super-chunk is a stream of its own
                        chunk = enc.collect(enc(data, 0, fresh=True))
                        my_payload = chunk.payload()
                        my_lens[:my_nb] = chunk.bit_lens
                        if ce:
                            for j, (c, ln) in enumerate(crc_span_pieces(
                                    data, b0 * block_len, span)):
                                my_pieces[j] = (c, ln)
                if nproc > 1:
                    # the lengths first, then each payload padded only to
                    # the round's largest, bucketed to a power of two so
                    # that the collectives' shapes repeat
                    metas = _allgather_i64(np.asarray([len(my_payload), my_nb]))
                    round_max = int(metas[:, 0].max())
                    bucket = max(4096, 1 << (max(round_max, 1) - 1).bit_length())
                    bucket = min(bucket, cap_bytes)
                    pad = np.zeros(max(bucket, 1), dtype=np.uint8)
                    pad[: len(my_payload)] = np.frombuffer(my_payload, np.uint8)
                    pays = _allgather(torch.from_numpy(pad))
                    lens_all = _allgather_i64(my_lens)
                    pieces_all = _allgather_i64(my_pieces) if ce else None
                else:
                    metas = np.asarray([[len(my_payload), my_nb]])
                    pays = np.frombuffer(my_payload, np.uint8)[None, :]
                    lens_all = my_lens[None, :]
                    pieces_all = my_pieces[None, :] if ce else None
                if pid != 0:
                    continue
                for h in range(nproc):
                    s = r * nproc + h
                    if s >= n_sc:
                        break
                    nb_h = int(metas[h, 1])
                    bl = lens_all[h, :nb_h].astype(np.uint64)
                    write_hf2_table_slice(dst, table_off, width,
                                          s * sc_blocks, bl)
                    sink.write(pays[h, : int(metas[h, 0])].tobytes(),
                               int(bl.sum()))
                    if not ce:
                        continue
                    # fold this super-chunk's span pieces, in order
                    for c, ln in pieces_all[h]:
                        if ln == 0:
                            break
                        run_crc = (int(c) if run_len == 0
                                   else crc32_combine(run_crc, int(c), int(ln)))
                        run_len += int(ln)
                        if run_len == span:
                            write_hf2_crc_slice(dst, crc_off, span_idx,
                                                np.asarray([run_crc], np.uint32))
                            span_idx += 1
                            run_crc = run_len = 0
        if pid == 0:
            if ce and run_len:
                write_hf2_crc_slice(dst, crc_off, span_idx,
                                    np.asarray([run_crc], np.uint32))
            sink.flush()
    finally:
        if dst is not None:
            dst.close()
    if nproc > 1:
        dist.barrier()  # the container exists for every process on return


def compress_multihost(
    local_data: np.ndarray, block_len: int = 65536,
    total_len: Optional[int] = None, canonical: bool = False, device=None,
):
    """Compress this process's shard; returns ``(words, bits, tree,
    orig_len)`` of this process's blocks.

    With several processes each runs the pipeline on its own blocks on its
    own device, padded with empty blocks to the common quota
    (:func:`_per_host_block_quota`); the histogram is summed over the
    group with one ``all_reduce``, so every process builds the same tree.
    With one process this is :func:`~tpuhuff_torch.dist.encode_pipeline`.
    """
    mesh = make_mesh([_default_device(device)])
    nproc, _ = _world()
    if nproc == 1:
        return encode_pipeline(local_data, block_len=block_len, mesh=mesh,
                               canonical=canonical)
    local = np.asarray(local_data, dtype=np.uint8).ravel()
    if total_len is None:
        total_len = int(_allgather_i64(np.asarray([local.size])).sum())
    quota = _per_host_block_quota(total_len, block_len, len(mesh))
    blocks, valid, orig_len = pad_to_blocks(local, block_len, 1)
    if blocks.shape[0] > quota:
        raise ValueError(f"host shard has {blocks.shape[0]} blocks > quota {quota}")
    if blocks.shape[0] < quota:
        extra = quota - blocks.shape[0]
        blocks = np.concatenate([blocks, np.zeros((extra, block_len), np.uint8)])
        valid = np.concatenate([valid, np.zeros(extra, np.int32)])
    words, bits, tree = encode_pipeline_arrays(
        blocks, valid, mesh, canonical=canonical, group=dist.group.WORLD)
    return words, bits, tree, orig_len


def decompress_file_multihost(
    src_path: str, dst_path: str, device=None,
    threads: Optional[int] = None, check: bool = True,
) -> None:
    """Decode a ``.hf2`` across the processes: each reads only the payload
    of its contiguous share of the blocks, decodes it and ``pwrite``s its
    slice of the output.  The coordinator creates the output; barriers
    order create, the parallel writes and the return.

    ``device`` ``"host"`` decodes with the threaded C++ DFA; a torch
    device with K2 or K4 (:func:`~tpuhuff_torch.kernels.decoder_for`).
    As in the JAX function, blocks longer than
    ``DEVICE_DECODE_MAX_BLOCK`` (2048) bytes and one-letter trees take
    the host route whatever ``device`` says, a CUDA device too (unlike
    ``io.read_decompress_write_hf2``, which decodes every block length on
    a CUDA device).  ``check`` verifies each CRC span
    that lies whole in this process's share (a span split between two
    processes is left to a whole-file decode).

    The host route also raises where the JAX function's DFA would leave
    its buffers: on a payload shorter than the block table says
    (``MissingHeaderInfo``), on a share whose last block would have a
    negative length, and, after the CRC check, on a block that decodes to
    fewer bytes than its slot (``InvalidHeaderInfo``).  A process that
    raises after the first barrier leaves its peers waiting at the second,
    as in the JAX function."""
    from .. import native
    from ..io.hff import read_hf2_header
    from ..io.host import StreamError
    from ..io.stream import DEVICE_DECODE_MAX_BLOCK

    with open(src_path, "rb") as fp:
        hdr = read_hf2_header(fp)
    # the local reader's rejection of a malformed table: offsets that fall
    # would drive negative reads below
    ends = hdr.end_bits.astype(np.int64)
    if ends.size and np.any(np.diff(ends) < 0):
        raise StreamError(f"{src_path!r} stores invalid header information",
                          "InvalidHeaderInfo")
    B = hdr.num_blocks
    on_host = (isinstance(device, str) and device == "host"
               or hdr.block_len > DEVICE_DECODE_MAX_BLOCK
               or hdr.tree.is_leaf(hdr.tree.root))
    dev = None if on_host else _default_device(device)
    pc, pid = _world()
    per = -(-B // pc)
    lo_b, hi_b = pid * per, min((pid + 1) * per, B)

    if pid == 0:
        with open(dst_path, "wb") as out:
            out.truncate(hdr.orig_len)
    if pc > 1:
        dist.barrier()
    if lo_b < hi_b:
        starts = np.concatenate([[0], ends[:-1]])
        bit_lo, bit_hi = int(starts[lo_b]), int(ends[hi_b - 1])
        byte_lo, byte_hi = bit_lo // 8, (bit_hi + 7) // 8
        with open(src_path, "rb") as fp:
            fp.seek(hdr.payload_offset + byte_lo)
            payload = fp.read(byte_hi - byte_lo)
        rel_starts = starts[lo_b:hi_b] - byte_lo * 8
        rel_ends = ends[lo_b:hi_b] - byte_lo * 8
        out_lo = lo_b * hdr.block_len
        out_len = min(hdr.orig_len, hi_b * hdr.block_len) - out_lo
        short = False
        if hdr.tree.is_leaf(hdr.tree.root):
            out_bytes = bytes([int(hdr.tree.letters[hdr.tree.root])]) * out_len
        elif not on_host:
            from ..kernels import decoder_for, payload_to_lane_words

            rows, bit0 = payload_to_lane_words(payload, rel_starts, rel_ends,
                                               hdr.block_len)
            decode, tables = decoder_for(hdr.tree)
            out_arr = decode(
                torch.from_numpy(rows.view(np.int32)).to(dev),
                torch.from_numpy(bit0).to(dev),
                torch.from_numpy((rel_ends - rel_starts).astype(np.int32)).to(dev),
                tables.to(dev), hdr.block_len)
            out_bytes = out_arr.cpu().numpy().reshape(-1)[:out_len].tobytes()
        else:
            # the DFA reads its bits from `payload` and writes each block
            # into its slot unchecked: a short read or a negative last slot
            # would take it past its buffers
            if len(payload) < byte_hi - byte_lo:
                raise StreamError(f"{src_path!r} truncated payload",
                                  "MissingHeaderInfo")
            nb = hi_b - lo_b
            last = out_len - (nb - 1) * hdr.block_len
            if last < 0:
                raise StreamError(f"{src_path!r} stores invalid header "
                                  "information", "InvalidHeaderInfo")
            tables = native.build_dfa(hdr.tree)
            caps = np.full(nb, hdr.block_len, dtype=np.uint64)
            caps[-1] = last
            offs = np.arange(nb, dtype=np.uint64) * hdr.block_len
            out_buf, out_lens = native.decode_blocks(
                np.frombuffer(payload, dtype=np.uint8),
                rel_starts.astype(np.uint64), rel_ends.astype(np.uint64),
                tables, offs, caps, threads)
            out_bytes = out_buf[:out_len].tobytes()
            short = not np.array_equal(out_lens, caps)
        if check and hdr.crcs is not None and hdr.crc_every and out_len > 0:
            _check_spans(hdr, lo_b, hi_b, out_lo, out_bytes, src_path)
        if short:
            # a block that decoded short left its slot's tail unwritten
            raise StreamError(f"{src_path!r} block decode length mismatch",
                              "InvalidHeaderInfo")
        fd = os.open(dst_path, os.O_WRONLY)
        try:
            os.pwrite(fd, out_bytes, out_lo)
        finally:
            os.close(fd)
    if pc > 1:
        dist.barrier()


def _check_spans(hdr, lo_b: int, hi_b: int, out_lo: int, out_bytes: bytes,
                 src_path: str) -> None:
    """Verify the CRC spans that lie whole in blocks ``[lo_b, hi_b)``, and
    the file's final (partial) span when this share holds it."""
    from ..io.crc import _crc_spans as crc_spans
    from ..io.host import StreamError

    ce = hdr.crc_every
    span_b = ce * hdr.block_len
    s0 = -(-lo_b // ce)
    s_full_end = hi_b // ce
    obuf = np.frombuffer(out_bytes, dtype=np.uint8)
    if s_full_end > s0:
        rel0 = s0 * span_b - out_lo
        got = crc_spans(obuf[rel0 : rel0 + (s_full_end - s0) * span_b], span_b)
        want = hdr.crcs[s0:s_full_end]
        if not np.array_equal(got, want):
            bad = s0 + int(np.argmax(got != want))
            raise StreamError(f"{src_path!r} block CRC mismatch in span {bad} "
                              "(corrupt payload or index)", "CorruptData")
    if (hi_b == hdr.num_blocks and s_full_end * ce >= lo_b
            and s_full_end < hdr.crcs.size):
        rel = s_full_end * span_b - out_lo
        got_t = crc_spans(obuf[rel:], span_b)
        if got_t.size != 1 or int(got_t[0]) != int(hdr.crcs[s_full_end]):
            raise StreamError(f"{src_path!r} block CRC mismatch in span "
                              f"{s_full_end} (corrupt payload or index)",
                              "CorruptData")
