"""The n-device dry run of the block-parallel pipeline.

Counterpart of the repository's ``__graft_entry__.py`` (``entry()``,
``dryrun_multichip(n)``) for the port:

* :func:`entry` — the flagship step, the block encode (K1), and operands
  for it;
* :func:`dryrun_multichip` — one full sharded step on an n-entry mesh:
  K3 per shard, the merge, the host tree and K1 per shard, bit-identical
  to the host packer; then the sharded decode of a canonical tree (K2)
  and of a non-canonical one (K4), the shared-tree encode that counts
  its own bytes (K5, config 4), and the ``.hf2`` writer and reader on an
  uneven spread of blocks over the mesh.

Run it with ``python -m tpuhuff_torch.dist.dryrun [N] [DEVICE]`` (N
entries, default 4; DEVICE ``cuda``, the default, or ``cpu`` for the
kernels' plain versions).
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch

__all__ = ["entry", "dryrun_multichip"]


def entry(device="cuda"):
    """``(forward, args)``: the block encode under a canonical tree, and
    256 blocks of 256 bytes on ``device`` to run it on."""
    from ..core.canonical import canonicalize
    from ..core.tree import HuffTree
    from ..core.weights import ByteWeights
    from ..kernels import encode_blocks, make_encode_tables
    from .mesh import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    data = rng.integers(0, 200, (256, 256), dtype=np.uint8)
    tree = canonicalize(
        HuffTree.from_weights(ByteWeights.from_bytes(data.reshape(-1))))
    tables = make_encode_tables(*tree.encode_tables()).to(dev)
    valid = torch.full((256,), 256, dtype=torch.int32, device=dev)

    def forward(blocks, valid_lens, tables):
        return encode_blocks(blocks, valid_lens, tables)

    return forward, (torch.from_numpy(data).to(dev), valid, tables)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what}")


def _mesh_of(n_devices: int, device):
    """n entries: the CUDA cards in turn (repeating where there are fewer
    than n), or the CPU n times."""
    from .mesh import make_mesh, resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and torch.device(device).index is None:
        count = torch.cuda.device_count()
        return make_mesh([torch.device("cuda", k % count)
                          for k in range(n_devices)])
    return make_mesh([dev] * n_devices)


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """One full sharded step on an n-entry mesh, checked against the host
    codec at every stage (any mismatch raises ``AssertionError``).
    Returns ``{"bits": ..., "blocks": ...}`` of the first step."""
    from ..core.canonical import canonicalize
    from ..core.codec import pack_codes_u8
    from ..core.tree import HuffTree
    from ..core.weights import ByteWeights
    from ..io.dataset import tree_from_counts
    from ..io.hff import write_hf2
    from ..io.stream import read_decompress_write_hf2
    from ..kernels import (
        encode_blocks,
        make_canonical_decode_tables,
        make_encode_tables,
        payload_to_lane_words,
    )
    from . import pad_to_blocks, sharded_decode_blocks, stitch_words
    from .block import _place, sharded_encode, sharded_histogram

    mesh = _mesh_of(n_devices, device)
    rng = np.random.default_rng(1)
    raw = rng.integers(0, 256, 4 * n_devices * 256 + 37, dtype=np.uint8)
    blocks, valid, _ = pad_to_blocks(raw, 256, n_devices)

    # pass 1: K3 per shard, merged; the host tree; pass 2: K1 per shard
    h = sharded_histogram(blocks, valid, mesh)
    _check(np.array_equal(h, np.bincount(raw, minlength=256)),
           "merged histogram != host bincount")
    tree = HuffTree.from_weights(ByteWeights(h))
    words, bits = sharded_encode(blocks, valid,
                                 make_encode_tables(*tree.encode_tables()),
                                 mesh, check_missing=False)
    _check(int(bits.sum()) > 0, "no bits")
    payload, padding = stitch_words(words, bits)
    ref = pack_codes_u8(raw, *tree.encode_tables())
    _check((payload, padding) == ref, "sharded encode != host packer")

    def decoded(payload, bits, tree):
        ends = np.cumsum(bits.astype(np.int64))
        starts = np.concatenate([[0], ends[:-1]])
        rows, bit0 = payload_to_lane_words(payload, starts, ends, 256)
        return sharded_decode_blocks(rows, bit0, (ends - starts).astype(np.int32),
                                     tree, 256, mesh).reshape(-1)[: raw.size]

    # the decode side: K4 where the tree is not canonical, K2 where it is
    if make_canonical_decode_tables(tree) is None:
        _check(np.array_equal(decoded(payload, bits, tree), raw),
               "sharded general-tree decode mismatch")
    ctree = canonicalize(tree)
    cw, cb = sharded_encode(blocks, valid,
                            make_encode_tables(*ctree.encode_tables()), mesh,
                            check_missing=False)
    _check(np.array_equal(decoded(stitch_words(cw, cb)[0], cb, ctree), raw),
           "sharded canonical decode mismatch")

    # config 4's step: one shared tree, each shard's encode counting its
    # own bytes (K5), the counts merged
    stree = tree_from_counts(np.bincount(raw, minlength=256))
    stab = make_encode_tables(*stree.encode_tables())
    got = np.zeros(256, dtype=np.int64)
    parts = []
    for (local, lv), dev in zip(_place(blocks, valid, mesh), mesh):
        w, b, _, hist = encode_blocks(local, lv, stab.to(dev), hist_data=local)
        got += hist.cpu().numpy()
        parts.append((w.cpu().numpy().view(np.uint32), b.cpu().numpy()))
    want = np.bincount(raw, minlength=256)
    want[0] += blocks.size - raw.size  # the count sees the padding zeros
    _check(np.array_equal(got, want), "merged K5 histogram mismatch")
    spayload, _ = stitch_words(np.concatenate([w for w, _ in parts]),
                               np.concatenate([b for _, b in parts]))
    _check(spayload == pack_codes_u8(raw, *stree.encode_tables())[0],
           "shared-tree sharded encode != host packer")

    # the .hf2 writer and reader on an uneven spread: 3n + 1 whole blocks
    # and a ragged tail, so the shards own different numbers of real blocks
    raw2 = rng.integers(0, 256, (3 * n_devices + 1) * 256 + 57, dtype=np.uint8)
    blocks2, valid2, _ = pad_to_blocks(raw2, 256, n_devices)
    ctree2 = canonicalize(HuffTree.from_weights(ByteWeights.from_bytes(raw2)))
    w2, b2 = sharded_encode(blocks2, valid2,
                            make_encode_tables(*ctree2.encode_tables()), mesh,
                            check_missing=False)
    nb_real = -(-raw2.size // 256)
    payload2, _ = stitch_words(w2[:nb_real], b2[:nb_real])
    ends2 = np.cumsum(b2[:nb_real].astype(np.int64)).astype(np.uint64)
    with tempfile.TemporaryDirectory() as td:
        hf2 = os.path.join(td, "dryrun.hf2")
        with open(hf2, "wb") as fp:
            write_hf2(fp, ctree2, raw2.size, 256, ends2, payload2,
                      canonical=True)
        rt = os.path.join(td, "roundtrip.bin")
        read_decompress_write_hf2(hf2, rt, device=mesh[0])
        with open(rt, "rb") as fp:
            _check(fp.read() == raw2.tobytes(), ".hf2 file round trip mismatch")

    print(f"dryrun_multichip({n_devices}) on {', '.join(map(str, mesh))}: OK "
          f"- merged histogram + sharded encode bit-identical to the host "
          f"({int(bits.sum())} bits) + sharded decode round trips + .hf2 "
          f"writer round trip (uneven {nb_real} blocks over {n_devices} "
          "shards)", flush=True)
    return {"bits": int(bits.sum()), "blocks": int(blocks.shape[0])}


if __name__ == "__main__":
    fn, args = entry(sys.argv[2] if len(sys.argv) > 2 else "cuda")
    print("entry forward:", [tuple(o.shape) for o in fn(*args)])
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4,
                     sys.argv[2] if len(sys.argv) > 2 else "cuda")
