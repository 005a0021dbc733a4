"""Plain reference of the ``.hf2`` container, independent of the program.

It imports nothing of the code under test: only NumPy, PyTorch (plain
tensor operations, on whatever device it is given), ``struct`` and
``zlib``.  From the bytes of a file it works out, on its own, the
container that the program's ``.hf2`` writer must produce for them, and it
decodes a canonical container back to bytes.  The format, as frozen here:

```
"HF2\\x02" | flags (bit0 canonical, bit1 CRC column) | table width w
| u32 BE tree bytes T | tree pad bits | u64 BE input length
| u32 BE block length | u32 BE blocks B | [u32 BE crc_every]
| B x w-byte BE per-block payload bit lengths
| [S x u32 BE zlib CRC32 of each span of crc_every blocks' input bytes]
| T bytes of tree (pre-order: 1 per joint node, 0 + 8 letter bits per leaf)
| payload: every block's codes bit-concatenated MSB-first, zero-padded
```

The tree is the one the reference Huffman coder ``huff`` builds: the
byte counts pushed in byte order onto Rust's ``BinaryHeap`` (a max-heap)
under an order that reverses the weights, two minima popped and joined
(first popped on the left) until one node is left.  Ties between equal
weights fall where that heap's sift-up and sift-down put them, so the heap
is followed step by step.  A canonical container keeps only the code
lengths and assigns codes in (length, letter) order.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

import numpy as np
import torch

MAGIC = b"HF2\x02"
MAX_CODE_LEN = 32  # the device kernels hold a code in one 32-bit word
PIECE = 32 << 20   # bytes encoded per step, to bound the device memory used


# ---------------------------------------------------------------- the tree

def _sift_up(heap: list, weight: list, start: int, pos: int) -> None:
    item = heap[pos]
    while pos > start:
        parent = (pos - 1) // 2
        if weight[item] >= weight[heap[parent]]:
            break
        heap[pos] = heap[parent]
        pos = parent
    heap[pos] = item


def _pop(heap: list, weight: list) -> int:
    """Rust's ``BinaryHeap::pop``: the last item takes the root's place and
    sinks to the bottom along the lighter child (the right one on a tie),
    then rises again."""
    item = heap.pop()
    if not heap:
        return item
    item, heap[0] = heap[0], item
    end, pos, moving = len(heap), 0, heap[0]
    child = 1
    while child <= end - 2:
        if weight[heap[child]] >= weight[heap[child + 1]]:
            child += 1
        heap[pos] = heap[child]
        pos, child = child, 2 * child + 1
    if child == end - 1:
        heap[pos] = heap[child]
        pos = child
    heap[pos] = moving
    _sift_up(heap, weight, 0, pos)
    return item


@dataclass
class Code:
    """The code of a file: ``lengths`` and ``values`` per byte (length 0:
    the byte does not occur), and the serialised tree."""

    lengths: np.ndarray   # (256,) int64
    values: np.ndarray    # (256,) int64, MSB-first, ``lengths`` bits
    tree_bits: str        # the pre-order form, as '0'/'1'
    canonical: bool

    @property
    def max_len(self) -> int:
        return int(self.lengths.max())


def huff_code(counts: np.ndarray, canonical: bool = True) -> Code:
    """The reference coder's code for the byte ``counts``."""
    counts = np.asarray(counts, dtype=np.int64)
    weight, left, right, letter = [], [], [], []
    heap: list = []
    for b in np.nonzero(counts)[0]:
        weight.append(int(counts[b]))
        left.append(-1)
        right.append(-1)
        letter.append(int(b))
        heap.append(len(weight) - 1)
        _sift_up(heap, weight, 0, len(heap) - 1)
    if not heap:
        raise ValueError("no bytes to code")
    while len(heap) > 1:
        lo = _pop(heap, weight)
        hi = _pop(heap, weight)
        weight.append(weight[lo] + weight[hi])
        left.append(lo)
        right.append(hi)
        letter.append(-1)
        heap.append(len(weight) - 1)
        _sift_up(heap, weight, 0, len(heap) - 1)
    root = heap[0]
    lengths = np.zeros(256, dtype=np.int64)
    values = np.zeros(256, dtype=np.int64)
    if left[root] < 0:  # one letter: the code "0"
        lengths[letter[root]] = 1
        return Code(lengths, values, "0" + format(letter[root], "08b"),
                    canonical)
    stack = [(root, 0, 0)]
    while stack:
        node, value, depth = stack.pop()
        if left[node] < 0:
            lengths[letter[node]], values[letter[node]] = depth, value
        else:
            stack.append((right[node], 2 * value + 1, depth + 1))
            stack.append((left[node], 2 * value, depth + 1))
    if lengths.max() > MAX_CODE_LEN:
        raise NotImplementedError(
            f"the reference tree is {lengths.max()} deep; the writer would "
            f"length-limit it to {MAX_CODE_LEN} bits, which this reference "
            "does not model")
    if canonical:
        values = canonical_values(lengths)
    return Code(lengths, values, tree_bits(lengths, values), canonical)


def canonical_values(lengths: np.ndarray) -> np.ndarray:
    """Codes in (length, letter) order, each one more than the last,
    shifted left where the length grows."""
    values = np.zeros(256, dtype=np.int64)
    code, prev = 0, 0
    for b in sorted(np.nonzero(lengths)[0], key=lambda b: (lengths[b], b)):
        code <<= int(lengths[b]) - prev
        values[b] = code
        code += 1
        prev = int(lengths[b])
    return values


def tree_bits(lengths: np.ndarray, values: np.ndarray) -> str:
    """The pre-order form of the prefix tree of the codes."""
    leaf = {(int(lengths[b]), int(values[b])): int(b)
            for b in np.nonzero(lengths)[0]}
    out = []
    stack = [(0, 0)]
    while stack:
        depth, prefix = stack.pop()
        b = leaf.get((depth, prefix))
        if b is not None:
            out.append("0" + format(b, "08b"))
        else:
            out.append("1")
            stack.append((depth + 1, 2 * prefix + 1))
            stack.append((depth + 1, 2 * prefix))
    return "".join(out)


def _bits_to_bytes(bits: str) -> bytes:
    bits += "0" * (-len(bits) % 8)
    return int(bits, 2).to_bytes(len(bits) // 8, "big") if bits else b""


# ------------------------------------------------------------- the encoder

def table_width(block_len: int, max_len: int) -> int:
    """Bytes of a block-table entry: room for ``block_len * max_len``
    bits and ``max_len + 7`` more."""
    bound = block_len * max(max_len, 1) + max(max_len, 1) + 7
    return 2 if bound < 1 << 16 else 4 if bound < 1 << 32 else 8


def crc_every(block_len: int) -> int:
    """Blocks per CRC span: one span per ~64 KiB of input."""
    return max(1, 65536 // max(block_len, 1))


def byte_counts(data: np.ndarray, device="cpu") -> np.ndarray:
    """(256,) int64 counts of the bytes of ``data``, a piece at a time."""
    counts = np.zeros(256, dtype=np.int64)
    for lo in range(0, data.size, PIECE):
        x = torch.from_numpy(np.array(data[lo:lo + PIECE])).to(device)
        counts += torch.bincount(x.to(torch.int64), minlength=256).cpu().numpy()
    return counts


def _bit_table(code: Code, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(256, L) bits of each byte's code, MSB first, and the mask of the
    first ``length`` of them."""
    L = max(code.max_len, 1)
    j = np.arange(L)
    shift = code.lengths[:, None] - 1 - j[None, :]
    bits = (code.values[:, None] >> np.maximum(shift, 0)) & 1
    mask = j[None, :] < code.lengths[:, None]
    return (torch.from_numpy((bits * mask).astype(np.uint8)).to(device),
            torch.from_numpy(mask).to(device))


def _pack(bits: torch.Tensor) -> torch.Tensor:
    """Whole bytes of a 0/1 uint8 vector whose length is a multiple of 8."""
    v = bits.view(-1, 8)
    out = v[:, 0] << 7
    for k in range(1, 8):
        out |= v[:, k] << (7 - k)
    return out


@dataclass
class Container:
    """A container as its two parts: the prelude (header, tables, tree)
    and the payload, both as bytes on the host."""

    prelude: bytes
    payload: np.ndarray
    code: Code

    @property
    def nbytes(self) -> int:
        return len(self.prelude) + self.payload.size


def encode(data: np.ndarray, block_len: int = 256, canonical: bool = True,
           check: bool = True, device="cpu") -> Container:
    """The container of ``data`` (uint8) as the program must write it."""
    data = np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
    n = data.size
    dev = torch.device(device)
    code = huff_code(byte_counts(data, dev), canonical)
    bits_tab, mask_tab = _bit_table(code, dev)
    lens_tab = torch.from_numpy(code.lengths).to(dev)
    n_blocks = max(1, -(-n // block_len))
    block_bits = np.zeros(n_blocks, dtype=np.int64)
    payload, carry = [], torch.zeros(0, dtype=torch.uint8, device=dev)
    piece = PIECE - PIECE % block_len
    for lo in range(0, n, piece):
        x = torch.from_numpy(np.array(data[lo:lo + piece])).to(dev).to(
            torch.int64)
        lens = lens_tab[x]
        pad = -x.numel() % block_len
        per_block = torch.nn.functional.pad(lens, (0, pad)).view(-1, block_len)
        b0 = lo // block_len
        block_bits[b0:b0 + per_block.shape[0]] = per_block.sum(1).cpu().numpy()
        bits = torch.cat([carry, bits_tab[x][mask_tab[x]]])
        whole = bits.numel() - bits.numel() % 8
        payload.append(_pack(bits[:whole]).cpu().numpy())
        carry = bits[whole:]
        del x, lens, bits
    if carry.numel():
        tail = torch.cat([carry, torch.zeros(8 - carry.numel(),
                                             dtype=torch.uint8, device=dev)])
        payload.append(_pack(tail).cpu().numpy())
    width = table_width(block_len, code.max_len)
    every = crc_every(block_len) if check else 0
    head = [MAGIC, bytes([(1 if canonical else 0) | (2 if every else 0),
                          width])]
    tree = _bits_to_bytes(code.tree_bits)
    head.append(struct.pack(">IBQII", len(tree), -len(code.tree_bits) % 8,
                            n, block_len, n_blocks))
    if every:
        head.append(struct.pack(">I", every))
    head.append(block_bits.astype(f">u{width}").tobytes())
    if every:
        span = every * block_len
        crcs = [zlib.crc32(data[lo:lo + span]) for lo in range(0, n, span)]
        head.append(np.asarray(crcs, dtype=">u4").tobytes())
    head.append(tree)
    body = (np.concatenate(payload) if payload
            else np.zeros(0, dtype=np.uint8))
    return Container(b"".join(head), body, code)


def differing_bytes(got: np.ndarray, want: Container) -> int:
    """Bytes of ``got`` (a whole container) that differ from ``want``,
    a length difference counting as that many bytes."""
    got = np.asarray(got, dtype=np.uint8).reshape(-1)
    head = np.frombuffer(want.prelude, dtype=np.uint8)
    p = min(got.size, head.size)
    bad = int(np.count_nonzero(got[:p] != head[:p]))
    body = got[head.size:] if got.size > head.size else got[:0]
    q = min(body.size, want.payload.size)
    bad += int(np.count_nonzero(body[:q] != want.payload[:q]))
    return bad + abs(got.size - want.nbytes)


# ------------------------------------------------------------- the decoder

@dataclass
class Header:
    flags: int
    width: int
    orig_len: int
    block_len: int
    n_blocks: int
    crc_every: int
    block_bits: np.ndarray
    crcs: np.ndarray | None
    lengths: np.ndarray
    values: np.ndarray
    payload_offset: int


def _parse_tree(bits: str) -> tuple[np.ndarray, np.ndarray]:
    lengths = np.zeros(256, dtype=np.int64)
    values = np.zeros(256, dtype=np.int64)
    pos, stack = 0, [(0, 0)]
    while stack:
        depth, prefix = stack.pop()
        if bits[pos] == "1":
            pos += 1
            stack.append((depth + 1, 2 * prefix + 1))
            stack.append((depth + 1, 2 * prefix))
        else:
            b = int(bits[pos + 1:pos + 9], 2)
            lengths[b], values[b] = max(depth, 1), prefix
            pos += 9
    if pos != len(bits):
        raise ValueError("tree has trailing bits")
    return lengths, values


def parse_header(buf: np.ndarray) -> Header:
    raw = bytes(buf[:31])
    if raw[:4] != MAGIC:
        raise ValueError("not a version-2 .hf2 container")
    flags, width = raw[4], raw[5]
    tree_len, tree_pad, orig_len, block_len, n_blocks = struct.unpack(
        ">IBQII", raw[6:27])
    pos, every = 27, 0
    if flags & 2:
        every = struct.unpack(">I", raw[27:31])[0]
        pos = 31
    block_bits = np.frombuffer(bytes(buf[pos:pos + width * n_blocks]),
                               dtype=f">u{width}").astype(np.int64)
    pos += width * n_blocks
    crcs = None
    if every:
        spans = -(-n_blocks // every)
        crcs = np.frombuffer(bytes(buf[pos:pos + 4 * spans]),
                             dtype=">u4").astype(np.uint32)
        pos += 4 * spans
    tree = bytes(buf[pos:pos + tree_len])
    bits = "".join(format(b, "08b") for b in tree)
    lengths, values = _parse_tree(bits[:len(bits) - tree_pad])
    return Header(flags, width, orig_len, block_len, n_blocks, every,
                  block_bits, crcs, lengths, values, pos + tree_len)


def decode(buf: np.ndarray, device="cpu", max_bits: int | None = None
           ) -> np.ndarray:
    """The bytes of the canonical container ``buf`` (uint8, whole file),
    decoded block by block, all blocks one code at a time together.

    ``max_bits`` narrows the decoder to codes of at most that many bits,
    as a one-level table of ``2**max_bits`` entries with no escape would:
    a longer code yields a wrong byte.  It exists for the control that
    must fail the check."""
    h = parse_header(buf)
    if not np.array_equal(h.values, canonical_values(h.lengths)):
        raise NotImplementedError("the plain decoder reads canonical codes")
    dev = torch.device(device)
    L = int(h.lengths.max())
    limit = L if max_bits is None else min(L, max_bits)
    # canonical decoding: per length, the first code, the count and the
    # first index into the letters sorted by (length, letter)
    order = sorted(np.nonzero(h.lengths)[0], key=lambda b: (h.lengths[b], b))
    letters = torch.tensor(order, dtype=torch.uint8, device=dev)
    first, count, offset = [], [], []
    seen = 0
    for ln in range(1, L + 1):
        members = [b for b in order if h.lengths[b] == ln]
        first.append(int(h.values[members[0]]) if members else 0)
        count.append(len(members))
        offset.append(seen)
        seen += len(members)
    payload = torch.from_numpy(np.array(buf[h.payload_offset:],
                                        dtype=np.uint8)).to(dev)
    payload = torch.cat([payload, torch.zeros(8, dtype=torch.uint8,
                                               device=dev)]).to(torch.int64)
    starts = np.concatenate([[0], np.cumsum(h.block_bits)[:-1]])
    pos = torch.from_numpy(starts.astype(np.int64)).to(dev)
    B, bl = h.n_blocks, h.block_len
    last = h.orig_len - (B - 1) * bl
    out = torch.zeros((B, bl), dtype=torch.uint8, device=dev)
    top = payload.numel() - 5
    for step in range(bl):
        byte = (pos >> 3).clamp(max=top)
        window = torch.zeros_like(pos)
        for k in range(5):  # 40 bits hold any 32-bit code at any offset
            window = (window << 8) | payload[byte + k]
        window = (window >> (8 - (pos & 7))) & 0xFFFFFFFF  # 32 bits at pos
        sym = torch.zeros_like(pos)
        used = torch.zeros_like(pos)
        for ln in range(1, limit + 1):
            if not count[ln - 1]:
                continue
            idx = (window >> (32 - ln)) - first[ln - 1]
            hit = (used == 0) & (idx >= 0) & (idx < count[ln - 1])
            sym = torch.where(hit, idx + offset[ln - 1], sym)
            used = torch.where(hit, torch.full_like(used, ln), used)
        miss = used == 0  # a code longer than the narrowed table
        used = torch.where(miss, torch.full_like(used, limit), used)
        out[:, step] = torch.where(miss, torch.zeros_like(sym),
                                   letters[sym.clamp(max=len(order) - 1)])
        pos = pos + used
    flat = out.reshape(-1)[: (B - 1) * bl + last]
    return flat.cpu().numpy()

