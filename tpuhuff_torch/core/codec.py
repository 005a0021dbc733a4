"""In-memory codec: ``compress`` / ``decompress`` of a whole letter sequence.

The port's copy of :mod:`tpuhuff.core.codec` (the reference's
``huff_coding/src/comp.rs``: ``compress`` ``:353-356``,
``compress_with_tree`` ``:419-451``, ``decompress`` ``:487-519``), with
the same bytes.  Byte letters run on the port's C++ host runtime
(:mod:`tpuhuff_torch.native`): a threaded encode, and the byte-driven DFA
decode.  Other letters (wider integers, strings) take the Python paths
of the JAX package, which are kept as they are, as are the numpy packer
:func:`pack_codes_u8` and the resumable :class:`PyDfaDecoder`.  Nothing
here imports torch.
"""

from __future__ import annotations

from typing import Hashable, List, Union

import numpy as np

from .. import native
from .bits import calc_padding_bits
from .format import CompressData, CompressError
from .letters import I8, I16, I32, I64, I128, U8, U16, U32, U64, U128, LetterType
from .tree import HuffTree
from .weights import ByteWeights, build_weights_map

__all__ = [
    "compress",
    "compress_with_tree",
    "decompress",
    "pack_codes_u8",
    "unpack_codes_u8",
    "PyDfaDecoder",
]

BytesLike = Union[bytes, bytearray, memoryview, np.ndarray]

# bytes per piece of the numpy bit expansion (bounds its temporaries)
_PACK_CHUNK = 1 << 20


def _is_u8_data(letters) -> bool:
    return isinstance(letters, (bytes, bytearray, memoryview)) or (
        isinstance(letters, np.ndarray) and letters.dtype == np.uint8
    )


def _as_u8(letters) -> np.ndarray:
    if isinstance(letters, np.ndarray):
        return letters.ravel()
    return np.frombuffer(bytes(letters), dtype=np.uint8)


def pack_codes_u8(
    data: np.ndarray, lens_lut: np.ndarray, codes_lut: np.ndarray
) -> tuple[bytes, int]:
    """Pack ``data`` bytes into an MSB-first bitstream through dense
    tables: gather the code lengths, exclusive-scan the bit offsets,
    expand each code to its bits and ``packbits``.  Returns ``(payload,
    padding_bits)``.  A byte with no code (length 0) raises
    :class:`CompressError` naming it (``comp.rs:427-432``)."""
    data = _as_u8(data)
    lens = lens_lut[data].astype(np.int64)
    if lens.size and int(lens.min()) == 0:
        missing = int(data[int(np.argmin(lens))])
        raise CompressError("letter not found in codes", missing)
    total_bits = int(lens.sum())
    if total_bits == 0:
        return b"", 0
    bits = np.empty(total_bits, dtype=np.uint8)
    bit_base = 0
    for start in range(0, data.size, _PACK_CHUNK):
        chunk = data[start : start + _PACK_CHUNK]
        clens = lens[start : start + _PACK_CHUNK]
        ctotal = int(clens.sum())
        offsets = np.cumsum(clens) - clens  # exclusive scan
        rep_codes = np.repeat(codes_lut[chunk], clens)
        rep_lens = np.repeat(clens, clens)
        pos_in_code = np.arange(ctotal, dtype=np.int64) - np.repeat(offsets, clens)
        shift = (rep_lens - 1 - pos_in_code).astype(np.uint64)
        bits[bit_base : bit_base + ctotal] = (
            (rep_codes >> shift) & np.uint64(1)
        ).astype(np.uint8)
        bit_base += ctotal
    return np.packbits(bits).tobytes(), calc_padding_bits(total_bits)


def unpack_codes_u8(
    payload: BytesLike, padding_bits: int, tree: HuffTree
) -> bytes:
    """Decode an MSB-first bitstream of byte letters with the host
    runtime's byte-driven DFA (``comp.rs:493-519``); the last byte's
    ``padding_bits`` low bits are not read."""
    payload = bytes(payload)
    if not payload:
        return b""
    nbits = len(payload) * 8 - padding_bits
    if tree.is_leaf(tree.root):
        # a one-letter tree: every payload bit is the letter (comp.rs:506-509)
        return bytes([int(tree.letters[tree.root])]) * nbits
    arr = np.frombuffer(payload, dtype=np.uint8)
    tables = native.build_dfa(tree)
    # every code is >= 1 bit, so nbits bounds the letters; try a buffer of
    # a usual ratio first and the bound only if the stream expands more
    guess = min(nbits, max(4 * len(payload), 1 << 20))
    try:
        return native.decode(arr, 0, nbits, tables, guess)
    except RuntimeError:
        return native.decode(arr, 0, nbits, tables, nbits)


class PyDfaDecoder:
    """Resumable byte-driven DFA decoder in plain Python: the walker's
    state carries across :meth:`feed` calls, so a stream decodes in
    bounded memory.  The correctness baseline of the host decoders."""

    def __init__(self, tree: HuffTree):
        self.tree = tree
        (self.next_state, self.emit_count, self.emit_syms,
         state_of_node) = tree.decode_dfa()
        # finish() resumes the tree walk from the node of the DFA's state
        self.node_of_state = np.zeros(self.next_state.shape[0], dtype=np.int64)
        for node, st in enumerate(state_of_node):
            if st >= 0:
                self.node_of_state[st] = node
        self.state = 0

    def feed(self, data: BytesLike) -> bytes:
        """Decode whole bytes (8 bits each); returns the emitted letters."""
        next_state, emit_count, emit_syms = (
            self.next_state, self.emit_count, self.emit_syms,
        )
        out = bytearray()
        state = self.state
        for byte in np.frombuffer(bytes(data), dtype=np.uint8):
            b = int(byte)
            cnt = int(emit_count[state, b])
            if cnt:
                out += emit_syms[state, b, :cnt].tobytes()
            state = int(next_state[state, b])
        self.state = state
        return bytes(out)

    def finish(self, last_byte: int, padding_bits: int) -> bytes:
        """Decode the final byte, whose ``padding_bits`` low bits are not
        read (``comp.rs:516``)."""
        if padding_bits == 0:
            return self.feed(bytes([last_byte]))
        tree = self.tree
        out = bytearray()
        left, right, letters = tree.left, tree.right, tree.letters
        node = int(self.node_of_state[self.state])
        for bit_i in range(7, padding_bits - 1, -1):
            bit = (last_byte >> bit_i) & 1
            node = int(right[node] if bit else left[node])
            if left[node] < 0:
                out.append(int(letters[node]))
                node = tree.root
        return bytes(out)


def compress(letters, ltype: LetterType | str | None = None) -> CompressData:
    """Count the weights, build the tree and compress (``comp.rs:353-356``)."""
    if _is_u8_data(letters):
        tree = HuffTree.from_weights(ByteWeights.from_bytes(_as_u8(letters)))
        return compress_with_tree(letters, tree, ltype or U8)
    tree = HuffTree.from_weights(build_weights_map(letters))
    return compress_with_tree(letters, tree, ltype)


def compress_with_tree(
    letters, huff_tree: HuffTree, ltype: LetterType | str | None = None
) -> CompressData:
    """Compress with a tree built before (``comp.rs:419-451``)."""
    if _is_u8_data(letters):
        data = _as_u8(letters)
        lens_lut, codes_lut = huff_tree.encode_tables()
        try:
            payload, padding = native.encode(data, lens_lut, codes_lut)
        except CompressError:
            # the numpy packer names the missing letter
            payload, padding = pack_codes_u8(data, lens_lut, codes_lut)
        if not payload:
            # the reference panics in CompressData::new on empty comp_bytes
            raise ValueError("provided comp_bytes are empty")
        return CompressData(payload, padding, huff_tree, ltype or U8)
    # other letters: append each code to one big integer (comp.rs:424-447)
    codes = huff_tree.read_codes()
    value = 0
    nbits = 0
    for letter in letters:
        code = codes.get(letter)
        if code is None:
            raise CompressError("letter not found in codes", letter)
        value = (value << code.length) | code.value
        nbits += code.length
    padding = calc_padding_bits(nbits)
    if nbits == 0:
        raise ValueError("provided comp_bytes are empty")
    payload = (value << padding).to_bytes((nbits + padding) // 8, "big")
    return CompressData(payload, padding, huff_tree, ltype or _infer_ltype(letters))


def _infer_ltype(letters) -> LetterType:
    """The smallest registered integer width that holds every letter:
    unsigned letters take u8 .. u128, a negative one the signed ladder.
    Other letters (``str``: tree-only in the reference,
    ``letter.rs:33-37``) keep the u8 default, and serialising their tree
    raises the letter type's ``TypeError``."""
    lo = hi = 0
    for l in letters:
        if isinstance(l, bool) or not isinstance(l, (int, np.integer)):
            return U8
        v = int(l)
        lo = min(lo, v)
        hi = max(hi, v)
    ladder = (I8, I16, I32, I64, I128) if lo < 0 else (U8, U16, U32, U64, U128)
    for lt in ladder:
        lo_ok = lo >= (-(1 << (lt.size_bits - 1)) if lt.signed else 0)
        hi_ok = hi < (1 << (lt.size_bits - 1) if lt.signed else 1 << lt.size_bits)
        if lo_ok and hi_ok:
            return lt
    raise OverflowError(
        f"letters span [{lo}, {hi}], wider than any registered letter type"
    )


def decompress(comp_data: CompressData) -> Union[bytes, List[Hashable]]:
    """Decompress (``comp.rs:487-519``): ``bytes`` when every letter of the
    tree is a u8 int, else a list of letters."""
    tree = comp_data.huff_tree
    all_u8 = all(
        l is None or (isinstance(l, (int, np.integer)) and 0 <= l < 256)
        for l in tree.letters
    )
    if all_u8:
        return unpack_codes_u8(comp_data.comp_bytes, comp_data.padding_bits, tree)
    # other letters: a walk of the tree per bit
    out: List[Hashable] = []
    left, right, letters = tree.left, tree.right, tree.letters
    root = tree.root
    node = root
    payload = comp_data.comp_bytes
    total_bits = len(payload) * 8 - comp_data.padding_bits
    root_is_leaf = tree.is_leaf(root)
    for i in range(total_bits):
        if not root_is_leaf:
            bit = (payload[i >> 3] >> (7 - (i & 7))) & 1
            node = int(right[node] if bit else left[node])
        if left[node] < 0:
            out.append(letters[node])
            node = root
    return out
