"""Huffman tree: flat-array nodes, reference-faithful construction, bit serde.

The port's copy of :mod:`tpuhuff.core.tree`, with the same arithmetic and
bytes:

* Nodes live in flat arrays (``left``/``right``/``letters``/``weights``);
  a leaf has ``left == right == -1``.
* Construction emulates Rust's ``std::collections::BinaryHeap`` exactly
  (sift order and all) over the reversed-``Ord`` wrapper of the reference
  (``huff_coding/src/tree/branch_heap.rs:64-83``), comparing by weight
  only, so ties resolve as in the reference and the tree's shape, and the
  compressed bits, are the reference's.
* Codes: left appends 0, right appends 1; a one-leaf tree gets code ``0``.
* Binary serde (``as_bin``/``try_from_bin``): pre-order, ``1`` per joint
  node, ``0`` plus the letter's big-endian bits per leaf, with strict
  exact-consumption checks.
* Array forms for the codecs: dense encode tables (``encode_tables``) and
  the byte-driven decode DFA (``decode_dfa``).
"""

from __future__ import annotations

from typing import Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np

from .bits import BitString
from .letters import LetterType, U8, letter_type
from .weights import weights_items

__all__ = ["HuffTree", "Code", "FromBinError", "EmptyWeightsError"]


class FromBinError(ValueError):
    """Raised when a tree's binary form is malformed."""


class EmptyWeightsError(ValueError):
    """Raised for empty weights, with the reference's message."""

    def __init__(self) -> None:
        super().__init__("provided empty weights")


class Code:
    """A Huffman code: ``value`` holds ``length`` MSB-first bits."""

    __slots__ = ("value", "length")

    def __init__(self, value: int, length: int):
        self.value = value
        self.length = length

    def __iter__(self):
        v, n = self.value, self.length
        for i in range(n):
            yield (v >> (n - 1 - i)) & 1

    def __len__(self) -> int:
        return self.length

    def __eq__(self, other) -> bool:
        if isinstance(other, Code):
            return self.value == other.value and self.length == other.length
        if isinstance(other, (str, list, tuple)):
            return self.to01() == "".join(str(int(b)) for b in other)
        return NotImplemented

    def __hash__(self) -> int:
        return hash((self.value, self.length))

    def to01(self) -> str:
        return format(self.value, f"0{self.length}b") if self.length else ""

    def bits(self) -> BitString:
        return BitString(self.value, self.length)

    def __repr__(self) -> str:
        return f"Code('{self.to01()}')"


class _RustBinaryHeap:
    """Bit-faithful emulation of ``std::collections::BinaryHeap`` (a
    max-heap) over a wrapper whose order is the reverse of the weight
    order, so it pops the minimum weight.  Equal weights compare equal and
    their pop order is decided by the hole-based ``sift_up`` /
    ``sift_down_to_bottom`` mechanics alone, which are replicated here.

    Items are opaque; ``key(item)`` returns the weight.  All comparisons
    are in wrapper order: ``a <= b  <=>  key(b) <= key(a)``.
    """

    __slots__ = ("data", "key")

    def __init__(self, key):
        self.data: List = []
        self.key = key

    def __len__(self) -> int:
        return len(self.data)

    def _le(self, a, b) -> bool:
        return self.key(b) <= self.key(a)

    def push(self, item) -> None:
        self.data.append(item)
        self._sift_up(0, len(self.data) - 1)

    def _sift_up(self, start: int, pos: int) -> int:
        data = self.data
        element = data[pos]
        while pos > start:
            parent = (pos - 1) // 2
            if self._le(element, data[parent]):
                break
            data[pos] = data[parent]
            pos = parent
        data[pos] = element
        return pos

    def pop(self):
        data = self.data
        item = data.pop()
        if data:
            item, data[0] = data[0], item
            self._sift_down_to_bottom(0)
        return item

    def _sift_down_to_bottom(self, pos: int) -> None:
        data = self.data
        end = len(data)
        start = pos
        element = data[pos]
        child = 2 * pos + 1
        # while both children exist, descend to the "greater" child
        # unconditionally (ties pick the right child)
        while child <= end - 2:
            if self._le(data[child], data[child + 1]):
                child += 1
            data[pos] = data[child]
            pos = child
            child = 2 * pos + 1
        if child == end - 1:
            data[pos] = data[child]
            pos = child
        data[pos] = element
        self._sift_up(start, pos)


class HuffTree:
    """A Huffman tree over letters, stored as flat node arrays.

    Node ``i`` has ``letters[i]`` (``None`` for a joint node),
    ``weights[i]`` and children ``left[i]``/``right[i]`` (``-1`` for
    leaves); ``root`` is the root's index.
    """

    def __init__(
        self,
        left: Sequence[int],
        right: Sequence[int],
        letters: Sequence[Optional[Hashable]],
        weights: Sequence[int],
        root: int,
    ):
        self.left = np.asarray(left, dtype=np.int32)
        self.right = np.asarray(right, dtype=np.int32)
        self.letters: List[Optional[Hashable]] = list(letters)
        self.weights = np.asarray(weights, dtype=np.int64)
        self.root = int(root)

    @classmethod
    def from_weights(cls, weights) -> "HuffTree":
        """Build the tree with the reference's heap loop (pop two minima,
        push their joint) over the exact Rust-heap emulation."""
        items = weights_items(weights)
        if not items:
            raise EmptyWeightsError()

        letters: List[Optional[Hashable]] = []
        node_weights: List[int] = []
        left: List[int] = []
        right: List[int] = []

        def new_node(letter, weight, l=-1, r=-1) -> int:
            letters.append(letter)
            node_weights.append(weight)
            left.append(l)
            right.append(r)
            return len(letters) - 1

        heap = _RustBinaryHeap(key=lambda i: node_weights[i])
        for letter, weight in items:
            heap.push(new_node(letter, int(weight)))

        while len(heap) > 1:
            lo = heap.pop()
            hi = heap.pop()
            heap.push(new_node(None, node_weights[lo] + node_weights[hi], lo, hi))
        root = heap.pop()
        return cls(left, right, letters, node_weights, root)

    @property
    def num_nodes(self) -> int:
        return len(self.letters)

    def is_leaf(self, node: int) -> bool:
        return self.left[node] < 0

    def num_leaves(self) -> int:
        return int(np.count_nonzero(self.left < 0))

    def read_codes(self) -> Dict[Hashable, Code]:
        """Letter -> code map: left appends 0, right appends 1; a one-leaf
        root gets code ``0``."""
        codes: Dict[Hashable, Code] = {}
        if self.is_leaf(self.root):
            codes[self.letters[self.root]] = Code(0, 1)
            return codes
        # iterative pre-order walk; stack entries: (node, value, length)
        stack = [
            (int(self.right[self.root]), 1, 1),
            (int(self.left[self.root]), 0, 1),
        ]
        while stack:
            node, value, length = stack.pop()
            if self.is_leaf(node):
                codes[self.letters[node]] = Code(value, length)
            else:
                stack.append((int(self.right[node]), (value << 1) | 1, length + 1))
                stack.append((int(self.left[node]), value << 1, length + 1))
        return codes

    def max_code_len(self) -> int:
        if self.is_leaf(self.root):
            return 1
        depth = 0
        stack = [(self.root, 0)]
        while stack:
            node, d = stack.pop()
            if self.is_leaf(node):
                depth = max(depth, d)
            else:
                stack.append((int(self.left[node]), d + 1))
                stack.append((int(self.right[node]), d + 1))
        return depth

    def encode_tables(self) -> Tuple[np.ndarray, np.ndarray]:
        """Dense ``(len[256] uint8, code[256] uint64)`` tables; ``len == 0``
        marks a byte absent from the tree.  Requires u8 letters and codes
        of at most 64 bits."""
        lens = np.zeros(256, dtype=np.uint8)
        codes = np.zeros(256, dtype=np.uint64)
        for letter, code in self.read_codes().items():
            if not isinstance(letter, (int, np.integer)) or not 0 <= letter < 256:
                raise TypeError("encode_tables requires u8 letters")
            if code.length > 64:
                raise OverflowError("code longer than 64 bits; use generic path")
            lens[letter] = code.length
            codes[letter] = code.value
        return lens, codes

    def node_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(left, right, letter_or_minus1) int32 arrays for the native DFA."""
        lets = np.array(
            [-1 if l is None else int(l) for l in self.letters], dtype=np.int32
        )
        return self.left.copy(), self.right.copy(), lets

    def decode_dfa(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Byte-driven DFA over the joint nodes: one lookup consumes 8
        payload bits and emits 0..8 letters.  States are the joint nodes
        renumbered with the root as state 0 (callers handle a one-leaf
        tree apart).

        Returns ``(next_state[S,256] int16, emit_count[S,256] uint8,
        emit_syms[S,256,8] uint8, state_of_node[num_nodes] int16)``.
        """
        internal = [n for n in range(self.num_nodes) if not self.is_leaf(n)]
        if not internal:
            raise ValueError("decode_dfa needs at least one internal node")
        internal.sort(key=lambda n: (n != self.root,))  # root first
        state_of_node = np.full(self.num_nodes, -1, dtype=np.int16)
        for s, n in enumerate(internal):
            state_of_node[n] = s
        S = len(internal)
        next_state = np.zeros((S, 256), dtype=np.int16)
        emit_count = np.zeros((S, 256), dtype=np.uint8)
        emit_syms = np.zeros((S, 256, 8), dtype=np.uint8)
        root = self.root
        left, right, letters = self.left, self.right, self.letters
        for s, start in enumerate(internal):
            for byte in range(256):
                node = start
                count = 0
                for bit_i in range(7, -1, -1):
                    bit = (byte >> bit_i) & 1
                    node = int(right[node] if bit else left[node])
                    if left[node] < 0:  # leaf
                        emit_syms[s, byte, count] = int(letters[node])
                        count += 1
                        node = root
                next_state[s, byte] = state_of_node[node]
                emit_count[s, byte] = count
        return next_state, emit_count, emit_syms, state_of_node

    def as_bin(self, ltype: LetterType | str = U8) -> BitString:
        """Pre-order bit encoding of the tree."""
        lt = letter_type(ltype)
        out = BitString()
        stack = [self.root]
        while stack:
            node = stack.pop()
            if self.is_leaf(node):
                out.push(0)
                out.push_uint(
                    int.from_bytes(lt.as_be_bytes(self.letters[node]), "big"),
                    lt.size_bits,
                )
            else:
                out.push(1)
                stack.append(int(self.right[node]))
                stack.append(int(self.left[node]))
        return out

    @classmethod
    def try_from_bin(cls, bin_bits: BitString, ltype: LetterType | str = U8) -> "HuffTree":
        """Parse the pre-order form.  All weights are 0 in the result;
        truncated or leftover bits raise :class:`FromBinError`."""
        lt = letter_type(ltype)
        letters: List[Optional[Hashable]] = []
        weights: List[int] = []
        left: List[int] = []
        right: List[int] = []

        def new_node(letter, l=-1, r=-1) -> int:
            letters.append(letter)
            weights.append(0)
            left.append(l)
            right.append(r)
            return len(letters) - 1

        pos = 0
        n = len(bin_bits)

        def take_bit() -> int:
            nonlocal pos
            if pos >= n:
                raise FromBinError(
                    "Provided BitVec is too small for an encoded HuffTree"
                )
            b = bin_bits[pos]
            pos += 1
            return b

        def take_letter() -> Hashable:
            nonlocal pos
            if pos + lt.size_bits > n:
                raise FromBinError(
                    "Provided BitVec is too small for an encoded HuffTree"
                )
            value = 0
            for _ in range(lt.size_bits):
                value = (value << 1) | bin_bits[pos]
                pos += 1
            return lt.try_from_be_bytes(value.to_bytes(lt.size_bytes, "big"))

        def parse() -> int:
            # stack of unfinished joint nodes, each [left_child_or_None]
            stack: List[List[Optional[int]]] = []
            while True:
                if take_bit():
                    stack.append([None])
                    continue
                node = new_node(take_letter())
                while True:
                    if not stack:
                        return node
                    top = stack[-1]
                    if top[0] is None:
                        top[0] = node
                        break
                    l = top[0]
                    stack.pop()
                    node = new_node(None, l, node)

        root = parse()
        if pos != n:
            raise FromBinError("Provided BitVec is too big for an encoded HuffTree")
        return cls(left, right, letters, weights, root)

    def __repr__(self) -> str:
        return f"HuffTree(num_nodes={self.num_nodes}, root={self.root})"

    def __eq__(self, other) -> bool:
        """Same shape and letters (weights ignored)."""
        if not isinstance(other, HuffTree):
            return NotImplemented
        return self.read_codes() == other.read_codes()
