"""Canonical and length-limited Huffman codes.

The port's copy of :mod:`tpuhuff.core.canonical`, with the same arithmetic:

* :func:`canonicalize` — the same code lengths, codes assigned in
  (length, letter) order, numerically increasing;
* :func:`build_tree_for_device` — the reference-exact tree when its depth
  fits ``max_len``, else the optimal length-limited canonical tree
  (package-merge, Larmore & Hirschberg 1990): the device kernels hold a
  code in one u32.
"""

from __future__ import annotations

from typing import Dict, Hashable, List, Sequence, Tuple

import numpy as np

from .tree import EmptyWeightsError, HuffTree
from .weights import weights_items

__all__ = [
    "canonical_codes_from_lengths",
    "canonicalize",
    "length_limited_code_lengths",
    "tree_from_code_lengths",
    "build_tree_for_device",
]


def canonical_codes_from_lengths(
    lengths: Sequence[Tuple[Hashable, int]]
) -> Dict[Hashable, Tuple[int, int]]:
    """(letter, len) pairs -> letter -> (code_value, len), canonical order:
    sorted by (length, letter), codes increasing numerically."""
    items = sorted(lengths, key=lambda kv: (kv[1], kv[0]))
    codes: Dict[Hashable, Tuple[int, int]] = {}
    code = 0
    prev_len = 0
    for letter, length in items:
        if length <= 0:
            raise ValueError("code length must be positive")
        code <<= length - prev_len
        codes[letter] = (code, length)
        code += 1
        prev_len = length
    if prev_len and code > (1 << prev_len):
        raise ValueError("lengths violate the Kraft inequality")
    return codes


def tree_from_code_lengths(lengths: Sequence[Tuple[Hashable, int]]) -> HuffTree:
    """The tree whose shape realizes the canonical code for the given
    (letter, length) pairs, with all weights 0."""
    if not lengths:
        raise EmptyWeightsError()
    if len(lengths) == 1:
        letter = lengths[0][0]
        return HuffTree([-1], [-1], [letter], [0], 0)
    codes = canonical_codes_from_lengths(lengths)
    letters: List = [None]
    weights = [0]
    left = [-1]
    right = [-1]
    root = 0
    for letter, (value, length) in codes.items():
        node = root
        for i in range(length - 1, -1, -1):
            bit = (value >> i) & 1
            child = right[node] if bit else left[node]
            if child < 0:
                letters.append(None)
                weights.append(0)
                left.append(-1)
                right.append(-1)
                child = len(letters) - 1
                if bit:
                    right[node] = child
                else:
                    left[node] = child
            node = child
        letters[node] = letter
    return HuffTree(left, right, letters, weights, root)


def canonicalize(tree: HuffTree) -> HuffTree:
    """The canonical tree with the same code lengths as ``tree``."""
    lengths = [(letter, code.length) for letter, code in tree.read_codes().items()]
    return tree_from_code_lengths(lengths)


def length_limited_code_lengths(
    weights, max_len: int
) -> List[Tuple[Hashable, int]]:
    """Optimal code lengths with ``len <= max_len`` via package-merge.
    Returns (letter, length) pairs; needs ``2**max_len >= n_letters``."""
    items = weights_items(weights)
    n = len(items)
    if n == 0:
        raise EmptyWeightsError()
    if n == 1:
        return [(items[0][0], 1)]
    if (1 << max_len) < n:
        raise ValueError(f"max_len {max_len} cannot code {n} letters")
    # package-merge over levels max_len..1; an item's code length is the
    # number of chosen packages it is part of
    base = sorted(range(n), key=lambda i: (items[i][1],))
    counts = np.zeros(n, dtype=np.int32)

    def merge_level(packages):
        level = [(items[i][1], (i,)) for i in base]
        level += packages
        level.sort(key=lambda p: p[0])
        return level

    prev: List[Tuple[int, tuple]] = []
    for _ in range(max_len):
        level = merge_level(prev)
        prev = []
        for k in range(0, len(level) - 1, 2):
            w = level[k][0] + level[k + 1][0]
            ids = level[k][1] + level[k + 1][1]
            prev.append((w, ids))
    # the first n-1 packages of the final level
    for w, ids in prev[: n - 1]:
        for i in ids:
            counts[i] += 1
    return [(items[i][0], int(counts[i])) for i in range(n)]


def build_tree_for_device(weights, max_len: int = 32) -> Tuple[HuffTree, bool]:
    """The tree the device kernels use: the reference-exact tree when its
    depth fits ``max_len``, else the optimal length-limited canonical tree.
    Returns ``(tree, limited)``; ``limited`` is True for the latter."""
    tree = HuffTree.from_weights(weights)
    if tree.max_code_len() <= max_len:
        return tree, False
    lengths = length_limited_code_lengths(weights, max_len)
    return tree_from_code_lengths(lengths), True
