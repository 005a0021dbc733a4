"""Streaming file codec on the device (PyTorch + CUDA).

* :func:`read_compress_write_hf2` / :func:`read_decompress_write_hf2` —
  the block-indexed ``.hf2`` container (``collect_hist`` returns the
  file's histogram, counted during the encode);
* :func:`read_compress_write` / :func:`read_decompress_write` — the
  reference's ``.hff`` format (device writer, host reader);
* :func:`compress_dataset` / :func:`decompress_dataset`,
  :func:`build_shared_tree`, :func:`tree_from_counts` — config 4: many
  shards under one shared tree, or adaptively refreshed trees.
"""

from .dataset import (
    build_shared_tree,
    compress_dataset,
    decompress_dataset,
    tree_from_counts,
)
from .host import read_decompress_write
from .stream import (
    read_compress_write,
    read_compress_write_hf2,
    read_decompress_write_hf2,
)

__all__ = [
    "build_shared_tree",
    "compress_dataset",
    "decompress_dataset",
    "read_compress_write",
    "read_compress_write_hf2",
    "read_decompress_write",
    "read_decompress_write_hf2",
    "tree_from_counts",
]
