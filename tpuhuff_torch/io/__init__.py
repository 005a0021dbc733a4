"""Streaming file codec on the device (PyTorch + CUDA).

* :func:`read_compress_write_hf2` / :func:`read_decompress_write_hf2` —
  the block-indexed ``.hf2`` container (``collect_hist`` returns the
  file's histogram, counted during the encode);
* :func:`read_compress_write` / :func:`read_decompress_write` — the
  reference's ``.hff`` format (device writer, host reader with the
  ``.hf2x`` sidecar index);
* :func:`transcode_hff_to_hf2` / :func:`decode_hff_indexed` — a ``.hff``
  re-indexed into ``.hf2`` without recompressing;
* :func:`compress_dataset` / :func:`decompress_dataset`,
  :func:`build_shared_tree`, :func:`tree_from_counts` — config 4: many
  shards under one shared tree, or adaptively refreshed trees.

The names are loaded at first use (PEP 562), so the host modules
(:mod:`.hff`, :mod:`.host`, :mod:`.index`) import without torch.
"""

import importlib

# public name -> the submodule that defines it
_EXPORTS = {
    "Hf2Header": "hff",
    "read_hf2_header": "hff",
    "write_hf2": "hff",
    "StreamError": "host",
    "huff_tree_from_stream": "host",
    "read_decompress_write": "host",
    "decode_hff_indexed": "index",
    "transcode_hff_to_hf2": "index",
    "read_compress_write": "stream",
    "read_compress_write_hf2": "stream",
    "read_decompress_write_hf2": "stream",
    "build_shared_tree": "dataset",
    "compress_dataset": "dataset",
    "decompress_dataset": "dataset",
    "tree_from_counts": "dataset",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f".{module}", __name__), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
