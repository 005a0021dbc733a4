"""tpuhuff_torch — the ``tpuhuff`` Huffman codec's device layer in PyTorch + CUDA.

The port sits beside the JAX package and imports nothing of it.  It keeps
its own copies of the host layers it needs, laid out under the JAX
package's names and writing the same bytes:

* :mod:`tpuhuff_torch.core` — bits, weights, trees, canonical codes, the
  ``.hff`` container (:class:`CompressData`) and the in-memory codec
  (:func:`compress`, :func:`decompress`), whose names are also this
  package's, as they are the JAX package's;
* :mod:`tpuhuff_torch.native` — the C++ host runtime, built with ``g++``
  from the repository's ``cpp/huffc.cpp`` into ``tpuhuff_torch/_build/``;
* :mod:`tpuhuff_torch.io.hff`, :mod:`tpuhuff_torch.io.host` and
  :mod:`tpuhuff_torch.io.index` — the ``.hf2`` container, the host writer
  and reader, and the ``.hff`` sidecar index.

These host modules import no torch.  The package owns what touches the
device:

* :mod:`tpuhuff_torch.kernels` — the CUDA kernels (encode, with or
  without a fused histogram; canonical and general-tree decode;
  histogram), each with its plain PyTorch version;
* :mod:`tpuhuff_torch.dist` — the block-parallel pipelines on a mesh of
  devices (:func:`~tpuhuff_torch.dist.compress_sharded`) and the
  multi-process file codec on ``torch.distributed``
  (:mod:`tpuhuff_torch.dist.multihost`);
* :mod:`tpuhuff_torch.io` — the ``.hf2`` device round trip
  (:func:`read_compress_write_hf2`, :func:`read_decompress_write_hf2`),
  the ``.hff`` writer and reader (:func:`read_compress_write`,
  :func:`read_decompress_write`) and config 4's dataset compression
  (:func:`compress_dataset`, :func:`decompress_dataset`);
* :mod:`tpuhuff_torch.cli` — the command line, ``python -m tpuhuff_torch``.

Every entry point takes an explicit ``device``; nothing probes for a card
at import, and nothing falls back to the CPU when CUDA is asked for.  The
names below load at first use (PEP 562), so importing the package pulls
in no torch.
"""

import importlib

_LETTER_TYPES = ("U8", "U16", "U32", "U64", "U128", "I8", "I16", "I32", "I64",
                 "I128")

# public name -> the submodule that defines it: every name of
# :mod:`tpuhuff_torch.core` (the JAX package's top-level names), and the
# file codec of :mod:`tpuhuff_torch.io`
_EXPORTS = {
    **{name: "core" for name in (
        *_LETTER_TYPES, "BitString", "ByteWeights", "Code", "CompressData",
        "CompressError", "CompressedDataFromBytesError", "EmptyWeightsError",
        "FromBinError", "HuffTree", "LetterType", "build_weights_map",
        "calc_padding_bits", "compress", "compress_with_tree", "decompress",
        "letter_type", "offset_bytes", "pack_codes_u8", "unpack_codes_u8")},
    **{name: "io" for name in (
        "compress_dataset", "decompress_dataset", "read_compress_write",
        "read_compress_write_hf2", "read_decompress_write",
        "read_decompress_write_hf2")},
}

# the functions and classes; the letter-type constants load all the same
__all__ = sorted(set(_EXPORTS) - set(_LETTER_TYPES))


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f".{module}", __name__), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
