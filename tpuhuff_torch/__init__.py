"""tpuhuff_torch — the ``tpuhuff`` Huffman codec's device layer in PyTorch + CUDA.

The port sits beside the JAX package and imports nothing of it.  It keeps
its own copies of the host layers it needs, laid out under the JAX
package's names and writing the same bytes:

* :mod:`tpuhuff_torch.core` — bits, weights, trees, canonical codes;
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
* :mod:`tpuhuff_torch.dist` — host lane padding and bit stitch;
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

_EXPORTS = (
    "compress_dataset",
    "decompress_dataset",
    "read_compress_write",
    "read_compress_write_hf2",
    "read_decompress_write",
    "read_decompress_write_hf2",
)

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    from . import io

    value = getattr(io, name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
