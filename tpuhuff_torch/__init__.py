"""tpuhuff_torch — the ``tpuhuff`` Huffman codec's device layer in PyTorch + CUDA.

The port sits beside the JAX package and shares its host layers, which
import no JAX: trees and canonical codes (:mod:`tpuhuff.core`), the
``.hff``/``.hf2`` containers (:mod:`tpuhuff.io.hff`), the host stream helpers
(:mod:`tpuhuff.io.stream`) and the C++ runtime (:mod:`tpuhuff.native`).  It
owns what touches the device:

* :mod:`tpuhuff_torch.kernels` — the CUDA kernels (encode, decode,
  histogram), each with its plain PyTorch version;
* :mod:`tpuhuff_torch.dist` — host lane padding and bit stitch;
* :mod:`tpuhuff_torch.io` — the ``.hf2`` device round trip.

Every entry point takes an explicit ``device``; nothing probes for a card
at import, and nothing falls back to the CPU when CUDA is asked for.
"""

from .io import read_compress_write_hf2, read_decompress_write_hf2

__all__ = ["read_compress_write_hf2", "read_decompress_write_hf2"]
