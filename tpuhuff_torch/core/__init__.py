"""Host core of the port: letters, weights, trees, canonical codes, the
``.hff`` container and the in-memory codec.

Copies of the JAX package's :mod:`tpuhuff.core` modules, laid out under
the same names, with the same arithmetic and bytes.  Nothing here imports
torch.
"""

from .bits import BitString, calc_padding_bits, offset_bytes
from .format import CompressData, CompressError, CompressedDataFromBytesError
from .letters import LetterType, letter_type, U8, U16, U32, U64, U128, I8, I16, I32, I64, I128
from .tree import Code, EmptyWeightsError, FromBinError, HuffTree
from .weights import ByteWeights, build_weights_map
from .codec import compress, compress_with_tree, decompress, pack_codes_u8, unpack_codes_u8

__all__ = [
    "BitString", "calc_padding_bits", "offset_bytes",
    "compress", "compress_with_tree", "decompress",
    "pack_codes_u8", "unpack_codes_u8",
    "CompressData", "CompressError", "CompressedDataFromBytesError",
    "LetterType", "letter_type",
    "U8", "U16", "U32", "U64", "U128", "I8", "I16", "I32", "I64", "I128",
    "Code", "EmptyWeightsError", "FromBinError", "HuffTree",
    "ByteWeights", "build_weights_map",
]
