"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

* :func:`encode_blocks` (``csrc/encode.cu``) — lanes of bytes to MSB-first
  Huffman words, exact bit counts and missing-letter counts (K1); with
  ``hist_data``, also the exact counts of a second byte operand in the same
  launch (K5, counted in ``encode_blocks.hist_launches``);
* :func:`decode_rows` (``csrc/decode.cu``) — canonical decode of
  independent ``.hf2`` blocks;
* :func:`decode_rows_general` (``csrc/decode_general.cu``) — the same
  decode for any prefix tree (both share ``csrc/decode_common.cuh`` and a
  first-level table of ``2^LUT_BITS`` entries);
* :func:`histogram` (``csrc/histogram.cu`` over ``csrc/histogram_common.cuh``)
  — exact 256-bin byte counts, added into ``out=`` where given;
* :func:`stitch_lanes` (S1, ``csrc/stitch.cu`` over ``csrc/stitch_common.cuh``)
  — K1's lanes concatenated at the bit level into big-endian payload
  bytes, behind a carried partial byte (the host's ``stitch_words``);
* :func:`lane_rows` (S2, ``csrc/lane_rows.cu`` over
  ``csrc/lane_rows_common.cuh``) — the decoders' rows cut out of a payload
  on the device (the host's ``payload_to_lane_words``), each row
  :func:`row_width` words;
* :func:`crc32_spans` (C1, ``csrc/crc32.cu`` over ``csrc/crc32_common.cuh``)
  — the zlib CRC32 of each span of bytes on the device, the ``.hf2`` CRC
  column (the host's ``crc32_blocks``; no TPU kernel).

:func:`count_missing` and :func:`block_bit_lengths` are a LUT gather and a
sum in PyTorch on the data's device (XLA, not Pallas, in the JAX package);
:func:`words_to_payload` is a host helper.

A wrapper launches its kernel for CUDA tensors and runs its plain version
(``*_reference``) for CPU tensors; ``<wrapper>.launches`` counts the kernel
launches, and the CUDA branch is a ``launch`` span of the active tracer
(:mod:`tpuhuff_torch.profiling`).  The kernels are compiled at first use,
never at import.
"""

from .crc import crc32_spans, crc32_spans_reference
from .decode import (
    LUT_BITS,
    DecodeTables,
    GeneralDecodeTables,
    decode_hf2_device,
    decode_rows,
    decode_rows_general,
    decode_rows_general_reference,
    decode_rows_reference,
    decode_tile_rows,
    decoder_for,
    first_level_table,
    lane_rows,
    lane_rows_reference,
    make_canonical_decode_tables,
    make_decode_tables,
    payload_to_lane_words,
    row_width,
)
from .encode import (
    EncodeTables,
    block_bit_lengths,
    count_missing,
    encode_blocks,
    encode_blocks_reference,
    make_encode_tables,
    out_words,
    words_to_payload,
)
from .histogram import histogram, histogram_grid, histogram_reference
from .stitch import new_carry, stitch_capacity, stitch_lanes, stitch_lanes_reference

__all__ = [
    "LUT_BITS",
    "DecodeTables",
    "EncodeTables",
    "GeneralDecodeTables",
    "block_bit_lengths",
    "count_missing",
    "crc32_spans",
    "crc32_spans_reference",
    "decode_hf2_device",
    "decode_rows",
    "decode_rows_general",
    "decode_rows_general_reference",
    "decode_rows_reference",
    "decode_tile_rows",
    "decoder_for",
    "encode_blocks",
    "encode_blocks_reference",
    "first_level_table",
    "histogram",
    "histogram_grid",
    "histogram_reference",
    "lane_rows",
    "lane_rows_reference",
    "make_canonical_decode_tables",
    "make_decode_tables",
    "make_encode_tables",
    "new_carry",
    "out_words",
    "payload_to_lane_words",
    "row_width",
    "stitch_capacity",
    "stitch_lanes",
    "stitch_lanes_reference",
    "words_to_payload",
]
