"""A route check: the share of the blocks the decoders K2 and K4 decoded
on the card that took their global-rows route (one thread block per
Huffman block, rows read from device memory), the wrappers'
``global_blocks`` over their ``blocks``, summed over ``decode_rows`` and
``decode_rows_general``, for the whole process (the warm call, the
window's calls and the check's).  A cell's block length fixes it (1.0 at
64 KiB blocks), so it shows which route the cell ran and does not move
with the rate.  Null where the program has no such counters, or no block
was decoded on the card (a call handed to the host decoder launches
neither)."""

from harness import null


def value(run):
    from tpuhuff_torch.kernels import decode

    fns = (decode.decode_rows, decode.decode_rows_general)
    if not all(hasattr(fn, "blocks") and hasattr(fn, "global_blocks")
               for fn in fns):
        return null(run, "the program lacks the decoders' blocks and "
                    "global_blocks counters")
    blocks = sum(fn.blocks for fn in fns)
    if not blocks:
        return null(run, "no block was decoded on the card")
    return sum(fn.global_blocks for fn in fns) / blocks
