"""Host ms per object building the kernels' tables (``make_encode_tables``
and ``decoder_for``)."""

from harness import null

SPANS = {"tables": ["tpuhuff_torch.io.stream:make_encode_tables", "tpuhuff_torch.io.stream:decoder_for"]}


def value(run):
    c, why = run.span_s("compress", "tables")
    if c is None:
        return null(run, why)
    d, why = run.span_s("decompress", "tables")
    if d is None:
        return null(run, why)
    return (c + d) * 1e3 / len(run.of("compress"))
