"""Host ms per object in the tree build (``build_tree_for_device`` and
``canonicalize``)."""

from harness import null

SPANS = {"tree": ["tpuhuff_torch.io.stream:build_tree_for_device", "tpuhuff_torch.io.host:canonicalize"]}


def value(run):
    s, why = run.span_s("compress", "tree")
    return null(run, why) if s is None else s * 1e3 / len(run.of("compress"))
