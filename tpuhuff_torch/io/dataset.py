"""Shared-tree and adaptive dataset compression (config 4) on the device.

Counterpart of :mod:`tpuhuff.io.dataset`, writing the same containers as
its ``device=True`` route.  Many files (shards) are compressed with
frequency tables that are not rebuilt per file:

* **Shared mode** (default): ONE tree for the whole dataset, from a
  sampled pass over the shards (or over ``tree_from``), Laplace-smoothed so
  that every byte value has a code; each shard is then ONE pass on the
  card (:func:`read_compress_write_hf2` with ``tree=``), with no pass-1
  histogram.
* **Adaptive mode** (``adaptive=True``): shard k's exact histogram is
  counted by the same launches that encode it (K5,
  ``read_compress_write_hf2(collect_hist=True)``) and becomes shard k+1's
  tree; still one pass per shard, while the tables follow drifting data.

Every container carries its own tree, so each shard decodes on its own
(:func:`decompress_dataset`).  On a device the trees are the device's:
limited to 16-bit codes and canonical.  ``device="host"`` takes the
port's host C++ writers and reader instead, with the JAX package's
``device=False`` trees (not length-limited), and imports no torch.
"""

from __future__ import annotations

import functools
import os
from typing import Iterable, Sequence

import numpy as np

from ..core.canonical import build_tree_for_device, canonicalize
from ..core.tree import HuffTree
from ..core.weights import ByteWeights
from .host import (
    _CHUNK,
    _sampled_pieces,
    read_compress_write_hf2_host,
    read_compress_write_host,
    read_decompress_write,
    read_decompress_write_hf2_host,
)

__all__ = ["build_shared_tree", "compress_dataset", "decompress_dataset",
           "tree_from_counts"]


def tree_from_counts(counts: np.ndarray, device: bool = True,
                     canonical: bool = True, smooth: bool = True,
                     max_len: int | None = None) -> HuffTree:
    """Tree from a 256-bin count table: Laplace-smoothed (``smooth``: +1 in
    every bin, so any shard encodes and the missing-letter check cannot
    fire), length-limited to ``max_len`` (default 16) bits when ``device``,
    canonical when ``canonical``.  Smoothing gives rare bytes count 1,
    whose unlimited codes on a ~100 MB shard run ~26 bits; the 16-bit
    limit costs almost nothing on such bytes and keeps the decode short."""
    c = np.asarray(counts, dtype=np.int64)
    if smooth:
        c = c + 1
    if device:
        ml = 16 if max_len is None else max_len
        tree, _limited = build_tree_for_device(ByteWeights(c), max_len=ml)
    else:
        tree = HuffTree.from_weights(ByteWeights(c))
    return canonicalize(tree) if canonical else tree


def build_shared_tree(
    paths: Sequence[str] | str,
    hist_sample: int = 8,
    device: bool = True,
    canonical: bool = True,
    max_bytes_per_file: int | None = None,
) -> HuffTree:
    """ONE tree for a whole dataset, from a sampled histogram of ``paths``
    on the host: the first ``1/hist_sample`` of each 64 MiB piece, at most
    ``max_bytes_per_file`` bytes of each file; then :func:`tree_from_counts`."""
    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    counts = np.zeros(256, dtype=np.int64)
    for path in paths:
        left = os.path.getsize(path)
        if max_bytes_per_file is not None:
            left = min(left, max_bytes_per_file)
        with open(path, "rb") as fp:
            for piece in _sampled_pieces(fp, left, _CHUNK, hist_sample):
                counts += np.asarray(ByteWeights.from_bytes(piece).counts,
                                     dtype=np.int64)
    return tree_from_counts(counts, device=device, canonical=canonical)


def _on_host(device) -> bool:
    return isinstance(device, str) and device == "host"


def _dst_paths(srcs: Sequence[str], dsts, out_dir, ext: str) -> list:
    if dsts is not None:
        if len(dsts) != len(srcs):
            raise ValueError(
                f"dsts has {len(dsts)} entries for {len(srcs)} sources")
        return list(dsts)
    base = out_dir if out_dir is not None else "."
    os.makedirs(base, exist_ok=True)
    return [os.path.join(base, os.path.basename(s) + "." + ext)
            for s in srcs]


def compress_dataset(
    srcs: Iterable[str],
    out_dir: str | None = None,
    dsts: Sequence[str] | None = None,
    tree: HuffTree | None = None,
    tree_from: Sequence[str] | str | None = None,
    hist_sample: int = 8,
    adaptive: bool = False,
    device="cuda",
    hf2: bool = True,
    block_len: int | None = None,
    check: bool = True,
    canonical: bool = True,
    stats: dict | None = None,
) -> list:
    """Compress many files under shared frequency tables on ``device`` (a
    torch device; ``"cpu"`` runs the kernels' plain versions; ``"host"``
    the host C++ writers, as the JAX package's ``device=False``).  Returns
    the output paths: ``dsts``, or ``<out_dir>/<name>.hf2`` (``.hff`` when
    not ``hf2``).

    The first tree is ``tree``, else :func:`build_shared_tree` over
    ``tree_from``, else over ``srcs[:1]`` when ``adaptive``, else over all
    of ``srcs``.  Shared mode encodes every shard with it; ``adaptive``
    rebuilds it after each shard but the last from that shard's histogram,
    counted during its encode (``.hf2`` only: ``adaptive`` with ``hf2=False``
    raises :class:`ValueError`).  ``stats`` receives ``tree_builds``,
    ``bytes`` (input) and ``ratio`` (output / input).
    """
    srcs = [os.fspath(s) for s in srcs]
    if not srcs:
        return []
    if adaptive and not hf2:
        raise ValueError("adaptive refresh requires the .hf2 writer "
                         "(the .hff path gathers no encode-time histogram)")
    on_device = not _on_host(device)
    if on_device:
        from .stream import (
            _resolve,
            read_compress_write,
            read_compress_write_hf2,
        )

        dev = _resolve(device)
        write_hf2 = functools.partial(read_compress_write_hf2, device=dev)
        write_hff = functools.partial(read_compress_write, device=dev)
    else:
        write_hf2 = read_compress_write_hf2_host
        write_hff = read_compress_write_host
    outs = _dst_paths(srcs, dsts, out_dir, "hf2" if hf2 else "hff")
    tree_builds = 0
    if tree is None:
        seed = tree_from if tree_from is not None else (
            srcs[:1] if adaptive else srcs)
        tree = build_shared_tree(seed, hist_sample=hist_sample,
                                 device=on_device, canonical=canonical)
        tree_builds += 1
    total_in = total_out = 0
    for k, (src, dst) in enumerate(zip(srcs, outs)):
        if hf2:
            # the last shard's histogram would build a tree nothing uses
            refresh = adaptive and k + 1 < len(srcs)
            hist = write_hf2(src, dst, block_len=block_len,
                             canonical=canonical, check=check, tree=tree,
                             collect_hist=refresh)
            if refresh:
                tree = tree_from_counts(hist, device=on_device,
                                        canonical=canonical)
                tree_builds += 1
        else:
            write_hff(src, dst, tree=tree)
        total_in += os.path.getsize(src)
        total_out += os.path.getsize(dst)
    if stats is not None:
        stats["tree_builds"] = tree_builds
        stats["bytes"] = total_in
        stats["ratio"] = total_out / max(total_in, 1)
    return outs


def decompress_dataset(
    srcs: Iterable[str],
    out_dir: str | None = None,
    dsts: Sequence[str] | None = None,
    device="cuda",
    check: bool = True,
    threads: int | None = None,
) -> list:
    """Decode a dataset's shards (the inverse of :func:`compress_dataset`):
    ``.hf2`` shards on ``device`` (:func:`read_decompress_write_hf2`;
    ``"host"``: :func:`read_decompress_write_hf2_host`, on ``threads``
    threads), ``.hff`` shards on the host (:func:`read_decompress_write`),
    as the JAX package does.  Output names strip the container extension
    (``x.bin.hf2 -> x.bin``); other names get ``.dec``."""
    srcs = [os.fspath(s) for s in srcs]
    if _on_host(device):
        decode_hf2 = read_decompress_write_hf2_host
    else:
        from .stream import _resolve, read_decompress_write_hf2

        dev = _resolve(device)
        decode_hf2 = functools.partial(read_decompress_write_hf2, device=dev)
    if dsts is None:
        base = out_dir if out_dir is not None else "."
        os.makedirs(base, exist_ok=True)
        dsts = []
        for s in srcs:
            name = os.path.basename(s)
            root, ext = os.path.splitext(name)
            dsts.append(os.path.join(
                base, root if ext in (".hf2", ".hff") else name + ".dec"))
    elif len(dsts) != len(srcs):
        raise ValueError(f"dsts has {len(dsts)} entries for {len(srcs)} sources")
    for src, dst in zip(srcs, dsts):
        if src.endswith(".hff"):
            read_decompress_write(src, dst)
        else:
            decode_hf2(src, dst, check=check, threads=threads)
    return list(dsts)
