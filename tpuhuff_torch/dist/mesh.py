"""The 1-D device mesh of the block-parallel pipelines.

Counterpart of :mod:`tpuhuff.dist.mesh`.  Compression has one parallel
axis, independent input blocks, so a mesh is 1-D: here a tuple of
``torch.device``, one entry per shard.  An entry may repeat: a mesh of
``[cuda:0] * 4`` runs four shards on one card (the shape of a four-card
mesh on one card), and ``[cpu] * 8`` runs the kernels' plain versions, as
the JAX package's tests run its mesh on eight virtual host devices.

``block_sharding`` and ``replicated_sharding`` have no counterpart: with
no ``NamedSharding``, a pipeline places each shard itself.  Blocks are
split into equal contiguous ranges, shard k on ``mesh[k]``
(:func:`shard_ranges`), and the tables are copied to every device of the
mesh.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..kernels._build import resolve_device

__all__ = ["BLOCK_AXIS", "make_mesh", "resolve_device", "shard_ranges"]

BLOCK_AXIS = "blocks"

Mesh = Tuple[torch.device, ...]


def make_mesh(devices: Optional[Sequence] = None,
              n_devices: int | None = None) -> Mesh:
    """A 1-D mesh over ``devices`` (default: every CUDA device of the
    process, the first ``n_devices`` of them if given).  With no card the
    default raises: it never falls back to the CPU, which a caller asks
    for by naming it (``devices=[torch.device("cpu")] * 8``)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device (torch.cuda."
                               "is_available() is False); name the devices "
                               "to run on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            devices = devices[:n_devices]
    mesh = tuple(resolve_device(d) for d in devices)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def shard_ranges(n_blocks: int, mesh: Mesh) -> List[Tuple[int, int]]:
    """``[(lo, hi), ...]``: the blocks of each shard, equal contiguous
    ranges in mesh order.  ``n_blocks`` must be a multiple of the mesh
    size (:func:`~tpuhuff_torch.dist.pad_to_blocks` pads to one)."""
    n = len(mesh)
    if n_blocks % n:
        raise ValueError(f"{n_blocks} blocks do not split evenly over a mesh "
                         f"of {n}")
    per = n_blocks // n
    return [(k * per, (k + 1) * per) for k in range(n)]
