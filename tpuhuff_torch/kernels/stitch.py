"""Device stitch: K1's lanes concatenated at the bit level on the card (S1).

Counterpart of the host function :func:`tpuhuff.dist.stitch_words` (no
Pallas kernel computes it: a TPU kernel cannot write at arbitrary bit
offsets, so the JAX package copies every lane's padded word row back and
stitches on the host).  :func:`stitch_lanes` takes K1's ``words`` and
``bits`` where they lie and a device **carry**, the previous chunk's
trailing partial byte, so that the chunks of a file chain on one stream
with no host sync; only the payload's bytes then cross to the host.
"""

from __future__ import annotations

import torch

from ..profiling import span
from . import _build

__all__ = ["new_carry", "stitch_lanes", "stitch_lanes_reference",
           "stitch_capacity"]

_U32 = 0xFFFFFFFF


def new_carry(device="cpu") -> torch.Tensor:
    """The carry of a stream's first chunk: ``(2,) int32`` ``[byte, n]``,
    no bits carried."""
    return torch.zeros(2, dtype=torch.int32, device=device)


def stitch_capacity(B: int, R: int) -> int:
    """Bytes of :func:`stitch_lanes`' payload for ``(B, R)`` words: room
    for 7 carried bits, every bit the words can hold, and one word the
    last shifted word may spill into."""
    return 4 * (B * R + 2)


def _check_args(words, bits, carry):
    if words.dim() != 2:
        raise ValueError("words must be (B, R) int32")
    B, R = words.shape
    dev = words.device
    _build.check_tensor(words, "words", torch.int32, (B, R), dev)
    _build.check_tensor(bits, "bits", torch.int32, (B,), dev)
    _build.check_tensor(carry, "carry", torch.int32, (2,), dev)
    return B, R


def stitch_lanes(words: torch.Tensor, bits: torch.Tensor,
                 carry: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Concatenate ``B`` lanes' bitstreams behind ``carry``'s bits.

    ``words`` (B, R) int32 holds each lane's u32 patterns MSB-first and
    ``bits`` (B,) int32 its exact bit count (K1's outputs; bits past a
    lane's count are ignored); ``carry`` (2,) int32 is ``[byte, n]``, the
    previous chunk's last ``n`` (0-7) bits in the high bits of ``byte``
    (:func:`new_carry` for none).  Returns ``(payload, carry_out)``:
    ``payload`` (:func:`stitch_capacity` bytes) uint8 holds the stream
    ``n`` carried bits, then lane 0's bits, lane 1's, ..., as big-endian
    bytes, zero past its end; ``carry_out`` is the next chunk's carry, the
    stream's last partial byte and ``(n + sum(bits)) % 8``.  The stream's
    whole bytes are ``(n + sum(bits)) // 8``.  CUDA tensors launch the
    kernel (``csrc/stitch.cu``; the lanes' start offsets from
    ``torch.cumsum``), two launches on the current stream counted once in
    ``stitch_lanes.launches``; CPU tensors take
    :func:`stitch_lanes_reference`.
    """
    B, R = _check_args(words, bits, carry)
    if words.device.type == "cpu":
        return stitch_lanes_reference(words, bits, carry)
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    with span("launch"):
        if B * R >= 1 << 31:
            raise ValueError(f"{B} x {R} words exceed one launch")
        dev = words.device
        ends = torch.cumsum(bits, 0, dtype=torch.int64)
        out = torch.zeros(stitch_capacity(B, R), dtype=torch.uint8, device=dev)
        carry_out = torch.empty(2, dtype=torch.int32, device=dev)
        _build.launch("tpuhuff_stitch_lanes", dev, words.data_ptr(),
                      bits.data_ptr(), ends.data_ptr(), carry.data_ptr(),
                      out.data_ptr(), carry_out.data_ptr(), B, R)
        stitch_lanes.launches += 1
        return out, carry_out


stitch_lanes.launches = 0


def stitch_lanes_reference(words: torch.Tensor, bits: torch.Tensor,
                           carry: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`stitch_lanes` (any device): each
    word's bit position from a ``cumsum`` of the lane counts, its two
    shifted halves ``scatter_add_``-ed into int64 words (the fields are
    disjoint, so the sum is the OR), then the words as big-endian bytes."""
    B, R = _check_args(words, bits, carry)
    dev = words.device
    nb = bits.long()
    lo = 32 * torch.arange(R, device=dev, dtype=torch.int64)
    left = nb[:, None] - lo[None, :]  # the lane's bits from each word on
    keep = (_U32 << (32 - left.clamp(0, 32))) & _U32
    w = (words.long() & _U32) & keep
    c = carry.long()
    n = c[1] & 7
    ends = torch.cumsum(nb, 0)
    pos = n + (ends - nb)[:, None] + lo[None, :]
    d, s = pos >> 5, pos & 31
    acc = torch.zeros(B * R + 2, dtype=torch.int64, device=dev)
    acc.scatter_add_(0, d.reshape(-1), (w >> s).reshape(-1))
    acc.scatter_add_(0, (d + 1).reshape(-1), ((w << (32 - s)) & _U32
                                              ).reshape(-1))
    acc[0] += ((c[0] & (0xFF00 >> n) & 0xFF) << 24)
    out = torch.stack([(acc >> k) & 0xFF for k in (24, 16, 8, 0)],
                      dim=1).to(torch.uint8).reshape(-1)
    total = n + (ends[-1] if B else 0)
    rem = total & 7
    last = out[(total >> 3).clamp(max=out.numel() - 1)]
    carry_out = torch.stack([torch.where(rem > 0, last.long(), 0), rem])
    return out, carry_out.to(torch.int32)
