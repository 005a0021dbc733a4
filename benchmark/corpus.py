"""The bytes of a cell's objects, made from ``--seed`` alone.

A configuration names its corpus as parts, each a recipe and a share of
every object (``{"parts": [{"recipe": "textlike", "share": 1}]}``); the
parts follow one another in the object, the last taking what the shares
leave.  Object ``k`` of seed ``s`` draws from its own generator, seeded by
``(s, k)``, so the same seed gives the same bytes on any machine and each
object differs from the others.

The recipes are frozen copies of those the repository's smoke script
(``chip_smoke.py``) has used since config 2 and config 3 were first run:

* ``textlike``: an English and XML sentence repeated, with one byte in 64,
  at random places, replaced by a random byte (enwik8-like text: a
  14-bit-deep tree, ~0.57 of the input as payload);
* ``uniform``: random bytes (no compression: 8-bit codes);
* ``geometric``: P(byte >= k) = ``q``**k, capped at 255, by the inverse
  CDF at 16-bit resolution (most bytes small, a long tail).
"""

from __future__ import annotations

import numpy as np

TEXT = (
    b"the of and to in a is that it was for on are as with his they at "
    b"<page><title>Benchmark</title><revision><text xml:space=\"preserve\">"
    b"In information theory, a Huffman code is a particular type of optimal "
    b"prefix code that is commonly used for lossless data compression. "
)


def textlike(n: int, rng: np.random.Generator) -> np.ndarray:
    out = np.frombuffer(TEXT * (n // len(TEXT) + 1), dtype=np.uint8)[:n].copy()
    idx = rng.integers(0, max(n, 1), n // 64)
    out[idx] = rng.integers(0, 256, idx.size, dtype=np.uint8)
    return out


def uniform(n: int, rng: np.random.Generator) -> np.ndarray:
    return np.frombuffer(rng.bytes(n), dtype=np.uint8).copy()


def geometric(n: int, rng: np.random.Generator, q: float = 0.98) -> np.ndarray:
    u = (np.arange(1 << 16) + 0.5) / (1 << 16)
    lut = np.minimum(np.floor(np.log1p(-u) / np.log(q)), 255).astype(np.uint8)
    draws = np.frombuffer(rng.bytes(2 * n), dtype=np.uint16)
    return lut[draws]


RECIPES = {"textlike": textlike, "uniform": uniform, "geometric": geometric}


def make(corpus: dict, n: int, seed: int, k: int) -> np.ndarray:
    """Object ``k`` (``n`` bytes) of ``corpus`` under ``seed``."""
    rng = np.random.default_rng([int(seed) % (1 << 64), int(k)])
    parts = corpus["parts"]
    total = sum(p["share"] for p in parts)
    out = np.empty(n, dtype=np.uint8)
    lo = 0
    for i, part in enumerate(parts):
        hi = n if i == len(parts) - 1 else lo + n * part["share"] // total
        args = {key: v for key, v in part.items()
                if key not in ("recipe", "share")}
        out[lo:hi] = RECIPES[part["recipe"]](hi - lo, rng, **args)
        lo = hi
    return out
