"""Codec errors shared by the port's writers (from :mod:`tpuhuff.core.format`)."""

from __future__ import annotations

from typing import Hashable

__all__ = ["CompressError"]


class CompressError(ValueError):
    """A letter of the input has no code in the tree."""

    def __init__(self, message: str, missing_letter: Hashable):
        super().__init__(f"{message} ({missing_letter!r})")
        self.missing_letter = missing_letter
