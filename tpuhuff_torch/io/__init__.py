"""Streaming ``.hf2`` file codec on the device (PyTorch + CUDA)."""

from .stream import read_compress_write_hf2, read_decompress_write_hf2

__all__ = ["read_compress_write_hf2", "read_decompress_write_hf2"]
