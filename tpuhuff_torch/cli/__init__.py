"""``huff``-compatible command line of the port."""

from .main import CliError, main, parse_block_size

__all__ = ["CliError", "main", "parse_block_size"]
