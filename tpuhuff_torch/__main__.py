"""``python -m tpuhuff_torch`` — the huff-compatible command line of the port."""

import sys

from .cli.main import main

sys.exit(main())
