"""``python -m tpuhuff_torch.cli`` — the same entry as ``python -m tpuhuff_torch``."""

import sys

from .main import main

sys.exit(main())
