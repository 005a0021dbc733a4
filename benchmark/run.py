"""Run one cell of the benchmark of ``tpuhuff_torch`` on this machine's card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is the
run's JSON result; the numbers compared with the plain reference are the
last lines of standard error.  See ``harness.py``.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# kernel and build caches at fixed places inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)
sys.path[:0] = [BENCH, ROOT]

import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
