#!/usr/bin/env python3
"""Address space of the port's host round trip under a 1 GiB RLIMIT_AS.

Round-trips a file (default 1.5 GiB: 96 x 16 MiB of ``integers(0, 64)``)
through ``read_compress_write_hf2_host`` and
``read_decompress_write_hf2_host`` in a child process whose address space
is capped at 1 GiB, once per variant of the host runtime:

* ``as is`` — the runtime as shipped (malloc arenas capped by
  ``tpuhuff_torch.native._bound_arenas``, a thread per core);
* ``no arena cap`` — ``_bound_arenas`` made a no-op;
* ``no arena cap, N threads`` — no arena cap, ``num_threads()`` = N.

Each line gives the outcome (OK or MemoryError), the child's peak
address space (``VmPeak``) and peak RSS (``VmHWM``), and its seconds.
``MALLOC_ARENA_MAX`` is removed from the children's environment.  Run
from the root of a checkout:

    python3 experiments/host_address_space.py [--mib 1536] [--threads 4]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = """
import os, resource, sys, time
sys.path.insert(0, {root!r})
from tpuhuff_torch import native
variant, threads, src = {variant!r}, {threads!r}, {src!r}
if variant != "as is":
    native._bound_arenas = lambda: None
if threads:
    native.num_threads = lambda: threads
resource.setrlimit(resource.RLIMIT_AS, (1 << 30, 1 << 30))
from tpuhuff_torch.io.host import (
    read_compress_write_hf2_host, read_decompress_write_hf2_host)
t0 = time.perf_counter()
try:
    read_compress_write_hf2_host(src, src + ".hf2", block_len=1 << 20,
                                 chunk_bytes=64 << 20)
    read_decompress_write_hf2_host(src + ".hf2", src + ".back",
                                   chunk_bytes=64 << 20)
    outcome = "OK"
except MemoryError:
    outcome = "MemoryError"
status = dict(line.split(":", 1) for line in open("/proc/self/status"))
print(outcome, status["VmPeak"].strip(), status["VmHWM"].strip(),
      f"{{time.perf_counter() - t0:.1f}} s")
for path in (src + ".hf2", src + ".back"):
    if os.path.exists(path):
        os.remove(path)
"""


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mib", type=int, default=1536)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np

    from tpuhuff_torch import native

    native.lib()  # built here: no g++ under the limit
    env = {k: v for k, v in os.environ.items() if k != "MALLOC_ARENA_MAX"}
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "big.bin")
        base = np.random.default_rng(0).integers(0, 64, 1 << 24,
                                                 dtype=np.uint8).tobytes()
        with open(src, "wb") as fp:
            for _ in range(args.mib // 16):
                fp.write(base)
        print(f"{os.path.getsize(src)} B, {os.cpu_count()} cores, "
              "RLIMIT_AS 1 GiB", flush=True)
        for variant, threads in (("as is", None), ("no arena cap", None),
                                 ("no arena cap", args.threads)):
            code = CHILD.format(root=ROOT, variant=variant, threads=threads,
                                src=src)
            r = subprocess.run([sys.executable, "-c", code], env=env,
                               capture_output=True, text=True, timeout=900)
            label = variant + (f", {threads} threads" if threads else "")
            out = r.stdout.strip() or f"exit {r.returncode}: {r.stderr[-300:]}"
            print(f"{label}: {out}", flush=True)


if __name__ == "__main__":
    main()
