"""The port's bounded-memory contract (the reference's: ``README.md``,
``tests/test_stream.py::test_hf2_bounded_memory_large_file``).

* The host routes round-trip 1.5 GiB under a 1 GiB ``RLIMIT_AS``: the
  host modules import no torch, and the runtime caps glibc's malloc
  arenas (``tpuhuff_torch.native._bound_arenas``), so the address space
  stays bounded with one runtime thread per core.
* The device route on the CPU (the kernels' plain versions), at a small
  ``chunk_bytes``: its peak RSS does not grow with the file.  (The plain
  versions' temporaries grow with the chunk, so the small chunk is what
  bounds them here.)

Each runs in a subprocess, so that the limit and the peak are its own.
"""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script: str, timeout: int) -> str:
    env = {k: v for k, v in os.environ.items()
           if k not in ("MALLOC_ARENA_MAX", "PYTHONPATH")}
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=timeout, env=env, cwd=ROOT)
    assert r.returncode == 0, (r.stdout, r.stderr[-3000:])
    return r.stdout


def test_host_round_trip_under_address_space_cap(tmp_path):
    """1.5 GiB (96 x 16 MiB of ``integers(0, 64)``) through
    ``read_compress_write_hf2_host`` and ``read_decompress_write_hf2_host``
    under a 1 GiB ``RLIMIT_AS``, on every core, ``MALLOC_ARENA_MAX`` unset."""
    from tpuhuff_torch import native

    native.lib()  # built here, so that no g++ runs under the limit
    script = f"""
import hashlib, os, resource, sys
sys.path.insert(0, {ROOT!r})
import numpy as np
resource.setrlimit(resource.RLIMIT_AS, (1 << 30, 1 << 30))
from tpuhuff_torch.io.host import (
    read_compress_write_hf2_host, read_decompress_write_hf2_host)
assert 'torch' not in sys.modules
src = {str(tmp_path / 'big.bin')!r}
h = hashlib.sha256()
with open(src, 'wb') as f:
    base = np.random.default_rng(0).integers(0, 64, 1 << 24,
                                             dtype=np.uint8).tobytes()
    for _ in range(96):  # 96 * 16 MiB = 1.5 GiB
        f.write(base)
        h.update(base)
hf2, back = src + '.hf2', src + '.back'
read_compress_write_hf2_host(src, hf2, block_len=1 << 20, chunk_bytes=64 << 20)
os.remove(src)
read_decompress_write_hf2_host(hf2, back, chunk_bytes=64 << 20)
h2 = hashlib.sha256()
with open(back, 'rb') as f:
    for piece in iter(lambda: f.read(1 << 24), b''):
        h2.update(piece)
assert h2.hexdigest() == h.hexdigest(), 'round trip mismatch'
assert os.path.getsize(hf2) < 1_300_000_000
print('OK', os.cpu_count())
"""
    assert _run(script, 600).startswith("OK")


def _peak_rss_mib(tmp_path, mib: int) -> float:
    """Peak RSS of a device round trip (``device="cpu"``, 256 KiB chunks)
    of ``mib`` MiB, in its own process."""
    script = f"""
import sys
sys.path.insert(0, {ROOT!r})
import numpy as np
from tpuhuff_torch.io import read_compress_write_hf2, read_decompress_write_hf2
src = {str(tmp_path / f'{mib}.bin')!r}
data = np.random.default_rng(1).integers(0, 64, 1 << 20, dtype=np.uint8)
with open(src, 'wb') as f:
    for _ in range({mib}):
        f.write(data.tobytes())
del data
read_compress_write_hf2(src, src + '.hf2', device='cpu', chunk_bytes=1 << 18)
read_decompress_write_hf2(src + '.hf2', src + '.out', device='cpu',
                          chunk_bytes=1 << 18)
with open(src, 'rb') as a, open(src + '.out', 'rb') as b:
    while True:
        x, y = a.read(1 << 20), b.read(1 << 20)
        assert x == y, 'round trip mismatch'
        if not x:
            break
# this process's own peak (ru_maxrss would hold the parent's from before
# the exec)
with open('/proc/self/status') as f:
    print(next(int(l.split()[1]) for l in f if l.startswith('VmHWM')) / 1024)
"""
    return float(_run(script, 300).split()[-1])


@pytest.mark.parametrize("sizes_mib", [(8, 40)])
def test_device_route_peak_rss_does_not_grow(tmp_path, sizes_mib):
    """The CPU device route at 256 KiB chunks: 32 MiB more file, not
    16 MiB more peak RSS, and under 1 GiB at either size."""
    small, large = (_peak_rss_mib(tmp_path, mib) for mib in sizes_mib)
    assert large - small < 16, (small, large)
    assert max(small, large) < 1024, (small, large)
