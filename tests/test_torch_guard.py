"""Structural guards of the tpuhuff_torch port: hand-written kernels only,
no JAX anywhere in the package, a launch counter on every kernel wrapper."""

import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "tpuhuff_torch")

FORBIDDEN = ["torch.compile", "scaled_dot_product_attention", "import jax",
             "from jax", "import triton"]


def _sources():
    for dirpath, _, files in os.walk(PKG):
        if "_build" in dirpath or "__pycache__" in dirpath:
            continue
        for name in files:
            if name.endswith((".py", ".cu", ".cuh")):
                yield os.path.join(dirpath, name)


@pytest.mark.parametrize("needle", FORBIDDEN)
def test_no_library_kernel_or_jax_in_port(needle):
    hits = [path for path in _sources()
            if needle in open(path, encoding="utf-8").read()]
    assert not hits, f"{needle!r} found in {hits}"


@pytest.mark.parametrize("kernel", ["encode", "decode", "histogram"])
def test_cuda_sources_and_launch_counters(kernel):
    src = os.path.join(PKG, "csrc", f"{kernel}.cu")
    text = open(src, encoding="utf-8").read()
    assert re.search(r"__global__", text)
    assert "Replaces tpuhuff/kernels/pallas_" in text  # the note on its origin
    import tpuhuff_torch.kernels as k

    wrapper = {"encode": k.encode_blocks, "decode": k.decode_rows,
               "histogram": k.histogram}[kernel]
    assert isinstance(wrapper.launches, int)


def test_port_runs_without_jax():
    code = (
        "import sys, tempfile, os\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import numpy as np\n"
        "import tpuhuff_torch\n"
        "from tpuhuff_torch.io import read_compress_write_hf2, "
        "read_decompress_write_hf2\n"
        "d = tempfile.mkdtemp()\n"
        "data = np.random.default_rng(0).integers(0, 40, 3000, dtype=np.uint8)\n"
        "src, hf2, out = (os.path.join(d, n) for n in ('a', 'b', 'c'))\n"
        "open(src, 'wb').write(data.tobytes())\n"
        "read_compress_write_hf2(src, hf2, device='cpu')\n"
        "read_decompress_write_hf2(hf2, out, device='cpu')\n"
        "assert open(out, 'rb').read() == data.tobytes()\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules "
        "if m.startswith('jax'))\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
