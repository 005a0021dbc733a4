"""Structural guards of the tpuhuff_torch port: hand-written kernels only,
no JAX and nothing of the JAX package anywhere in the port, a launch
counter on every kernel wrapper."""

import ast
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


# an import of the JAX package (``tpuhuff`` or ``tpuhuff.x``), not of the port
JAX_PACKAGE_IMPORT = re.compile(r"^\s*(from|import)\s+tpuhuff(\.|\s|$)",
                                re.MULTILINE)


def _python_files():
    yield os.path.join(ROOT, "chip_smoke.py")
    for path in _sources():
        if path.endswith(".py"):
            yield path


@pytest.mark.parametrize("path", sorted(
    os.path.relpath(p, ROOT) for p in _python_files()))
def test_port_imports_nothing_of_the_jax_package(path):
    text = open(os.path.join(ROOT, path), encoding="utf-8").read()
    hits = [m.group(0).strip() for m in JAX_PACKAGE_IMPORT.finditer(text)]
    assert not hits, f"{path} imports the JAX package: {hits}"


@pytest.mark.parametrize("kernel", ["encode", "encode_hist", "decode",
                                    "decode_general", "histogram"])
def test_cuda_sources_and_launch_counters(kernel):
    """Each kernel has its CUDA source, with the note on the TPU kernel it
    replaces, and a launch counter of its own (K5 shares K1's source and
    wrapper, and counts in ``encode_blocks.hist_launches``)."""
    source = {"encode_hist": "encode"}.get(kernel, kernel)
    text = open(os.path.join(PKG, "csrc", f"{source}.cu"),
                encoding="utf-8").read()
    assert re.search(r"__global__", text)
    assert "Replaces tpuhuff/kernels/pallas_" in text  # the note on its origin
    import tpuhuff_torch.kernels as k

    wrapper, counter = {
        "encode": (k.encode_blocks, "launches"),
        "encode_hist": (k.encode_blocks, "hist_launches"),
        "decode": (k.decode_rows, "launches"),
        "decode_general": (k.decode_rows_general, "launches"),
        "histogram": (k.histogram, "launches")}[kernel]
    assert isinstance(getattr(wrapper, counter), int)


@pytest.mark.parametrize("kernel", ["stitch", "lane_rows"])
def test_host_stage_kernels_sources_and_counters(kernel):
    """The two kernels that took the JAX package's host stages onto the
    card (S1, S2) have their CUDA source, with the note on the host
    function each replaces (no Pallas kernel computes either), and a
    launch counter."""
    text = open(os.path.join(PKG, "csrc", f"{kernel}.cu"),
                encoding="utf-8").read()
    assert re.search(r"__global__", text)
    replaces = {"stitch": "Replaces tpuhuff/dist/__init__.py::stitch_words",
                "lane_rows": "Replaces tpuhuff/kernels/decode.py::"
                             "payload_to_lane_words"}[kernel]
    assert replaces in " ".join(text.split())
    import tpuhuff_torch.kernels as k

    wrapper = {"stitch": k.stitch_lanes, "lane_rows": k.lane_rows}[kernel]
    assert isinstance(wrapper.launches, int)


def _imported_modules(path: str):
    """The absolute names of the modules the port's file ``path`` imports
    (for ``from x import y``, also ``x.y``: ``y`` may be a module)."""
    package = os.path.relpath(os.path.dirname(path), ROOT).split(os.sep)
    for node in ast.walk(ast.parse(open(path, encoding="utf-8").read())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = package[: len(package) + 1 - node.level] if node.level else []
            mod = ".".join(base + ([node.module] if node.module else []))
            yield mod
            yield from (f"{mod}.{a.name}" for a in node.names)


@pytest.mark.parametrize("layer,below", [
    ("kernels", "io"), ("kernels", "dist"), ("io", "dist")])
def test_imports_point_one_way(layer, below):
    """The layers' arrows point down only: the kernels import nothing of
    the file path (``io``) or of the mesh pipelines (``dist``), and the
    file path nothing of ``dist``, which sits beside it and reuses it."""
    forbidden = f"tpuhuff_torch.{below}"
    root = os.path.join(PKG, layer)
    hits = []
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                hits += [(os.path.relpath(path, ROOT), m)
                         for m in _imported_modules(path)
                         if m == forbidden or m.startswith(forbidden + ".")]
    assert not hits, f"{layer} imports {below}: {hits}"


def test_port_runs_without_jax():
    """A canonical and a non-canonical round trip, an adaptive dataset and
    a ``.hff`` round trip on the CPU load neither JAX nor any module of the
    JAX package."""
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
        "for canonical in (True, False):\n"
        "    read_compress_write_hf2(src, hf2, device='cpu', canonical=canonical)\n"
        "    read_decompress_write_hf2(hf2, out, device='cpu')\n"
        "    assert open(out, 'rb').read() == data.tobytes()\n"
        "from tpuhuff_torch.io import compress_dataset, decompress_dataset\n"
        "outs = compress_dataset([src, src], dsts=[hf2, hf2 + 'x'], "
        "adaptive=True, device='cpu')\n"
        "outs += compress_dataset([src], dsts=[hf2 + '.hff'], hf2=False, "
        "device='cpu')\n"
        "for dec in decompress_dataset(outs, dsts=[out] * 3, device='cpu'):\n"
        "    assert open(dec, 'rb').read() == data.tobytes()\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules "
        "if m.startswith('jax'))\n"
        "bad = sorted(m for m in sys.modules "
        "if m == 'tpuhuff' or m.startswith('tpuhuff.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_guard_covers_the_host_and_entry_modules():
    """The import guard above scans the command line, the profiling and
    the index modules."""
    scanned = {os.path.relpath(p, ROOT) for p in _python_files()}
    for path in ("tpuhuff_torch/cli/main.py", "tpuhuff_torch/cli/__init__.py",
                 "tpuhuff_torch/cli/__main__.py", "tpuhuff_torch/__main__.py",
                 "tpuhuff_torch/profiling.py", "tpuhuff_torch/io/index.py",
                 "tpuhuff_torch/io/host.py", "tpuhuff_torch/native.py",
                 "tpuhuff_torch/core/codec.py", "tpuhuff_torch/io/crc.py",
                 "tpuhuff_torch/dist/block.py", "tpuhuff_torch/dist/mesh.py",
                 "tpuhuff_torch/dist/multihost.py",
                 "tpuhuff_torch/dist/dryrun.py"):
        assert path in scanned, path


def _run_python(code: str) -> None:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", f"import sys\n"
                        f"sys.path.insert(0, {ROOT!r})\n" + code],
                       capture_output=True, text=True, timeout=120, env=env,
                       cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


@pytest.mark.parametrize("module", [
    "tpuhuff_torch", "tpuhuff_torch.core", "tpuhuff_torch.native",
    "tpuhuff_torch.io", "tpuhuff_torch.io.hff", "tpuhuff_torch.io.host",
    "tpuhuff_torch.io.index", "tpuhuff_torch.io.dataset",
    "tpuhuff_torch.profiling", "tpuhuff_torch.cli",
    "tpuhuff_torch.core.codec", "tpuhuff_torch.core.utils",
    "tpuhuff_torch.io.crc"])
def test_host_modules_import_without_torch(module):
    """The host layers import no torch, so that a host-only use keeps its
    address space small."""
    _run_python(
        "import importlib\n"
        f"importlib.import_module({module!r})\n"
        "assert 'torch' not in sys.modules, sorted(\n"
        "    m for m in sys.modules if m.startswith('tpuhuff_torch'))\n"
        "print('ok')\n")


def test_in_memory_codec_loads_no_torch():
    """``tpuhuff_torch.compress`` / ``decompress`` are a host path: the
    package's lazy names bring in no torch for them."""
    _run_python(
        "import tpuhuff_torch\n"
        "data = bytes(range(256)) * 40 + b'abbccc' * 999\n"
        "comp = tpuhuff_torch.compress(data)\n"
        "raw = comp.to_bytes()\n"
        "back = tpuhuff_torch.CompressData.try_from_bytes(raw)\n"
        "assert tpuhuff_torch.decompress(back) == data\n"
        "assert tpuhuff_torch.decompress(tpuhuff_torch.compress([1, 2, 2]))"
        " == bytes([1, 2, 2])\n"
        "assert tpuhuff_torch.compress(b'abbccc').to_bytes().hex() == "
        "'370000000498e61310bc00'\n"
        "assert 'torch' not in sys.modules, sorted(\n"
        "    m for m in sys.modules if m.startswith('tpuhuff_torch'))\n"
        "print('ok')\n")


def test_lazy_names_load_the_device_modules():
    """Every public name of ``tpuhuff_torch`` and ``tpuhuff_torch.io``
    still loads, the device ones with torch."""
    _run_python(
        "import tpuhuff_torch, tpuhuff_torch.io as io\n"
        "assert 'torch' not in sys.modules\n"
        "from tpuhuff_torch.io import read_compress_write_hf2\n"
        "assert 'torch' in sys.modules\n"
        "assert sorted(io.__all__) == sorted(io._EXPORTS)\n"
        "for pkg in (tpuhuff_torch, io):\n"
        "    for name in pkg.__all__:\n"
        "        assert callable(getattr(pkg, name)), name\n"
        "    assert set(pkg.__all__) <= set(dir(pkg))\n"
        "try:\n"
        "    io.no_such_name\n"
        "except AttributeError:\n"
        "    print('ok')\n")
