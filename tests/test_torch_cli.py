"""The port's command line (``python -m tpuhuff_torch``) against
``tpuhuff.cli.main``.

Twins of the 12 tests of ``tests/test_cli.py``, of
``tests/test_r4_stream.py::test_cli_no_auto_index_flag`` and of the CLI
cases of ``tests/test_r5_dataset.py``.  Each runs the same argv through
both command lines, each in a directory of its own holding the same
inputs: the port's with ``--device host`` against the JAX command line's
host route (no ``--device``), or with ``--device cpu`` (the kernels'
plain versions) against the JAX device route on the JAX CPU backend
(``--device``).  Every file either writes must be byte-equal to the
other's, and the return codes equal.
"""

import io
import os
import subprocess
import sys

import numpy as np
import pytest

from tpuhuff.cli.main import main as jax_main

from tpuhuff_torch.cli import CliError, main, parse_block_size
from tpuhuff_torch.cli.main import _device_values

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUTES = ["host", "cpu"]


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            out[os.path.relpath(path, root)] = open(path, "rb").read()
    return out


class Both:
    """The two command lines, each in a directory of its own."""

    def __init__(self, tmp_path, monkeypatch, route, files):
        self.route, self.monkeypatch = route, monkeypatch
        self.dirs = {"port": tmp_path / "port", "jax": tmp_path / "jax"}
        for d in self.dirs.values():
            d.mkdir()
            for name, data in files.items():
                (d / name).write_bytes(data)

    def run(self, argv, stdin=None):
        """Run ``argv`` in both directories; returns the port's return
        code, which must be the JAX command line's."""
        rcs = {}
        for side, d in self.dirs.items():
            self.monkeypatch.chdir(d)
            if stdin is not None:
                self.monkeypatch.setattr("sys.stdin", io.StringIO(stdin))
            if side == "port":
                rcs[side] = main(["--device", self.route, *argv])
            else:
                extra = ["--device"] if self.route == "cpu" else []
                rcs[side] = jax_main([*extra, *argv])
        assert rcs["port"] == rcs["jax"], rcs
        return rcs["port"]

    def files(self):
        """The port's files, after checking them against the JAX side's."""
        port, jax = (_tree(d) for d in self.dirs.values())
        assert port.keys() == jax.keys()
        for name in port:
            assert port[name] == jax[name], name
        return port


def test_parse_block_size():
    # huff/src/cli.rs:79-114
    assert parse_block_size("2G") == 2_000_000_000
    assert parse_block_size("2g") == 2_000_000_000
    assert parse_block_size("1k") == 1000
    assert parse_block_size("3M") == 3_000_000
    assert parse_block_size("1Ki") == 1024
    assert parse_block_size("2Mi") == 2_097_152
    assert parse_block_size("1Gi") == 1_073_741_824
    assert parse_block_size("123") == 123
    for bad in ("0", "x", "1X", "", "1kk"):
        with pytest.raises(CliError):
            parse_block_size(bad)


@pytest.mark.parametrize("route", ROUTES)
def test_cli_compress_decompress(tmp_path, monkeypatch, route):
    data = np.random.default_rng(0).integers(0, 99, 10_000,
                                             dtype=np.uint8).tobytes()
    both = Both(tmp_path, monkeypatch, route, {"file.bin": data})
    assert both.run(["-n", "file.bin"]) == 0
    assert both.run(["-d", "-n", "file.bin.hff", "out.bin"]) == 0
    files = both.files()
    assert "file.bin.hff" in files and files["out.bin"] == data


@pytest.mark.parametrize("route", ROUTES)
def test_cli_default_dst_appends_hff(tmp_path, monkeypatch, route):
    both = Both(tmp_path, monkeypatch, route,
                {"data.txt": b"some text some text"})
    assert both.run(["-n", "data.txt"]) == 0
    # cli.rs:40-54: the extension goes after the existing one
    assert "data.txt.hff" in both.files()


def test_cli_decompress_strips_extension(tmp_path, monkeypatch):
    both = Both(tmp_path, monkeypatch, "host",
                {"x.bin": b"roundtrip me please!"})
    assert both.run(["-n", "x.bin"]) == 0
    assert both.run(["-d", "-n", "x.bin.hff"]) == 0
    assert both.files()["x.bin"] == b"roundtrip me please!"


def test_cli_decompress_requires_hff_ext(tmp_path, monkeypatch):
    both = Both(tmp_path, monkeypatch, "host", {"y.zip": b"data"})
    assert both.run(["-d", "-n", "y.zip"]) == 1  # UnrecognizedFormat
    assert both.files() == {"y.zip": b"data"}


def test_cli_replace_deletes_source(tmp_path, monkeypatch):
    both = Both(tmp_path, monkeypatch, "host",
                {"z.bin": b"delete me after compression"})
    assert both.run(["-n", "-r", "z.bin"]) == 0
    files = both.files()
    assert "z.bin" not in files and "z.bin.hff" in files


def test_cli_src_directory_error(tmp_path, monkeypatch):
    both = Both(tmp_path, monkeypatch, "host", {})
    for d in both.dirs.values():
        os.mkdir(d / "adir")
    assert both.run(["-n", "adir"]) == 1


def test_cli_time_and_stats(tmp_path, monkeypatch, capsys):
    both = Both(tmp_path, monkeypatch, "host", {"t.bin": b"abcabcabc" * 100})
    capsys.readouterr()
    monkeypatch.chdir(both.dirs["port"])
    assert main(["--device", "host", "-n", "-t", "--stats", "t.bin"]) == 0
    out = capsys.readouterr().out
    assert "ratio" in out and "s\n" in out
    monkeypatch.chdir(both.dirs["jax"])
    assert jax_main(["-n", "t.bin"]) == 0
    both.files()


@pytest.mark.parametrize("route", ROUTES)
def test_cli_hf2_flow(tmp_path, monkeypatch, route):
    data = np.random.default_rng(1).integers(0, 30, 50_000,
                                             dtype=np.uint8).tobytes()
    both = Both(tmp_path, monkeypatch, route, {"p.bin": data})
    assert both.run(["-n", "--hf2", "p.bin"]) == 0
    assert both.run(["-d", "-n", "--hf2", "p.bin.hf2", "q.bin"]) == 0
    files = both.files()
    assert "p.bin.hf2" in files and files["q.bin"] == data


def test_cli_overwrite_prompt_refusal(tmp_path, monkeypatch):
    both = Both(tmp_path, monkeypatch, "host",
                {"w.bin": b"www", "w.bin.hff": b"existing"})
    assert both.run(["w.bin"], stdin="no\n") == 0
    # refused: the existing file is untouched
    assert both.files()["w.bin.hff"] == b"existing"
    assert both.run(["w.bin"], stdin="y\n") == 0
    assert both.files()["w.bin.hff"] != b"existing"


@pytest.mark.parametrize("route", ROUTES)
def test_cli_stats_with_replace_reports_true_ratio(tmp_path, monkeypatch,
                                                   capsys, route):
    data = bytes(1000) + b"ab" * 500
    both = Both(tmp_path, monkeypatch, route, {"f.bin": data})
    capsys.readouterr()
    assert both.run(["-n", "-r", "--stats", "f.bin"]) == 0
    port_out = capsys.readouterr().out.split("\n\n")[0]
    assert f"{len(data)} ->" in port_out
    ratio = float(port_out.split("ratio ")[1].split(")")[0])
    assert ratio < 0.9  # compressible input: the ratio must not read ~1.0
    assert set(both.files()) == {"f.bin.hff"}


@pytest.mark.parametrize("route", ROUTES)
def test_cli_reindex_hff_to_hf2(tmp_path, monkeypatch, route):
    data = np.random.default_rng(3).integers(0, 150, 40_000,
                                             dtype=np.uint8).tobytes()
    both = Both(tmp_path, monkeypatch, route, {"f.bin": data})
    assert both.run(["-n", "f.bin"]) == 0
    assert both.run(["--reindex", "-n", "--hf2-block", "1Ki",
                     "f.bin.hff"]) == 0
    assert both.run(["-d", "-n", "--hf2", "f.bin.hf2", "out.bin"]) == 0
    files = both.files()
    assert "f.bin.hf2" in files and files["out.bin"] == data


def test_cli_no_auto_index_flag(tmp_path, monkeypatch):
    """Twin of ``tests/test_r4_stream.py::test_cli_no_auto_index_flag``,
    with the threshold below the file so that the flag is what acts."""
    from tpuhuff.io import stream as jax_stream

    from tpuhuff_torch.io import host

    monkeypatch.setattr(host, "AUTO_INDEX_MIN", 1)
    monkeypatch.setattr(jax_stream, "AUTO_INDEX_MIN", 1)
    rng = np.random.default_rng(3)
    text = b"the quick brown fox jumps over the lazy dog 0123456789 "
    data = bytearray((text * 800)[:40_000])
    for i in rng.integers(0, len(data), len(data) // 32):
        data[int(i)] = int(rng.integers(0, 256))
    both = Both(tmp_path, monkeypatch, "host", {"d.bin": bytes(data)})
    assert both.run(["-n", "d.bin"]) == 0
    assert both.run(["-d", "-n", "--no-auto-index", "d.bin.hff", "d.out"]) == 0
    files = both.files()
    assert files["d.out"] == data and "d.bin.hff.hf2x" not in files
    # without the flag the threshold indexes it: the same sidecar
    assert both.run(["-d", "-n", "d.bin.hff", "d2.out"]) == 0
    assert both.files()["d2.out"] == data
    assert "d.bin.hff.hf2x" in both.files()


def _shards(n=3, size=200_000):
    """``tests/test_r5_dataset.py``'s shards."""
    return {f"shard{k}.bin":
            ((b"shared frequency table over shards %d " % k) * 6000)[:size]
            for k in range(n)}


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("adaptive", [False, True])
def test_cli_dataset(tmp_path, monkeypatch, route, adaptive):
    shards = _shards()
    both = Both(tmp_path, monkeypatch, route, shards)
    argv = ["--dataset", *shards, "--out-dir", "cli", "-n"]
    assert both.run(argv + (["--adaptive"] if adaptive else [])) == 0
    for name, data in shards.items():
        assert both.run(["-d", "-n", "--hf2", f"cli/{name}.hf2",
                         f"{name}.dec"]) == 0
    files = both.files()
    for name, data in shards.items():
        assert files[f"{name}.dec"] == data


@pytest.mark.parametrize("route", ROUTES)
def test_cli_tree_from_single_file(tmp_path, monkeypatch, route):
    shards = _shards(n=2)
    both = Both(tmp_path, monkeypatch, route, shards)
    assert both.run(["--hf2", "--tree-from", "shard0.bin", "-n", "shard1.bin",
                     "one"]) == 0
    assert both.run(["-d", "-n", "--hf2", "one.hf2", "one.dec"]) == 0
    assert both.files()["one.dec"] == shards["shard1.bin"]


def test_cli_device_flag_values():
    """``--device`` with no value is ``cuda``; a value is taken only where
    it names a device, so ``--device SRC`` keeps SRC."""
    assert _device_values(["--device", "-n", "a"]) == ["--device=cuda", "-n",
                                                       "a"]
    assert _device_values(["--device", "a"]) == ["--device=cuda", "a"]
    assert _device_values(["--device", "cpu", "a"]) == ["--device=cpu", "a"]
    assert _device_values(["-n", "--device"]) == ["-n", "--device=cuda"]
    assert _device_values(["--device=host", "a"]) == ["--device=host", "a"]


def test_cli_cuda_without_a_card_fails(tmp_path, monkeypatch, capsys):
    """An explicit (or default) ``cuda`` route never becomes another."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(tmp_path)
    (tmp_path / "a.bin").write_bytes(b"abc" * 100)
    for argv in (["-n", "a.bin"], ["--device", "-n", "a.bin"],
                 ["--device", "cuda", "-n", "--hf2", "a.bin"]):
        assert main(argv) == 1
        assert "no CUDA device" in capsys.readouterr().err
    assert os.listdir(tmp_path) == ["a.bin"]


@pytest.mark.parametrize("route", ROUTES)
def test_cli_profile_prints_stages(tmp_path, monkeypatch, capsys, route):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "a.bin").write_bytes(b"profile these stages " * 500)
    assert main(["--device", route, "-n", "a.bin", "--profile"]) == 0
    out = capsys.readouterr().out
    for stage in ("histogram", "write", "total"):
        assert stage in out
    assert ("pack" in out) == (route == "cpu")


def test_cli_profile_prints_the_hf2_file_paths_stages(tmp_path, monkeypatch,
                                                      capsys):
    """``--profile`` on the ``.hf2`` device route prints the spans of the
    file path; with a directory, its trace holds them as ranges."""
    import json

    from tpuhuff_torch.profiling import RANGE_PREFIX, TRACE_FILE

    monkeypatch.chdir(tmp_path)
    data = b"profile the hf2 stages " * 900
    (tmp_path / "a.bin").write_bytes(data)
    assert main(["--device", "cpu", "-n", "--hf2", "a.bin", "--profile"]) == 0
    table = capsys.readouterr().out
    names = {line.split()[0] for line in table.splitlines()[1:]}
    assert {"compress", "pass1", "tree", "prelude", "write",
            "total"} <= names
    assert main(["--device", "cpu", "-d", "-n", "--hf2", "a.bin.hf2", "b",
                 "--profile", "trace"]) == 0
    names = {line.split()[0] for line in
             capsys.readouterr().out.splitlines()[1:]}
    assert {"decompress", "header", "tables", "write", "total"} <= names
    assert (tmp_path / "b").read_bytes() == data
    events = json.loads((tmp_path / "trace" / TRACE_FILE).read_text())
    ranges = {e.get("name", "") for e in events["traceEvents"]}
    assert {RANGE_PREFIX + "decompress", RANGE_PREFIX + "write"} <= ranges


def test_cli_host_route_imports_no_torch(tmp_path):
    """A ``--device host`` round trip of both containers, a reindex and a
    dataset leave torch (and JAX) out of ``sys.modules``."""
    code = (
        "import os, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        f"os.chdir({str(tmp_path)!r})\n"
        "open('a.bin', 'wb').write(b'no torch on the host route ' * 999)\n"
        "from tpuhuff_torch.cli import main\n"
        "for argv in (['-n', 'a.bin'], ['-d', '-n', 'a.bin.hff', 'b'],\n"
        "             ['-n', '--hf2', 'a.bin'],\n"
        "             ['-d', '-n', '--hf2', 'a.bin.hf2', 'c'],\n"
        "             ['--reindex', '-n', 'a.bin.hff', 'd'],\n"
        "             ['--dataset', 'a.bin', 'b', '--out-dir', 'e', '-n']):\n"
        "    assert main(['--device', 'host', *argv]) == 0, argv\n"
        "assert open('b', 'rb').read() == open('a.bin', 'rb').read()\n"
        "assert open('c', 'rb').read() == open('a.bin', 'rb').read()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'tpuhuff'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_python_m_tpuhuff_torch(tmp_path):
    """``python -m tpuhuff_torch`` is the same entry point."""
    (tmp_path / "a.bin").write_bytes(b"the module entry " * 100)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    for argv in (["-n", "a.bin"], ["-d", "-n", "a.bin.hff", "b.bin"]):
        r = subprocess.run([sys.executable, "-m", "tpuhuff_torch", "--device",
                            "host", *argv], capture_output=True, text=True,
                           timeout=120, env=env, cwd=tmp_path)
        assert r.returncode == 0, r.stderr
    a, b = ((tmp_path / n).read_bytes() for n in ("a.bin", "b.bin"))
    assert a == b
    r = subprocess.run([sys.executable, "-m", "tpuhuff_torch", "--help"],
                       capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode == 0 and r.stdout.startswith("usage: huff")


def test_cli_build_hint_counts_only_this_call(tmp_path, monkeypatch, capsys):
    """The build hint and the ``--stats`` rate without the build count the
    build seconds spent during this call, not an earlier build of the same
    process."""
    import importlib

    from tpuhuff_torch import native

    cli_main = importlib.import_module("tpuhuff_torch.cli.main")  # the module

    monkeypatch.chdir(tmp_path)
    (tmp_path / "a.bin").write_bytes(b"built before " * 100)
    monkeypatch.setattr(native, "build_seconds", 30.0)
    assert main(["--device", "host", "-n", "--stats", "a.bin"]) == 0
    out = capsys.readouterr()
    assert "hint" not in out.err and "kernel build" not in out.out

    def build_now(*args, **kwargs):  # a build of 12 s inside the call
        native.build_seconds = 42.0
        return real(*args, **kwargs)

    real = cli_main._compress
    monkeypatch.setattr(cli_main, "_compress", build_now)
    assert main(["--device", "host", "-n", "--stats", "a.bin"]) == 0
    out = capsys.readouterr()
    assert "~12s of this run was the one-time build" in out.err
    assert "kernel build" not in out.out  # the call took under 12 s
