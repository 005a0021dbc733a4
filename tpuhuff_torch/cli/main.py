"""CLI: compress/decompress SRC_FILE into DST_FILE.hff (compress by default).

The port's copy of :mod:`tpuhuff.cli.main`, flag for flag compatible with
the reference ``huff`` binary (the reference's `huff/res/cli.yml:1-39`,
`huff/src/cli.rs:132-162`):

* ``-d/--decompress`` ``-t/--time`` ``-r/--replace`` ``-n/--noask``
* ``-b/--block-size SIZE`` with K/M/G and Ki/Mi/Gi suffixes (default 2G)
* ``SRC_FILE`` positional; ``DST_FILE`` defaults to ``./SRC_FILE.hff``
* path rules: compress appends ``.hff`` to the destination
  (`cli.rs:40-54`); decompress requires the ``.hff`` extension and strips
  it when no destination is given (`cli.rs:55-76`)
* interactive overwrite prompt unless ``-n`` (`cli.rs:116-130`)

and with the JAX package's extensions: ``--hf2``, ``--stats``,
``--threads``, ``--profile``, ``--warmup``, the dataset flags and the
index flags.  ``--device`` takes a value: ``cuda`` (the default, and the
value of the bare flag, so a command line written for ``python -m
tpuhuff`` runs unchanged) launches the CUDA kernels, ``cpu`` runs their
plain PyTorch versions and ``host`` runs the host C++ writers and readers
(the JAX command line's route without ``--device``).  A ``host`` run
imports no torch.  ``.hff`` decodes and ``--reindex`` run on the host
whatever the device, as in the JAX package.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
import time

__all__ = ["main", "parse_block_size", "CliError", "DEVICES"]

EXTENSION = "hff"
EXTENSION2 = "hf2"
DEVICES = ("cuda", "cpu", "host")
HINT_BUILD_S = 5.0  # a build longer than this gets the --warmup hint


class CliError(ValueError):
    def __init__(self, message: str, kind: str = "InvalidInput"):
        super().__init__(message)
        self.kind = kind


def parse_block_size(text: str) -> int:
    """K/M/G + Ki/Mi/Gi suffix parser (`huff/src/cli.rs:79-114`)."""
    lowered = text.lower()
    num = ""
    i = 0
    while i < len(lowered) and lowered[i].isdigit():
        num += lowered[i]
        i += 1
    mult_str = lowered[i:]
    try:
        value = int(num)
    except ValueError:
        raise CliError("Invalid block size")
    if value == 0:
        raise CliError("Invalid block size")
    mults = {
        "": 1,
        "k": 1_000, "m": 1_000_000, "g": 1_000_000_000,
        "ki": 1024, "mi": 1_048_576, "gi": 1_073_741_824,
    }
    if mult_str not in mults:
        raise CliError("Invalid block size")
    return value * mults[mult_str]


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="huff",
        description="Compress/decompress SRC_FILE into DST_FILE.hff "
        "(compress by default)",
    )
    p.add_argument("-d", "--decompress", action="store_true",
                   help="Decompresses the hff SRC_FILE into DST_FILE")
    p.add_argument("-t", "--time", action="store_true",
                   help="Prints how long it took to finish")
    p.add_argument("-r", "--replace", action="store_true",
                   help="Deletes SRC_FILE upon completion")
    p.add_argument("-n", "--noask", action="store_true",
                   help="Omits asking if existing DST_FILE should be replaced")
    p.add_argument("-b", "--block-size", default="2G", metavar="SIZE",
                   help="Set how many bytes can be loaded from the file at "
                   "one time (units: K/Ki M/Mi G/Gi; default 2G)")
    p.add_argument("--hf2", action="store_true",
                   help="Use the block-indexed .hf2 container "
                   "(enables parallel/device decode)")
    p.add_argument("--hf2-block", default=None, metavar="SIZE",
                   help="Input bytes per .hf2 block (units as -b; default: "
                   "256 on a device, 64Ki on the host)")
    p.add_argument("--max-code-len", type=int, default=None, metavar="L",
                   help="Length-limit codes to L bits (optimal "
                   "package-merge)")
    p.add_argument("--hist-sample", type=int, default=1, metavar="N",
                   help="Fast mode: histogram only 1/N of each chunk in "
                   "pass 1 (Laplace-smoothed tree; output stays exactly "
                   "decodable, ratio typically <1%% worse)")
    p.add_argument("--device", nargs="?", const="cuda", default="cuda",
                   choices=DEVICES,
                   help="Where the codec runs: cuda (the default, and the "
                   "bare flag's value) launches the CUDA kernels, cpu runs "
                   "their plain PyTorch versions, host runs the host C++ "
                   "writers and readers")
    p.add_argument("--reindex", action="store_true",
                   help="Re-index an existing .hff into .hf2 without "
                   "recompressing (enables parallel/device decode)")
    p.add_argument("--no-auto-index", action="store_true",
                   help="Disable the automatic block-index sidecar for "
                   "large .hff decodes (see io.host.AUTO_INDEX_MIN)")
    p.add_argument("--no-check", action="store_true",
                   help="Skip the .hf2 per-block CRC32 integrity column "
                   "(write) / its verification (read)")
    p.add_argument("--tree-from", default=None, metavar="FILE",
                   help="Build the frequency table from FILE (sampled) and "
                   "compress SRC single-pass with that shared tree "
                   "(config 4)")
    p.add_argument("--dataset", nargs="+", default=None, metavar="SRC",
                   help="Compress many files under ONE shared frequency "
                   "table (single-pass each; see --tree-from/--adaptive/"
                   "--out-dir)")
    p.add_argument("--out-dir", default=None, metavar="DIR",
                   help="Output directory for --dataset (default: .)")
    p.add_argument("--adaptive", action="store_true",
                   help="With --dataset: refresh the table per shard from "
                   "the histogram gathered during the previous shard's "
                   "encode (fused histogram+encode kernel on the device)")
    p.add_argument("--threads", type=int, default=None,
                   help="Host decode/stitch threads (default: all cores)")
    p.add_argument("--stats", action="store_true",
                   help="Print ratio / throughput / block count")
    p.add_argument("--profile", nargs="?", const="", default=None,
                   metavar="TRACE_DIR",
                   help="Print per-stage timings; with TRACE_DIR also write "
                   "a torch.profiler Chrome trace there")
    p.add_argument("--warmup", action="store_true",
                   help="Build the CUDA kernels (nvcc) and the host runtime "
                   "(g++) ahead, then run one small .hf2 round trip on the "
                   "device (later runs skip the build)")
    p.add_argument("SRC_FILE", nargs="?", default=None)
    p.add_argument("DST_FILE", nargs="?", default="./SRC_FILE.hff")
    return p


def _device_values(argv: list) -> list:
    """``--device NAME`` as ``--device=NAME`` when NAME is a device, and a
    bare ``--device`` as ``--device=cuda``: a bare flag before SRC_FILE
    must not take the file's name for its value."""
    out, i = [], 0
    while i < len(argv):
        if argv[i] == "--device":
            if i + 1 < len(argv) and argv[i + 1] in DEVICES:
                out.append(f"--device={argv[i + 1]}")
                i += 2
                continue
            out.append("--device=cuda")
        else:
            out.append(argv[i])
        i += 1
    return out


def _resolve_device(name: str):
    """The torch device of a device route; ``cuda`` without a card raises."""
    import torch

    if name == "cuda" and not torch.cuda.is_available():
        raise CliError("--device cuda: no CUDA device is available "
                       "(--device cpu runs the plain versions, --device "
                       "host the host C++ codec)", "Device")
    return torch.device(name)


def _build_s() -> float:
    """Seconds this process has spent so far building the host runtime
    and the CUDA kernels (a module not imported yet has built nothing)."""
    package = __name__.split(".")[0]
    return sum(getattr(sys.modules.get(f"{package}.{name}"), "build_seconds",
                       None) or 0.0
               for name in ("native", "kernels._build"))


def _warmup(device: str) -> int:
    """``--warmup``: build the host runtime and, for ``cuda``, the CUDA
    kernels, then one small ``.hf2`` round trip on ``device`` (the host
    codec's for ``host``).  A failed step raises, with the compiler's
    error."""
    import tempfile

    import numpy as np

    def step(label, fn):
        t0 = time.perf_counter()
        out = fn()
        print(f"  {label}: ok ({time.perf_counter() - t0:.1f}s)")
        return out

    print(f"tpuhuff_torch warmup ({device}):")
    from .. import native

    step("host runtime build (g++)", native.lib)
    if device == "host":
        from ..io.host import (
            read_compress_write_hf2_host as compress,
            read_decompress_write_hf2_host as decompress,
        )
    else:
        dev = _resolve_device(device)
        if device == "cuda":
            from ..kernels import _build

            step("CUDA kernels build (nvcc)", _build.lib)
        from ..io.stream import (
            read_compress_write_hf2, read_decompress_write_hf2,
        )

        compress = functools.partial(read_compress_write_hf2, device=dev)
        decompress = functools.partial(read_decompress_write_hf2, device=dev)

    def roundtrip():
        rng = np.random.default_rng(42)
        text = b"warmup corpus for the codec's kernels and host runtime "
        data = np.frombuffer(text * ((1 << 20) // len(text) + 1),
                             dtype=np.uint8)[: 1 << 20].copy()
        idx = rng.integers(0, data.size, data.size // 64)
        data[idx] = rng.integers(0, 256, idx.size, dtype=np.uint8)
        with tempfile.TemporaryDirectory() as td:
            src, hf2, out = (os.path.join(td, n) for n in ("w", "w.hf2", "o"))
            data.tofile(src)
            compress(src, hf2)
            decompress(hf2, out)
            if open(out, "rb").read() != data.tobytes():
                raise RuntimeError("warmup round trip gave other bytes")

    step(".hf2 round trip (1 MiB)", roundtrip)
    print("warmup complete: the builds are cached under tpuhuff_torch/_build")
    return 0


def _resolve_paths(args, ext: str):
    """Path munging per `huff/src/cli.rs:24-77`."""
    src = args.SRC_FILE
    dst = args.DST_FILE
    if dst == "./SRC_FILE.hff":  # the literal default marker (cli.yml:39)
        dst = os.path.join(".", os.path.basename(src))
    if os.path.isdir(src):
        raise CliError(f"{src!r} is a directory", "NotFile")
    if args.decompress:
        src_ext = os.path.splitext(src)[1].lstrip(".")
        if src_ext != ext:
            raise CliError(
                f"Unrecognized file format, expected {ext}", "UnrecognizedFormat"
            )
        if os.path.abspath(dst) == os.path.abspath(os.path.join(".", src)):
            dst = os.path.splitext(dst)[0]
        if os.path.isdir(dst):
            raise CliError(f"Destination {dst!r} is a directory", "NotFile")
    else:
        dst = dst + "." + ext
    return src, dst


def _ask_replace(path: str, noask: bool) -> bool:
    """Overwrite prompt (`huff/src/cli.rs:116-130`); True = proceed."""
    if os.path.exists(path) and not noask:
        sys.stdout.write(
            f"{path!r} already exists, do you want to replace it? [Y/N]: "
        )
        sys.stdout.flush()
        answer = sys.stdin.readline()
        if not answer.lower().startswith("y"):
            return False
        print()
    return True


def _dataset(args, start: float) -> int:
    """``--dataset``: config 4's shared-tree (or adaptive) compression."""
    if args.decompress:
        raise CliError("--dataset is a compression mode; decode "
                       "each shard with -d", "InvalidInput")
    for s in args.dataset:
        if not os.path.exists(s):
            raise CliError(f"{s!r}: no such file", "Io")
        if os.path.isdir(s):
            raise CliError(f"{s!r} is a directory", "NotFile")
    device = (args.device if args.device == "host"
              else _resolve_device(args.device))
    from ..io.dataset import compress_dataset

    hf2_block = parse_block_size(args.hf2_block) if args.hf2_block else None
    dstats: dict = {}
    # table-build sampling defaults to 8 for datasets (the tree converges
    # long before a full pass; --hist-sample overrides)
    samp = args.hist_sample if args.hist_sample != 1 else 8
    outs = compress_dataset(
        args.dataset, out_dir=args.out_dir, tree_from=args.tree_from,
        hist_sample=samp, adaptive=args.adaptive, device=device,
        hf2=True,  # dataset shards always get the indexed container
        block_len=hf2_block, check=not args.no_check, stats=dstats)
    if args.replace:
        for s in args.dataset:
            os.remove(s)
    if args.stats:
        rate = dstats["bytes"] / max(time.perf_counter() - start, 1e-9) / 1e9
        print(f"{len(outs)} shards, {dstats['bytes']} bytes, "
              f"ratio {dstats['ratio']:.4f}, "
              f"{dstats['tree_builds']} tree build(s), {rate:.3f} GB/s")
    if args.time:
        print(f"{time.perf_counter() - start:.6f}s")
    return 0


def _reindex(args, start: float) -> int:
    """``--reindex``: a ``.hff`` into ``.hf2`` without recompressing."""
    src = args.SRC_FILE
    if os.path.splitext(src)[1].lstrip(".") != EXTENSION:
        raise CliError(
            f"Unrecognized file format, expected {EXTENSION}",
            "UnrecognizedFormat",
        )
    dst = args.DST_FILE
    if dst == "./SRC_FILE.hff":
        dst = os.path.splitext(os.path.join(
            ".", os.path.basename(src)))[0] + "." + EXTENSION2
    if not os.path.exists(src):
        raise CliError(f"{src!r}: no such file", "Io")
    if not _ask_replace(dst, args.noask):
        return 0
    from ..io.host import HOST_HF2_BLOCK
    from ..io.index import transcode_hff_to_hf2

    hf2_block = (parse_block_size(args.hf2_block) if args.hf2_block
                 else HOST_HF2_BLOCK)
    transcode_hff_to_hf2(src, dst, block_len=hf2_block)
    if args.replace:
        os.remove(src)
    if args.time:
        print(f"{time.perf_counter() - start:.6f}s")
    return 0


def _decompress(args, src: str, dst: str, block_size: int,
                stats: dict) -> None:
    """Decode ``src``."""
    if not args.hf2:
        # .hff: the host reader on every route, as in the JAX package
        from ..io.host import read_decompress_write

        read_decompress_write(
            src, dst, block_size,
            auto_index=False if args.no_auto_index else None, stats=stats)
        act = stats.get("auto_index")
        if act == "created":
            print(f"indexed {src!r} -> sidecar '{src}.hf2x' (block-parallel "
                  f"decode; reused on later decodes)")
        elif act == "reused":
            print(f"using block-index sidecar '{src}.hf2x'")
    elif args.device == "host":
        from ..io.host import read_decompress_write_hf2_host

        read_decompress_write_hf2_host(src, dst, check=not args.no_check,
                                       threads=args.threads)
    else:
        from ..io.stream import read_decompress_write_hf2

        read_decompress_write_hf2(src, dst,
                                  device=_resolve_device(args.device),
                                  threads=args.threads, stats=stats,
                                  check=not args.no_check)


def _compress(args, src: str, dst: str, block_size: int, stats: dict,
              timer) -> None:
    """Encode ``src``."""
    on_host = args.device == "host"
    dev = None if on_host else _resolve_device(args.device)
    tree = None
    if args.tree_from:
        # config 4's single-file form: the shared table from another file,
        # so pass 1 is skipped
        from ..io.dataset import build_shared_tree

        tree = build_shared_tree(
            args.tree_from, device=not on_host,
            hist_sample=args.hist_sample if args.hist_sample != 1 else 8)
    if args.hf2:
        hf2_block = parse_block_size(args.hf2_block) if args.hf2_block else None
        kw = dict(block_len=hf2_block, hist_sample=args.hist_sample,
                  check=not args.no_check, tree=tree,
                  max_code_len=args.max_code_len)
        if on_host:
            from ..io.host import read_compress_write_hf2_host

            read_compress_write_hf2_host(src, dst, **kw)
        else:
            from ..io.stream import read_compress_write_hf2

            read_compress_write_hf2(src, dst, device=dev, stats=stats, **kw)
    else:
        kw = dict(hist_sample=args.hist_sample, tree=tree,
                  max_code_len=args.max_code_len, timer=timer)
        if on_host:
            from ..io.host import read_compress_write_host

            read_compress_write_host(src, dst, block_size, **kw)
        else:
            from ..io.stream import read_compress_write

            read_compress_write(src, dst, block_size, device=dev,
                                stats=stats, **kw)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _build_parser().parse_args(_device_values(argv))
    start = time.perf_counter()
    built_before = _build_s()
    try:
        block_size = parse_block_size(args.block_size)
        if args.warmup:
            return _warmup(args.device)
        if args.dataset is not None:
            return _dataset(args, start)
        if args.SRC_FILE is None:
            raise CliError("SRC_FILE is required", "InvalidInput")
        if args.reindex:
            return _reindex(args, start)
        ext = EXTENSION2 if args.hf2 else EXTENSION
        src, dst = _resolve_paths(args, ext)
        if not os.path.exists(src):
            raise CliError(f"{src!r}: no such file", "Io")
        src_size = os.path.getsize(src)
        if not _ask_replace(dst, args.noask):
            return 0
        from ..profiling import StageTimer, device_trace, tracing

        # --profile: the stage table of every route; with a directory the
        # spans are also profiler ranges in its trace, beside the kernels
        timer = StageTimer() if args.profile is not None else None
        stats: dict = {}
        with device_trace(args.profile or None), tracing(timer):
            if args.decompress:
                _decompress(args, src, dst, block_size, stats)
            else:
                _compress(args, src, dst, block_size, stats, timer)
        if timer is not None:
            print(timer.report())
        # the kernels and the runtime are built at first use: say how much
        # of this call that was, and how to pay it ahead
        build_s = _build_s() - built_before
        if build_s > HINT_BUILD_S:
            print(f"hint: ~{build_s:.0f}s of this run was the one-time build "
                  "of the CUDA kernels and the host runtime; run `python -m "
                  "tpuhuff_torch --warmup` once to build them ahead",
                  file=sys.stderr)
        if args.replace:
            os.remove(src)
    except (CliError, ValueError, RuntimeError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    elapsed = time.perf_counter() - start
    if args.stats:
        # src_size was captured before -r/--replace deleted the source
        in_size = src_size
        out_size = os.path.getsize(dst)
        big = max(in_size, out_size)
        line = (
            f"{in_size} -> {out_size} bytes "
            f"(ratio {out_size / max(in_size, 1):.4f}), "
            f"{big / max(elapsed, 1e-9) / 1e9:.3f} GB/s, "
            f"block size {block_size}"
        )
        if 0.5 < build_s < elapsed:
            warm = big / (elapsed - build_s) / 1e9
            line += f" [{warm:.3f} GB/s excl ~{build_s:.1f}s kernel build]"
        print(line)
    if args.time:
        print(f"{elapsed:.6f}s")
    return 0
