"""The port's public surface against the JAX package's.

* Names: every public function or class defined in a module of
  ``tpuhuff/`` (and every name a package of it exports in ``__all__``) is
  in the port's counterpart module under the same name, or is an entry of
  ``MAPPED``, which names the port's counterpart or says why there is
  none.  ``MAPPED`` is checked both ways, so it cannot go stale.
* Parameters: each function of the JAX package and its same-name
  counterpart take the same parameter names with the same defaults, except
  for the differences listed in ``ALLOWED``, each with its reason; an
  entry that no longer differs fails too.
* Command line: both parsers take the same options in the same form,
  except ``--device``.
* Values: ``count_missing``, ``block_bit_lengths`` and ``words_to_payload``
  of :mod:`tpuhuff_torch.kernels` against :mod:`tpuhuff.kernels` on the
  CPU.  Tolerance: none; equal integers, dtypes and bytes.
"""

import argparse
import importlib
import inspect
import pkgutil
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tpuhuff
from tpuhuff.core.canonical import build_tree_for_device
from tpuhuff.core.weights import ByteWeights
from tpuhuff.kernels import encode as jax_encode

from tpuhuff_torch import kernels
from tpuhuff_torch.kernels.encode import as_i32

# the port's module(s) that hold a JAX module's names, where they are not
# the module of the same path under tpuhuff_torch
COUNTERPARTS = {
    "tpuhuff": ("",),
    "tpuhuff.io.stream": ("io", "io.host", "io.index", "io.crc"),
    "tpuhuff.native": ("native",),
    "tpuhuff.cache": ("kernels._build",),
}

_XLA = "the JAX package's XLA route"
_PALLAS = "a Pallas entry point"
_SELECT = ("a select-tree LUT of the TPU, which has no fast gathers; the "
           "port's kernels read a dense 256-entry table (ROADMAP: do not port)")
_LAYOUT = "a Pallas layout of the TPU's 8x128 cells (ROADMAP: do not port)"
_SHARDING = "a JAX sharding object; a mesh of the port is a tuple of torch.device"

# JAX name -> (the port's counterpart, "module.name" under tpuhuff_torch, or
# None; why the names differ)
MAPPED = {
    "enable_compile_cache": (
        "kernels._build.lib",
        "the XLA compile cache; the port's cache is nvcc's, keyed by source "
        "and flags, built at first use"),
    "block_sharding": (None, _SHARDING),
    "replicated_sharding": (None, _SHARDING),
    "decode_blocks_canonical": (
        "kernels.decode_rows", f"{_XLA} of the canonical ladder decode (K2)"),
    "decode_blocks_device": (
        "kernels.decode_rows_general",
        f"{_XLA} of the any-tree interval decode (K4)"),
    "decode_rows_device": (
        "kernels.decoder_for",
        "picks the canonical or the general decode from the tree; the port's "
        "decoder_for returns that wrapper and its tables"),
    "make_canonical_encode_tables": (
        "kernels.make_encode_tables",
        "the canonical fast-path tables of the TPU encode; one dense "
        "(len, code) table serves every tree in the port"),
    "make_combined_encode_tables": (None, _SELECT),
    "lut_select": (None, _SELECT),
    "lut_lens": (None, _SELECT),
    "lut_canonical": (None, _SELECT),
    "PALLAS_MAX_BLOCK": (
        None, "the VMEM cap of the Pallas encode's block (ROADMAP: do not "
        "port); the CUDA encode takes any power-of-two lane up to 1024"),
    "histogram_u32": ("kernels.histogram", "an alias of histogram"),
    "histogram_xla": ("kernels.histogram_reference",
                      f"{_XLA} of the histogram; the port's plain version"),
    "np_size": (None, "a size helper of the JAX histogram's route choice; "
                "the port's histogram takes a tensor and reads numel()"),
    "histogram_pallas": ("kernels.histogram", f"{_PALLAS} (K3)"),
    "hist_slab_update": (None, _LAYOUT),
    "decode_blocks_pallas_canonical": ("kernels.decode_rows",
                                       f"{_PALLAS} (K2)"),
    "decode_rows_fused": ("kernels.decode_rows", f"{_PALLAS} (K2)"),
    "decode_rows_fused_general": ("kernels.decode_rows_general",
                                  f"{_PALLAS} (K4)"),
    "make_fused_tables": (
        "kernels.first_level_table",
        "the canonical tables padded to the Pallas kernel's shapes; the CUDA "
        "kernels take the ladder and a first-level table built on the host"),
    "make_general_fused_tables": (
        "kernels.first_level_table",
        "the interval tables in the Pallas kernel's Eytzinger order; the CUDA "
        "kernel takes them unpacked and a first-level table built on the host"),
    "encode_blocks_pallas2": ("kernels.encode_blocks", f"{_PALLAS} (K1, K5-K7)"),
    "finalize_hist8": (None, _LAYOUT),
    "fused_layout_ok": (None, _LAYOUT),
    "pack_pairs": (None, _LAYOUT),
    "available": (
        "native.lib",
        "the port has no fallback: native.lib() builds the runtime or raises "
        "with the compiler's error"),
}

_DEVICE = ("the port's device is a torch device, 'cuda' by default, where "
           "the JAX package's is a flag")
_TPU_KNOB = "a switch of the TPU kernels (select trees, unrolling, layouts)"
_GROUP = "the torch.distributed process group the sum crosses"
_TABLES = ("the port's encode takes one EncodeTables (dense lens and "
           "left-aligned codes) in place of the two LUTs")

# (JAX module, function) -> {parameter: why it differs}
ALLOWED = {
    ("tpuhuff.dist.block", "encode_pipeline_arrays"): {
        "jblocks": "named blocks in the port: no jax.Array",
        "jvalid": "named valid_lens in the port: no jax.Array",
        "blocks": "the JAX package's jblocks",
        "valid_lens": "the JAX package's jvalid",
        "group": _GROUP,
    },
    ("tpuhuff.dist.block", "sharded_decode_blocks"): {"unroll": _TPU_KNOB},
    ("tpuhuff.dist.block", "sharded_encode"): {
        "lens_lut": _TABLES, "acodes_lut": _TABLES, "tables": _TABLES,
        "canon_tables": _TPU_KNOB, "full_alphabet": _TPU_KNOB,
    },
    ("tpuhuff.dist.block", "sharded_histogram"): {"group": _GROUP},
    ("tpuhuff.dist.multihost", "compress_file_multihost"): {"device": _DEVICE},
    ("tpuhuff.dist.multihost", "compress_multihost"): {"device": _DEVICE},
    ("tpuhuff.dist.multihost", "decompress_file_multihost"): {
        "device": _DEVICE},
    ("tpuhuff.io.dataset", "compress_dataset"): {"device": _DEVICE},
    ("tpuhuff.io.dataset", "decompress_dataset"): {"device": _DEVICE},
    ("tpuhuff.io.stream", "read_compress_write"): {"device": _DEVICE},
    ("tpuhuff.io.stream", "read_compress_write_hf2"): {"device": _DEVICE},
    ("tpuhuff.io.stream", "read_decompress_write_hf2"): {"device": _DEVICE},
    ("tpuhuff.io.stream", "crc_span_pieces"): {
        "nat": "the native runtime's handle; the port's CRC helpers call "
               "their own"},
    ("tpuhuff.kernels.decode", "decode_hf2_device"): {
        "unroll": _TPU_KNOB, "device": _DEVICE},
    ("tpuhuff.kernels.encode", "encode_blocks"): {
        "data": "the port's (B, N) lanes; the JAX function also takes "
                "flat data and a block_len",
        "lanes": "the JAX package's data, cut to lanes",
        "block_len": "the lanes' width is their shape's",
        "lens_lut": _TABLES, "acodes_lut": _TABLES, "tables": _TABLES,
        "valid_lens": "required: a lane's valid bytes are always given",
        "with_miss": "the port always returns the per-lane missing counts",
        "pallas": "the JAX route choice between Pallas and XLA",
        "gather_free": _TPU_KNOB, "transposed": _TPU_KNOB,
        "canon_tables": _TPU_KNOB, "full_alphabet": _TPU_KNOB,
    },
    ("tpuhuff.kernels.encode", "count_missing"): {"gather_free": _TPU_KNOB},
    ("tpuhuff.kernels.encode", "block_bit_lengths"): {
        "gather_free": _TPU_KNOB},
    ("tpuhuff.kernels.histogram", "histogram"): {
        "out": "adds into running counts (one launch per pass-1 piece)"},
}


def _jax_modules() -> list:
    """Every module of the JAX package but the ``__main__`` ones, which run
    the command line when imported and define nothing."""
    return ["tpuhuff"] + sorted(
        m.name for m in pkgutil.walk_packages(tpuhuff.__path__, "tpuhuff.")
        if not m.name.endswith("__main__"))


JAX_MODULES = _jax_modules()


def _defined(module) -> dict:
    """The public functions and classes ``module`` defines itself (jitted
    functions included), and the names a package exports: its ``__all__``,
    or else every public name it imports."""
    public = {name: obj for name, obj in vars(module).items()
              if not name.startswith("_")
              and not isinstance(obj, types.ModuleType)}
    out = {name: obj for name, obj in public.items() if callable(obj)
           and getattr(obj, "__module__", None) == module.__name__}
    if hasattr(module, "__path__"):
        names = getattr(module, "__all__", None)
        out.update({name: getattr(module, name)
                    for name in (public if names is None else names)})
    return out


def _port_modules(jax_name: str) -> list:
    paths = COUNTERPARTS.get(jax_name)
    if paths is None:
        rest = jax_name[len("tpuhuff."):]
        paths = ("kernels",) if rest.startswith("kernels.pallas_") else (rest,)
    return [importlib.import_module("tpuhuff_torch" + (f".{p}" if p else ""))
            for p in paths]


def _port_attr(path: str):
    module, _, name = path.rpartition(".")
    return getattr(importlib.import_module(f"tpuhuff_torch.{module}"), name)


def _counterpart(jax_name: str, name: str):
    for module in _port_modules(jax_name):
        if hasattr(module, name):
            return getattr(module, name)
    return None


@pytest.mark.parametrize("jax_name", JAX_MODULES)
def test_every_public_name_has_a_counterpart(jax_name):
    missing = [name for name in _defined(importlib.import_module(jax_name))
               if _counterpart(jax_name, name) is None and name not in MAPPED]
    assert not missing, f"{jax_name}: no counterpart and no MAPPED entry"


def test_mapped_entries_are_live():
    """Every MAPPED entry names a JAX name that the port lacks under that
    name, and a counterpart that exists."""
    jax_names = {}
    for jax_name in JAX_MODULES:
        for name in _defined(importlib.import_module(jax_name)):
            jax_names.setdefault(name, []).append(jax_name)
    for name, (port, reason) in MAPPED.items():
        assert reason, name
        assert name in jax_names, f"MAPPED {name}: not a JAX package name"
        held = [m for m in jax_names[name] if _counterpart(m, name) is not None]
        assert not held, f"MAPPED {name}: the port now has it ({held})"
        if port is not None:
            assert callable(_port_attr(port)), name


def _same_default(a, b) -> bool:
    """Equal defaults; a value of one of the packages' own classes (the
    letter type ``U8``) equals its copy in the other by its repr."""
    if a is inspect.Parameter.empty or b is inspect.Parameter.empty:
        return a is b
    return a == b or (type(a).__qualname__ == type(b).__qualname__
                      and repr(a) == repr(b))


def _differences(jax_fn, port_fn) -> set:
    jp = inspect.signature(jax_fn).parameters
    pp = inspect.signature(port_fn).parameters
    diff = {name for name, p in jp.items()
            if name not in pp or not _same_default(pp[name].default, p.default)}
    return diff | (set(pp) - set(jp))


def _methods(cls) -> dict:
    """The public methods (and ``__init__``) that ``cls`` defines."""
    out = {}
    for name, obj in vars(cls).items():
        if name.startswith("_") and name != "__init__":
            continue
        if isinstance(obj, (staticmethod, classmethod)):
            obj = obj.__func__
        if inspect.isfunction(obj):
            out[name] = obj
    return out


def _function_pairs(jax_name: str) -> list:
    """(name, JAX function, the port's) for each function the module
    defines and each method of a class it defines, ``Class.method``."""
    pairs = []
    for name, obj in _defined(importlib.import_module(jax_name)).items():
        port = _counterpart(jax_name, name)
        if port is None or getattr(obj, "__module__", None) != jax_name:
            continue  # a package's re-export is compared where it is defined
        if not inspect.isclass(obj):
            pairs.append((name, obj, port))
            continue
        port_methods = _methods(port)
        for meth, fn in _methods(obj).items():
            assert meth in port_methods, f"{jax_name}.{name}.{meth}: missing"
            pairs.append((f"{name}.{meth}", fn, port_methods[meth]))
    return pairs


@pytest.mark.parametrize("jax_name", JAX_MODULES)
def test_counterparts_take_the_same_parameters(jax_name):
    for name, jax_fn, port_fn in _function_pairs(jax_name):
        allowed = ALLOWED.get((jax_name, name), {})
        diff = _differences(jax_fn, port_fn)
        assert diff <= set(allowed), (
            f"{jax_name}.{name}: parameters {sorted(diff - set(allowed))} "
            "differ from the port's")
        stale = set(allowed) - diff
        assert not stale, f"ALLOWED {jax_name}.{name}: {sorted(stale)} agree now"


def test_allowed_entries_name_counterpart_pairs():
    for (jax_name, name), params in ALLOWED.items():
        assert name in {n for n, _, _ in _function_pairs(jax_name)}, name
        assert all(params.values()), name


def _options(parser: argparse.ArgumentParser) -> dict:
    """Each option (or positional) -> its form."""
    out = {}
    for action in parser._actions:
        keys = action.option_strings or [action.dest]
        form = (type(action).__name__, action.nargs, action.const,
                action.default, action.type, action.choices, action.dest)
        out.update({key: form for key in keys})
    return out


def test_command_lines_take_the_same_options():
    jax_opts = _options(
        importlib.import_module("tpuhuff.cli.main")._build_parser())
    port_opts = _options(
        importlib.import_module("tpuhuff_torch.cli.main")._build_parser())
    assert set(jax_opts) == set(port_opts)
    differ = {key for key in jax_opts if jax_opts[key] != port_opts[key]}
    # --device: a flag in the JAX package, a device name ("cuda", "cpu",
    # "host") in the port
    assert differ == {"--device"}


def _trees():
    """A tree over all 256 byte values and one without a few the data
    holds, as (uint8 lens LUT, name)."""
    full = np.arange(1, 257, dtype=np.int64)
    part = full.copy()
    part[[0, 7, 200, 255]] = 0
    for counts, name in ((full, "all letters"), (part, "missing letters")):
        tree, _ = build_tree_for_device(ByteWeights(counts), max_len=32)
        yield tree.encode_tables()[0], name


def _valid(case: str, B: int, N: int, rng) -> np.ndarray | None:
    return {
        "none": None,
        "full": np.full(B, N, np.int32),
        "ragged": rng.integers(0, N + 1, B).astype(np.int32),
        "zero": np.zeros(B, np.int32),
    }[case]


@pytest.mark.parametrize("valid_case", ["none", "full", "ragged", "zero"])
@pytest.mark.parametrize("shape", [(37, 64), (1000,)])
def test_count_missing_and_block_bit_lengths(shape, valid_case):
    rng = np.random.default_rng(13)
    data = rng.integers(0, 256, shape, dtype=np.uint8)
    B, N = (1, shape[0]) if len(shape) == 1 else shape
    valid = _valid(valid_case, B, N, rng)
    for lens_u8, name in _trees():
        lens_i32 = kernels.make_encode_tables(lens_u8, np.zeros(256)).lens
        for lut in (lens_u8, lens_i32, lens_u8.astype(np.int64)):
            jax_lut = np.asarray(lut)
            want = jax_encode.count_missing(
                jnp.asarray(data), jnp.asarray(jax_lut),
                None if valid is None else jnp.asarray(valid))
            got = kernels.count_missing(
                torch.from_numpy(data), lut,
                None if valid is None else torch.from_numpy(valid))
            assert type(got) is int and got == want, (name, lut.dtype)

            want_b = np.asarray(jax_encode.block_bit_lengths(
                jnp.asarray(data), jnp.asarray(jax_lut)))
            got_b = kernels.block_bit_lengths(torch.from_numpy(data), lut)
            # the dtype is the one jnp.sum gives this LUT
            assert str(got_b.dtype).removeprefix("torch.") == str(
                jnp.sum(jnp.asarray(jax_lut)).dtype)
            assert got_b.shape == want_b.shape
            np.testing.assert_array_equal(got_b.numpy(), want_b)
        if name == "missing letters" and valid_case in ("none", "full"):
            assert want > 0
        if valid_case == "zero":
            assert want == 0


def test_dist_missing_goes_through_count_missing(monkeypatch):
    from tpuhuff_torch.dist import block, make_mesh

    calls = []
    real = block.count_missing
    monkeypatch.setattr(block, "count_missing",
                        lambda *a: calls.append(a) or real(*a))
    data = np.random.default_rng(3).integers(0, 256, (8, 32), dtype=np.uint8)
    lens = next(_trees())[0].copy()
    lens[data[0, 0]] = 0
    got = block.sharded_count_missing(data, np.full(8, 32, np.int32), lens,
                                      make_mesh(["cpu"] * 2))
    assert got == int((data == data[0, 0]).sum()) and len(calls) == 2


@pytest.mark.parametrize("as_tensor", [False, True])
def test_words_to_payload(as_tensor):
    rng = np.random.default_rng(17)
    words = rng.integers(0, 1 << 32, 9, dtype=np.uint64).astype(np.uint32)
    arg = as_i32(words) if as_tensor else words
    for bit_len in (0, 1, 7, 8, 9, 31, 32, 33, 100, 287, 288):
        want = jax_encode.words_to_payload(words, bit_len)
        got = kernels.words_to_payload(arg, bit_len)
        assert type(got) is bytes and got == want, bit_len
