"""The port's in-memory codec and container (``tpuhuff_torch.compress``,
``decompress``, ``CompressData``) and the host core under it, against the
JAX package's (``tpuhuff.core``).

Tolerance: none.  Container bytes, payloads, trees, error types and
messages must be identical.
"""

import numpy as np
import pytest

import tpuhuff
from tpuhuff.core import bits as jax_bits
from tpuhuff.core import codec as jax_codec
from tpuhuff.core import letters as jax_letters
from tpuhuff.core import utils as jax_utils
from tpuhuff.core import weights as jax_weights

import tpuhuff_torch
from tpuhuff_torch.core import bits as port_bits
from tpuhuff_torch.core import codec as port_codec
from tpuhuff_torch.core import letters as port_letters
from tpuhuff_torch.core import utils as port_utils
from tpuhuff_torch.core import weights as port_weights

GOLDEN = "370000000498e61310bc00"  # compress(b"abbccc"), comp.rs:218-262


def _both(fn_name, *args, **kw):
    """The JAX package's and the port's result (or exception) of one call."""
    out = []
    for pkg in (tpuhuff, tpuhuff_torch):
        try:
            out.append(("ok", getattr(pkg, fn_name)(*args, **kw)))
        except Exception as e:  # compared below: type name and message
            out.append(("raised", type(e).__name__, str(e)))
    return out


def test_golden_abbccc():
    port = tpuhuff_torch.compress(b"abbccc")
    assert port.to_bytes().hex() == GOLDEN
    assert port.to_bytes() == tpuhuff.compress(b"abbccc").to_bytes()
    assert port.huff_tree.as_bin().group_string() == \
        "[10011000, 11100110, 00010011, 00010]"
    rt = tpuhuff_torch.CompressData.try_from_bytes(port.to_bytes())
    assert tpuhuff_torch.decompress(rt) == b"abbccc"


def _data_with_padding(padding: int, rng) -> bytes:
    """Random bytes whose compressed payload has ``padding`` padding bits."""
    while True:
        n = int(rng.integers(1, 5000))
        data = rng.integers(0, int(rng.integers(2, 257)), n,
                            dtype=np.uint8).tobytes()
        if tpuhuff.compress(data).padding_bits == padding:
            return data


@pytest.mark.parametrize("padding", range(8))
def test_container_bytes_equal_at_every_padding(padding):
    data = _data_with_padding(padding, np.random.default_rng(padding))
    port = tpuhuff_torch.compress(data)
    assert port.padding_bits == padding
    assert port.to_bytes() == tpuhuff.compress(data).to_bytes()
    rt = tpuhuff_torch.CompressData.try_from_bytes(port.to_bytes())
    assert tpuhuff_torch.decompress(rt) == data
    # the short streams of the JAX tests: b"abbccc" and one more 'c' each
    small = b"abbccc" + b"c" * padding
    assert (tpuhuff_torch.compress(small).to_bytes()
            == tpuhuff.compress(small).to_bytes())


@pytest.mark.parametrize("n", [1, 2, 7, 8, 255, 256, 1000, 65536, 300_001])
@pytest.mark.parametrize("alphabet", [1, 2, 17, 256])
def test_random_bytes_equal(n, alphabet):
    data = np.random.default_rng(n + alphabet).integers(
        0, alphabet, n, dtype=np.uint8)
    for form in (data.tobytes(), data):  # bytes and uint8 arrays
        port = tpuhuff_torch.compress(form)
        assert port.to_bytes() == tpuhuff.compress(form).to_bytes()
        assert tpuhuff_torch.decompress(port) == data.tobytes()


def _letters(ltype: str, rng) -> list:
    """Letters spanning ``ltype``'s range, with ties in their counts."""
    t = port_letters.letter_type(ltype)
    lo = -(1 << (t.size_bits - 1)) if t.signed else 0
    hi = (1 << (t.size_bits - 1)) - 1 if t.signed else (1 << t.size_bits) - 1
    pool = sorted({lo, hi, lo + 1, hi - 1, (lo + hi) // 2, 0 if t.signed else 1}
                  | {int(x) for x in rng.integers(0, 1 << 62, 6)
                     if lo <= int(x) <= hi})
    counts = rng.integers(1, 4, len(pool))  # few distinct counts: ties
    letters = [v for v, c in zip(pool, counts) for _ in range(int(c))]
    order = rng.permutation(len(letters))
    return [letters[i] for i in order]


@pytest.mark.parametrize("ltype", ["u8", "u16", "u32", "u64", "u128",
                                   "i8", "i16", "i32", "i64", "i128"])
def test_generic_letters_of_each_width(ltype):
    rng = np.random.default_rng(len(ltype) * 7 + ord(ltype[0]))
    letters = _letters(ltype, rng)
    port = tpuhuff_torch.compress(letters)
    jax = tpuhuff.compress(letters)
    # the inferred width is the smallest that holds the letters
    assert port.ltype.name == jax.ltype.name
    assert port.to_bytes() == jax.to_bytes()
    # letters that are all u8 ints decode to bytes, others to a list
    want = bytes(letters) if ltype == "u8" else letters
    assert tpuhuff_torch.decompress(port) == tpuhuff.decompress(jax) == want
    # the declared width on the wire, read back
    raw = tpuhuff_torch.compress_with_tree(letters, port.huff_tree, ltype)
    assert raw.to_bytes() == tpuhuff.compress_with_tree(
        letters, jax.huff_tree, ltype).to_bytes()
    rt = tpuhuff_torch.CompressData.try_from_bytes(raw.to_bytes(), ltype)
    assert tpuhuff_torch.decompress(rt) == want


@pytest.mark.parametrize("dtype", [np.uint16, np.int32, np.int64])
def test_generic_letters_as_arrays_with_ties(dtype):
    """numpy letters: counted by ``np.unique``, in first-occurrence order;
    equal counts, so the order decides the tree."""
    rng = np.random.default_rng(3)
    values = rng.choice(np.arange(-500, 40000), 40, replace=False)
    values = values[values >= 0] if dtype == np.uint16 else values
    letters = rng.permutation(np.repeat(values, 3)).astype(dtype)
    assert (port_weights.build_weights_map(letters)
            == jax_weights.build_weights_map(letters))
    port = tpuhuff_torch.compress(letters)
    assert port.to_bytes() == tpuhuff.compress(letters).to_bytes()
    assert tpuhuff_torch.decompress(port) == letters.tolist()


def test_str_letters_build_and_decode_but_have_no_wire_form():
    letters = ["ay", "bee", "bee", "cee", "cee", "cee", "dee", "ay"]
    port = tpuhuff_torch.compress(letters)
    jax = tpuhuff.compress(letters)
    assert port.comp_bytes == jax.comp_bytes
    assert port.padding_bits == jax.padding_bits
    assert tpuhuff_torch.decompress(port) == letters
    for comp in (port, jax):
        with pytest.raises(TypeError, match="must be an int"):
            comp.to_bytes()


@pytest.mark.parametrize("letters", [
    b"abbccc", bytes(range(256)) * 3, b"\x00" * 17, [5, 5, 6, 7, 7, 7],
    "hello world", ["x", "y", "x"]])
def test_build_weights_map_order(letters):
    assert (port_weights.build_weights_map(letters)
            == jax_weights.build_weights_map(letters))
    assert list(port_weights.build_weights_map(letters)) == list(
        jax_weights.build_weights_map(letters))


def test_missing_letter():
    tree = tpuhuff_torch.HuffTree.from_weights(
        tpuhuff_torch.ByteWeights.from_bytes(b"abb"))
    jtree = tpuhuff.HuffTree.from_weights(tpuhuff.ByteWeights.from_bytes(b"abb"))
    for comp, t in ((tpuhuff_torch, tree), (tpuhuff, jtree)):
        with pytest.raises(comp.CompressError) as e:
            comp.compress_with_tree(b"abbccc", t)
        assert e.value.missing_letter == ord("c")
        assert str(e.value) == "letter not found in codes (99)"
    with pytest.raises(tpuhuff_torch.CompressError, match=r"\('z'\)"):
        tpuhuff_torch.compress_with_tree(["a", "z"], tpuhuff_torch.HuffTree
                                         .from_weights({"a": 1, "b": 2}))


@pytest.mark.parametrize("args", [(b"",), ([],)])
def test_empty_input(args):
    jax, port = _both("compress", *args)
    assert jax == port == ("raised", "EmptyWeightsError", "provided empty weights")


def _abbccc_flipped_tree() -> bytes:
    bad = bytearray(tpuhuff.compress(b"abbccc").to_bytes())
    bad[5] ^= 0xFF
    return bytes(bad)


@pytest.mark.parametrize("raw", [
    b"", b"\x00\x00", b"\x00\x00\x00\x00\x01\xff\xff\xff",
    b"\x00\x00\x00\x01\x00" + b"\xff" * 3, _abbccc_flipped_tree(),
    bytes.fromhex(GOLDEN)[:9],  # no payload: the constructor's error
    bytes.fromhex(GOLDEN)[:8]])
def test_try_from_bytes_errors(raw):
    out = []
    for pkg in (tpuhuff, tpuhuff_torch):
        with pytest.raises(ValueError) as e:
            pkg.CompressData.try_from_bytes(raw)
        out.append((type(e.value).__name__, str(e.value)))
    assert out[0] == out[1]


@pytest.mark.parametrize("args", [(b"", 0), (b"\x00", 8), (b"\x00", -1)])
def test_compressdata_validation(args):
    jtree = tpuhuff.HuffTree.from_weights(tpuhuff.ByteWeights.from_bytes(b"ab"))
    ptree = tpuhuff_torch.HuffTree.from_weights(
        tpuhuff_torch.ByteWeights.from_bytes(b"ab"))
    msgs = []
    for pkg, tree in ((tpuhuff, jtree), (tpuhuff_torch, ptree)):
        with pytest.raises(ValueError) as e:
            pkg.CompressData(*args, tree)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_non_u8_container():
    letters = [1000, 2000, 2000, 70000, 70000, 70000]
    weights = {}
    for letter in letters:
        weights[letter] = weights.get(letter, 0) + 1
    port = tpuhuff_torch.compress_with_tree(
        letters, tpuhuff_torch.HuffTree.from_weights(weights), "u32")
    raw = port.to_bytes()
    assert raw == tpuhuff.compress_with_tree(
        letters, tpuhuff.HuffTree.from_weights(weights), "u32").to_bytes()
    assert int.from_bytes(raw[1:5], "big") == (2 * 3 - 1 + 32 * 3 + 7) // 8
    rt = tpuhuff_torch.CompressData.try_from_bytes(raw, "u32")
    assert tpuhuff_torch.decompress(rt) == letters


@pytest.mark.parametrize("split", [0, 1, 5, 333])
def test_py_dfa_decoder(split):
    data = np.random.default_rng(split).integers(0, 30, 2000, dtype=np.uint8)
    comp = tpuhuff_torch.compress(data)
    jcomp = tpuhuff.compress(data)
    payload, pad = comp.comp_bytes, comp.padding_bits
    outs = []
    for cls, tree in ((port_codec.PyDfaDecoder, comp.huff_tree),
                      (jax_codec.PyDfaDecoder, jcomp.huff_tree)):
        dec = cls(tree)
        body = payload[:-1] if pad else payload
        out = dec.feed(body[:split]) + dec.feed(body[split:])
        if pad:
            out += dec.finish(payload[-1], pad)
        outs.append(out)
    assert outs[0] == outs[1] == data.tobytes()
    for name in ("next_state", "emit_count", "emit_syms"):
        assert np.array_equal(getattr(port_codec.PyDfaDecoder(comp.huff_tree),
                                      name),
                              getattr(jax_codec.PyDfaDecoder(jcomp.huff_tree),
                                      name))


def test_pack_and_unpack_codes_u8():
    data = np.random.default_rng(9).integers(0, 100, 10_000, dtype=np.uint8)
    tree = tpuhuff_torch.HuffTree.from_weights(
        tpuhuff_torch.ByteWeights.from_bytes(data))
    jtree = tpuhuff.HuffTree.from_weights(tpuhuff.ByteWeights.from_bytes(data))
    packed = port_codec.pack_codes_u8(data, *tree.encode_tables())
    assert packed == jax_codec.pack_codes_u8(data, *jtree.encode_tables())
    assert port_codec.unpack_codes_u8(*packed, tree) == data.tobytes()
    assert port_codec.unpack_codes_u8(b"", 0, tree) == b""
    one = tpuhuff_torch.HuffTree.from_weights({7: 3})
    assert port_codec.unpack_codes_u8(b"\xe0", 5, one) == b"\x07" * 3


def test_tree_dfa_codes_and_equality():
    data = np.random.default_rng(4).integers(0, 60, 5000, dtype=np.uint8)
    tree = tpuhuff_torch.HuffTree.from_weights(
        tpuhuff_torch.ByteWeights.from_bytes(data))
    jtree = tpuhuff.HuffTree.from_weights(tpuhuff.ByteWeights.from_bytes(data))
    for a, b in zip(tree.decode_dfa(), jtree.decode_dfa()):
        assert np.array_equal(a, b)
    assert tree.num_leaves() == jtree.num_leaves() == 60
    assert tree == tpuhuff_torch.HuffTree.from_weights(
        tpuhuff_torch.ByteWeights.from_bytes(data))
    assert tree != tpuhuff_torch.HuffTree.from_weights({1: 1, 2: 1})
    code = next(iter(tree.read_codes().values()))
    jcode = next(iter(jtree.read_codes().values()))
    assert code == code.to01() and code == list(code) and code == jcode.to01()
    assert len(code) == len(jcode)
    assert hash(code) == hash(jcode)
    assert code.bits().to01() == jcode.bits().to01()


def test_bits_and_offset_bytes():
    for mod in (port_bits, jax_bits):
        s = mod.BitString.from_bits([1, 0, 1, 1])
        s.extend(mod.BitString.from_bits([0, 1]))
        assert s.to01() == "101101" and s.pop() == 1 and s.to01() == "10110"
        assert s == mod.BitString.from_bits([1, 0, 1, 1, 0])
        assert hash(s) == hash(mod.BitString(0b10110, 5))
    for data in (b"", b"\xff", b"\x12\x34\x56"):
        for n in range(0, 20, 3):
            assert port_bits.offset_bytes(data, n) == jax_bits.offset_bytes(data, n)
    with pytest.raises(ValueError):
        port_bits.offset_bytes(b"\x01", -1)


def test_byte_weights_methods():
    data = np.random.default_rng(8).integers(0, 256, 100_000, dtype=np.uint8)
    pw = port_weights.ByteWeights.threaded_from_bytes(data, 3)
    jw = jax_weights.ByteWeights.threaded_from_bytes(data, 3)
    assert np.array_equal(pw.counts, jw.counts)
    assert pw == port_weights.ByteWeights.from_bytes(data)
    assert list(pw.items()) == list(jw.items())
    assert pw.get(int(data[0])) == jw.get(int(data[0]))
    assert port_weights.ByteWeights().is_empty() and not pw.is_empty()
    total = pw + pw
    pw.add_byte_weights(pw)
    assert total == pw and hash(total) == hash(pw)


def test_utils_and_letter_types():
    for n, k in ((10, 3), (2, 5), (9, 9), (0, 2)):
        seq = list(range(n))
        assert port_utils.ration_vec(seq, k) == jax_utils.ration_vec(seq, k)
    for name in ("u8", "u16", "u32", "u64", "u128", "usize",
                 "i8", "i16", "i32", "i64", "i128", "isize"):
        assert (port_letters.letter_type(name).__dict__
                == jax_letters.letter_type(name).__dict__)
        assert port_utils.size_of_bits(name) == jax_utils.size_of_bits(name)
    port_letters.I8.check(-128)
    for lt, bad in ((port_letters.I8, 128), (port_letters.U16, -1),
                    (port_letters.U8, 256)):
        with pytest.raises(ValueError, match="out of range"):
            lt.check(bad)
    with pytest.raises(KeyError, match="unknown letter type"):
        port_letters.letter_type("f32")

