"""The generators repeat exactly from the seed and differ across seeds."""

import numpy as np
import pytest

import corpus
import harness

CONFIGS = ("text_hf2", "mixed_hf2")
BIG = 2**31 + 4321  # the driver's seeds do not fit 32 signed bits


def _corpus(config):
    return harness.load_cell({"text_hf2": "text_hf2.compress_100m",
                              "mixed_hf2": "mixed_hf2.compress_1g"}[config]
                             ).config["corpus"]


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("seed", (0, 7, BIG, 2**63 + 5))
def test_same_seed_same_bytes(config, seed):
    c = _corpus(config)
    a = corpus.make(c, 300_001, seed, 3)
    b = corpus.make(c, 300_001, seed, 3)
    assert a.dtype == np.uint8 and a.size == 300_001
    assert np.array_equal(a, b)


@pytest.mark.parametrize("config", CONFIGS)
def test_seeds_and_objects_differ(config):
    c = _corpus(config)
    base = corpus.make(c, 1 << 16, BIG, 0)
    assert not np.array_equal(base, corpus.make(c, 1 << 16, BIG + 1, 0))
    assert not np.array_equal(base, corpus.make(c, 1 << 16, BIG, 1))


def test_mixed_parts_follow_the_recipes():
    data = corpus.make(_corpus("mixed_hf2"), 3 << 16, 5, 0)
    text, rand, geo = data[: 1 << 16], data[1 << 16: 2 << 16], data[2 << 16:]
    # text: mostly the sentence's letters; uniform: all 256 values, flat;
    # geometric: P(byte >= k) = 0.98^k
    assert np.count_nonzero(np.bincount(text, minlength=256)) < 256
    assert np.bincount(rand, minlength=256).min() > 0
    assert abs(np.mean(geo >= 50) - 0.98 ** 50) < 0.02
    assert abs(np.mean(text == ord(" ")) - 0.16) < 0.03
