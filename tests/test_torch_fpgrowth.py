"""The port's FP-Growth miner (``vaq_tpu_torch/fpgrowth.py``, a copy of
``vaq_tpu/fpgrowth.py``) against the JAX package's: the same patterns and
supports on random transactions (and both against a brute force), the same
order out of ``filter_patterns``, and the same patterns on the codes of a
small port-trained index whose bit allocation is not uniform."""

import itertools

import numpy as np
import pytest

import vaq_tpu_torch
from vaq_tpu import fpgrowth as jfp
from vaq_tpu_torch import fpgrowth


def brute_force(transactions, min_support):
    """Every itemset of the observed items with its support."""
    sets = [frozenset(t) for t in transactions]
    items = sorted(set().union(*sets))
    out = {}
    for r in range(1, len(items) + 1):
        kept = False
        for combo in itertools.combinations(items, r):
            c = sum(1 for t in sets if frozenset(combo) <= t)
            if c >= min_support:
                out[frozenset(combo)] = c
                kept = True
        if not kept:
            break
    return out


@pytest.mark.parametrize("seed,n,universe,tlen,sup", [
    (0, 40, 8, 5, 2), (1, 60, 10, 4, 3), (2, 25, 6, 6, 4), (3, 80, 12, 3, 5),
    (4, 120, 9, 6, 6)])
def test_growth_equals_jax_and_brute_force(seed, n, universe, tlen, sup):
    rng = np.random.default_rng(seed)
    txns = [rng.integers(0, universe, size=rng.integers(1, tlen + 1)).tolist()
            for _ in range(n)]
    got = fpgrowth.fptree_growth(txns, sup)
    assert got == jfp.fptree_growth(txns, sup) == brute_force(txns, sup)
    for min_size, maximal in ((1, False), (2, True), (2, False), (3, True)):
        assert fpgrowth.filter_patterns(got, min_size, maximal) == \
            jfp.filter_patterns(got, min_size, maximal)


def test_min_support_below_one_raises_as_jax():
    for mod in (fpgrowth, jfp):
        with pytest.raises(ValueError, match="min_support"):
            mod.fptree_growth([[1]], 0)


def test_offsets_are_jax_exclusive_cumsum():
    """JAX's fix of the reference's item offsets, kept: the exclusive
    cumulative sum, collision-free on a non-uniform allocation."""
    cnum = [256, 128, 128, 64, 16]
    got = fpgrowth.subspace_offsets(cnum)
    assert np.array_equal(got, jfp.subspace_offsets(cnum))
    assert got.tolist() == [0, 256, 384, 512, 576]


def test_patterns_of_a_port_index_with_non_uniform_bits():
    """``find_frequent_patterns`` on the codes of a port-trained index whose
    subspaces hold 2 to 6 bits: the port's patterns and supports, and their
    filtered order, equal JAX's on the same codes."""
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((600, 16)) *
         np.linspace(3.0, 0.3, 16)[None, :]).astype(np.float32)
    idx = vaq_tpu_torch.VAQIndex(
        vaq_tpu_torch.parse_method_string("VAQ16m4min2max6var1,HEAP"),
        device="cpu").train(x).encode(x)
    counts = [int(c) for c in idx.centroid_counts]
    assert len(set(counts)) > 1, counts       # a non-uniform allocation
    codes = idx.codes_rowmajor()
    got = fpgrowth.find_frequent_patterns(codes, 5, counts)
    assert got == jfp.find_frequent_patterns(codes, 5, counts)
    assert max(len(p) for p in got) >= 3
    assert fpgrowth.filter_patterns(got) == jfp.filter_patterns(got)
    with pytest.raises(ValueError, match="subspaces"):
        fpgrowth.find_frequent_patterns(codes, 5, counts[:-1])
