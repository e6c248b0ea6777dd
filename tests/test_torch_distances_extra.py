"""The port's Jaccard and Manhattan distances (vaq_tpu_torch/ops/distances.py)
and the plain version of kernel H1 (ops/hamming.py) against the JAX
package's (vaq_tpu/ops/distances.py:78-159) and against numpy, on the CPU.

The Jaccard goldens are those of tests/test_distances_extra.py, the
reference's ``test/test-distancefunction.cpp:65-116`` cases. Jaccard values
are one IEEE division of integers in JAX's order, so they and the top-k ids
are equal to JAX's; L1 sums floats in another order (``torch.cdist``):
distances to 1e-5 relative, ids up to ties at the k-th distance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_scan_decoded import assert_topk_match
from vaq_tpu.ops import distances as jdist
from vaq_tpu_torch.ops import distances, hamming

torch.set_num_threads(2)  # six test workers share the host


def words(a):
    """uint32 words as the port's int32 tensor (the bits viewed)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


# (v1, v2, expected) — transcribed from test-distancefunction.cpp:65-116,
# as tests/test_distances_extra.py holds them; the reference packs bits
# MSB-first into u64 words, these are u32 word patterns.
JACCARD_GOLDENS = [
    # interchangeable params
    ((0x0,), (0x1,), 1.0),
    ((0x1,), (0x0,), 1.0),
    ((0x0,), (0xF,), 1.0),
    ((0xF,), (0x0,), 1.0),
    # 4 bit
    ((0x0,), (0x0,), 0.0),
    ((0x8,), (0x8,), 0.0),
    ((0xF,), (0xF,), 0.0),
    ((0x1,), (0x3,), 0.5),
    ((0x1,), (0x7,), 1.0 - 1.0 / 3),
    ((0x1,), (0xF,), 0.75),
    # 8 bit
    ((0x11,), (0x03,), 2.0 / 3),
    ((0x11,), (0x1E,), 4.0 / 5),
    ((0x11,), (0xFF,), 6.0 / 8),
    # 16 bit
    ((0x1111,), (0x0003,), 4.0 / 5),
    ((0x1111,), (0x00FF,), 4.0 / 5),
    ((0x1111,), (0xFFFF,), 3.0 / 4),
    # 32 bit
    ((0x11111111,), (0x00000003,), 8.0 / 9),
    ((0x11111111,), (0x0000FFFF,), 4.0 / 5),
    ((0x11111111,), (0xFFFFFFFF,), 3.0 / 4),
    # 64 bit (two u32 words; reference uses one u64)
    ((0x0, 0x0), (0x0, 0x0), 0.0),
    ((0x0000FFFF, 0x0), (0x0000FFFF, 0x0), 0.0),
    ((0x11111111, 0x0), (0x00000003, 0x0), 8.0 / 9),
    ((0x11111111, 0x0), (0x0000FFFF, 0x0), 4.0 / 5),
    ((0x11111111, 0x0), (0xFFFFFFFF, 0x0), 3.0 / 4),
]


def np_pop(x):
    """Set bits per row of uint32 words, by np.unpackbits."""
    return np.unpackbits(np.ascontiguousarray(x).view(np.uint8),
                         axis=-1).sum(-1)


@pytest.mark.parametrize("v1,v2,expected", JACCARD_GOLDENS)
def test_jaccard_goldens(v1, v2, expected):
    a = np.asarray([list(v1)], np.uint32)
    b = np.asarray([list(v2)], np.uint32)
    got = distances.jaccard_dists(words(a), words(b))
    assert got.dtype == torch.float32 and got.shape == (1, 1)
    assert float(got[0, 0]) == pytest.approx(expected, abs=1e-6)
    want = np.asarray(jdist.jaccard_dists(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("w", [1, 3, 8, 9])
def test_popcount_dists_ref_matches_unpackbits(w):
    """XOR and Jaccard of the plain version against np.unpackbits
    popcounts, B = 2, words with the sign bit set and all-zero rows (an
    empty union) included, over the whole row and over a word range."""
    rng = np.random.default_rng(w)
    q = rng.integers(0, 2 ** 32, (2, 6, w), dtype=np.uint32)
    x = rng.integers(0, 2 ** 32, (2, 41, w), dtype=np.uint32)
    q[0, 0] = 0
    x[0, :3] = 0
    x[1, 0] = 0xFFFFFFFF
    ranges = [(0, w)] + ([(1, w - 1)] if w > 2 else [])
    for lo, hi in ranges:
        qs, xs = q[:, :, None, lo:hi], x[:, None, :, lo:hi]
        got = hamming.popcount_dists_ref(words(q), words(x), "xor", lo, hi)
        assert got.dtype == torch.int32 and got.shape == (2, 6, 41)
        np.testing.assert_array_equal(got.numpy(), np_pop(qs ^ xs))
        inter, union = np_pop(qs & xs), np_pop(qs | xs)
        want = np.where(union == 0, 0.0, 1.0 - inter.astype(np.float32)
                        / np.maximum(union, 1).astype(np.float32))
        got = hamming.popcount_dists(words(q), words(x), "jaccard", lo, hi)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
        assert float(got[0, 0, 0]) == 0.0            # empty union → 0
    with pytest.raises(ValueError, match="word range"):
        hamming.popcount_dists(words(q), words(x), "xor", 0, w + 1)
    with pytest.raises(ValueError, match="op must be"):
        hamming.popcount_dists(words(q), words(x), "and")


@pytest.mark.parametrize("block_rows", [128, 65536])
def test_jaccard_topk_matches_jax(block_rows):
    rng = np.random.default_rng(5)
    db = rng.integers(0, 2 ** 32, (300, 3), dtype=np.uint32)
    q = rng.integers(0, 2 ** 32, (7, 3), dtype=np.uint32)
    db[10:20] = db[5]                                  # exact ties
    q[0] = db[5]
    d_j, i_j = jdist.jaccard_topk(jnp.asarray(db), jnp.asarray(q), 10,
                                  block_rows=block_rows)
    d_t, i_t = distances.jaccard_topk(words(db), words(q), 10,
                                      block_rows=block_rows)
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(i_t[0, :10].numpy(), [5] + list(range(10, 19)))


def test_manhattan_dists_golden_and_jax():
    q = np.asarray([[1.0, 2.0, 3.0]], np.float32)
    x = np.asarray([[1.0, 2.0, 3.0], [0.0, 0.0, 0.0], [2.0, 0.0, 4.0]],
                   np.float32)
    got = distances.manhattan_dists(torch.as_tensor(q), torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy()[0], [0.0, 6.0, 4.0], atol=1e-6)
    rng = np.random.default_rng(3)
    q = rng.standard_normal((5, 24)).astype(np.float32)
    x = rng.standard_normal((40, 24)).astype(np.float32)
    np.testing.assert_allclose(
        distances.manhattan_dists(torch.as_tensor(q), torch.as_tensor(x)),
        np.asarray(jdist.manhattan_dists(jnp.asarray(q), jnp.asarray(x))),
        rtol=1e-5)


@pytest.mark.parametrize("block_rows,k", [(128, 9), (8192, 9), (100, 600)])
def test_manhattan_topk_matches_jax(block_rows, k):
    """Blocked L1 top-k; k above the 500 rows leaves (+inf, −1) entries,
    as JAX's running merge does."""
    rng = np.random.default_rng(9)
    db = rng.standard_normal((500, 24)).astype(np.float32)
    q = rng.standard_normal((6, 24)).astype(np.float32)
    d_j, i_j = jdist.manhattan_topk(jnp.asarray(q), jnp.asarray(db), k,
                                    block_rows=block_rows)
    d_t, i_t = distances.manhattan_topk(torch.as_tensor(q),
                                        torch.as_tensor(db), k,
                                        block_rows=block_rows)
    assert_topk_match(d_t.numpy(), i_t.numpy(), np.asarray(d_j),
                      np.asarray(i_j), rtol=1e-5)
    fin = np.isfinite(np.asarray(d_j))
    np.testing.assert_array_equal(i_t.numpy()[~fin], np.asarray(i_j)[~fin])


def test_running_lowest_breaks_ties_by_id():
    """Equal values across blocks: the lower id first, as JAX's merge of
    the carry (earlier rows) ahead of the block gives."""
    vals = torch.tensor([[3, 1, 1, 2, 1, 1]], dtype=torch.int32)

    def blocks():
        for s in range(0, 6, 2):
            yield vals[:, s:s + 2], s

    d, i = distances.running_lowest(blocks, 4, 2 ** 30)
    assert d.tolist() == [[1, 1, 1, 1]] and i.tolist() == [[1, 2, 4, 5]]
    d, i = distances.running_lowest(blocks, 8, 2 ** 30)
    assert i.tolist() == [[1, 2, 4, 5, 3, 0, -1, -1]]
    assert d[0, -1] == 2 ** 30
