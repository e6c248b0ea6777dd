"""Port parity: training and encoding of vaq_tpu_torch against vaq_tpu on
the same seeded numpy inputs (CPU).

Training is compared through statistics, not bits: XᵀX and the k-means
distances are f32 sums taken in another order, which can flip eigenvector
signs, turn near-degenerate eigenvector pairs, and move a near-equidistant
point to the other cluster. Eigenvalues agree to rtol 1e-5, the bit
allocation is identical, and k-means centroids agree to 1e-5 from the same
init over a few iterations. Encoding from the same projected rows and
centroids gives identical codes. Ragged configurations (padded dims,
sentinel-padded codebooks, truncated subspaces) build the same shapes and
bits in both packages and search alike on a shared state.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vaq_tpu
import vaq_tpu_torch
from test_torch_scan_decoded import assert_topk_match
from test_torch_vaq import jax_state
from vaq_tpu import bitalloc as jbitalloc
from vaq_tpu import kmeans as jkmeans
from vaq_tpu import pca as jpca
from vaq_tpu import vaq as jvaq
from vaq_tpu_torch import bitalloc, kmeans, pca, vaq
from vaq_tpu_torch.convert import index_from_numpy
from vaq_tpu_torch.data import make_anisotropic_gaussian

torch.set_num_threads(2)  # six test workers share the host


def _data(n=4000, d=64, seed=0):
    rng = np.random.default_rng(seed)
    scales = (0.9 ** np.arange(d)).astype(np.float32)
    return (rng.standard_normal((n, d)).astype(np.float32) * scales
            @ rng.standard_normal((d, d)).astype(np.float32))


@pytest.mark.parametrize("m,var", [(16, 1.0), (8, 0.9)])
def test_train_rotation_matches_jax(m, var):
    """Eigenvalues within rtol 1e-5, plus an absolute 1e-6 of the largest:
    an f32 XᵀX carries rounding errors of the size of its largest entries,
    which the smallest eigenvalues of a wide spectrum feel in full."""
    x, _ = make_anisotropic_gaussian(4000, 64, 1, seed=0)
    rj = jpca.train_rotation(x, m, var, seed=7)
    rt = pca.train_rotation(x, m, var, seed=7, device="cpu")
    np.testing.assert_allclose(rt.eigvals, rj.eigvals, rtol=1e-5,
                               atol=1e-6 * float(rj.eigvals.max()))
    np.testing.assert_allclose(rt.var_per_subs, rj.var_per_subs, rtol=1e-5,
                               atol=1e-6)
    assert (rt.highest_subs, rt.subs_len) == (rj.highest_subs, rj.subs_len)
    # eigenvectors equal up to sign where the spectrum is well separated
    ev = rj.eigvals.astype(np.float64)
    gap = np.minimum(np.abs(np.diff(ev, prepend=np.inf)),
                     np.abs(np.diff(ev, append=-np.inf))) / ev.max()
    cos = np.abs(np.sum(rt.eigvecs * rj.eigvecs, axis=0))
    np.testing.assert_allclose(cos[gap > 1e-3], 1.0, atol=1e-4)


def test_uncentered_cov_blocks(monkeypatch):
    """Block accumulation gives XᵀX whatever the block size."""
    x = _data(n=1000, d=16)
    monkeypatch.setattr(pca, "COV_BLOCK_ROWS", 300)
    cov = pca.uncentered_cov(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(cov, x.astype(np.float64).T @ x, rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("seed", range(6))
def test_bitalloc_identical(seed):
    """The copied DP allocates exactly the JAX package's bits."""
    rng = np.random.default_rng(seed)
    var = np.sort(rng.random(32) ** 3)[::-1] + 1e-6
    var /= var.sum()
    budget, lo, hi = [(256, 7, 8), (128, 1, 8), (96, 0, 6), (64, 2, 4),
                      (200, 5, 8), (160, 3, 9)][seed]
    args = (var, budget, lo, hi)
    kw = dict(cum_var=np.cumsum(var), percent_var_explained=0.95)
    np.testing.assert_array_equal(bitalloc.allocate_bits(*args, **kw),
                                  jbitalloc.allocate_bits(*args, **kw))


def test_bitalloc_from_both_rotations_identical():
    x = _data()
    for m in (8, 16, 32):
        rj = jpca.train_rotation(x, m)
        rt = pca.train_rotation(x, m, device="cpu")
        np.testing.assert_array_equal(
            bitalloc.allocate_bits(rt.var_per_subs, 4 * m, 1, 8),
            jbitalloc.allocate_bits(rj.var_per_subs, 4 * m, 1, 8))


@pytest.mark.parametrize("g,n,d,k,iters", [(3, 2000, 4, 16, 3),
                                           (2, 500, 8, 32, 2),
                                           (1, 50, 4, 64, 1)])
def test_fit_many_matches_jax(g, n, d, k, iters):
    """Same numpy init draw, a few Lloyd steps: centroids within 1e-5."""
    xs = np.random.default_rng(g).standard_normal((g, n, d)).astype(np.float32)
    cj = jkmeans.fit_many(jnp.asarray(xs), k, iters=iters, seed=11)
    ct = kmeans.fit_many(torch.as_tensor(xs), k, iters=iters, seed=11)
    assert ct.shape == (g, k, d)
    np.testing.assert_allclose(ct.numpy(), cj, rtol=1e-5, atol=1e-5)


def test_fit_many_init_identical():
    """Zero iterations return the init rows, drawn exactly as JAX draws."""
    xs = np.random.default_rng(0).standard_normal((4, 300, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        kmeans.fit_many(torch.as_tensor(xs), 24, iters=0, seed=5).numpy(),
        jkmeans.fit_many(jnp.asarray(xs), 24, iters=0, seed=5))


def test_fit_matches_jax():
    x = np.random.default_rng(1).standard_normal((3000, 4)).astype(np.float32)
    cj, aj = jkmeans.fit(x, 32, iters=4, seed=3)
    ct, at = kmeans.fit(torch.as_tensor(x), 32, iters=4, seed=3)
    np.testing.assert_allclose(ct.numpy(), cj, rtol=1e-5, atol=1e-5)
    assert (at.numpy() == aj).mean() >= 0.999


def test_lloyd_empty_cluster_keeps_centroid():
    x = torch.tensor([[0.0, 0.0], [0.1, 0.0], [5.0, 5.0]])
    c0 = torch.tensor([[0.0, 0.0], [5.0, 5.0], [100.0, 100.0]])
    c = kmeans.lloyd(x, c0, iters=2)
    np.testing.assert_allclose(c.numpy(), [[0.05, 0.0], [5.0, 5.0],
                                           [100.0, 100.0]], rtol=1e-6)


def test_encode_blocked_identical_with_sentinels(monkeypatch):
    """Same projected rows and (sentinel-padded) centroids: identical codes,
    whatever the block size; padded rows are never chosen."""
    rng = np.random.default_rng(2)
    m, c, l = 8, 16, 4
    cents = rng.standard_normal((m, c, l)).astype(np.float32)
    cents[::2, 10:] = vaq.PAD_SENTINEL
    xp = rng.standard_normal((3000, m * l)).astype(np.float32)
    cj = np.asarray(jvaq._encode_blocked(jnp.asarray(xp), jnp.asarray(cents)))
    for br in (32768, 700):
        monkeypatch.setattr(vaq, "ENCODE_BLOCK_ROWS", br)
        ct = vaq._encode_blocked(torch.as_tensor(xp),
                                 torch.as_tensor(cents)).numpy()
        np.testing.assert_array_equal(ct, cj)
    assert ct[:, ::2].max() < 10


def test_encode_matches_jax_given_its_rotation_and_codebooks(sift_like):
    """Encoding the base with the JAX index's eigvecs and centroids: the
    projection is an f32 matmul summed in another order, so a row whose two
    best centroids tie to the last bit may differ; ≥ 99.9% are identical."""
    base, _, _ = sift_like
    cfg = vaq_tpu.parse_method_string("VAQ128m16min6max8var1,HEAP")
    jidx = vaq_tpu.VAQIndex(cfg).train(base[:2000]).encode(base)
    tidx = index_from_numpy(*jax_state(jidx), "cpu")
    tidx.encode(base)
    assert tidx.codes.dtype == torch.uint8
    same = (tidx.codes_rowmajor() == jidx.codes_rowmajor())
    assert same.mean() >= 0.999, same.mean()


@pytest.mark.parametrize("method", ["VAQ64m16min2max6var1,HEAP",
                                    "VAQ36m16min3max8var0.9,HEAP"])
def test_ragged_configs_match_jax(method):
    """d = 60 zero-padded to 64 (io.pad_dims), subspaces with fewer bits than
    max (sentinel-padded codebooks) and, at var0.9, fewer kept subspaces than
    M: both tiers match the JAX index on its converted state, and the port
    trains the same shapes and bits itself."""
    from vaq_tpu.data import make_anisotropic_gaussian
    base, queries = make_anisotropic_gaussian(3000, 60, 6, seed=2)
    jidx = vaq_tpu.VAQIndex(vaq_tpu.parse_method_string(method))
    jidx.train(base).encode(base)
    tidx = index_from_numpy(*jax_state(jidx), "cpu")
    assert (jidx.bits < jidx.config.max_bits).any()
    for backend in ("decoded", "codes"):
        d_j, i_j = jidx.search(queries, 2, backend=backend)
        d_t, i_t = tidx.search(queries, 2, backend=backend)
        assert_topk_match(d_t, i_t, d_j, i_j, rtol=1e-5)
    own = vaq_tpu_torch.VAQIndex(vaq_tpu_torch.parse_method_string(method),
                                device="cpu")
    own.build(base)
    assert own.eigvecs.shape == (64, 64) and own.orig_dim == 60
    assert own.highest_subs == jidx.highest_subs
    np.testing.assert_array_equal(own.bits, jidx.bits)
    assert own.search(queries, 2, backend="codes")[1].min() >= 0
