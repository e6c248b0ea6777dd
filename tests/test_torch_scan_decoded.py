"""Port parity: the decoded tier, exact search and refine of vaq_tpu_torch
against vaq_tpu on the same seeded numpy inputs (CPU).

Tolerances: both sides compute in f32 but sum in different orders, so
distances agree to a relative 1e-6 where they are sums of squares (rescore,
refine) and to 1e-5 plus an absolute 1e-4 where the matmul identity
‖q‖² − 2q·x + ‖x‖² cancels (exact search). ``torch.topk`` does not promise
``jax.lax.top_k``'s lower-index-first tie order, so ids are compared as sets
below the k-th distance and up to equal distances at it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaq_tpu.ops import distances as jdist
from vaq_tpu.ops import scan_decoded as jdec
from vaq_tpu.ops import scan_jax as jlut
from vaq_tpu_torch.ops import distances, scan_decoded, scan_lut

torch.set_num_threads(2)  # six test workers share the host


def assert_topk_match(d_a, i_a, d_b, i_b, rtol, atol=0.0):
    """Two ascending top-k results agree: distances elementwise within the
    tolerance, and ids as sets among entries strictly inside the k-th
    distance (entries tied with the boundary may differ)."""
    d_a, d_b = np.asarray(d_a), np.asarray(d_b)
    i_a, i_b = np.asarray(i_a), np.asarray(i_b)
    assert d_a.shape == d_b.shape and i_a.shape == i_b.shape
    np.testing.assert_allclose(d_a, d_b, rtol=rtol, atol=atol)
    for q in range(d_a.shape[0]):
        fin = np.isfinite(d_b[q])
        if not fin.any():
            continue
        edge = d_b[q][fin].max()
        inside = d_b[q] < edge - (rtol * abs(edge) + atol)
        assert set(i_a[q][inside]) == set(i_b[q][inside]), q
        assert (i_a[q] == -1).sum() == (i_b[q] == -1).sum(), q


def _setup(seed=0, n=2000, m=8, c=16, l=4, nq=6):
    rng = np.random.default_rng(seed)
    cent = rng.standard_normal((m, c, l)).astype(np.float32)
    codes = rng.integers(0, c, size=(n, m)).astype(np.uint8)
    q = rng.standard_normal((nq, m * l)).astype(np.float32)
    return cent, codes, q


def _port_decoded(cent, codes):
    return scan_decoded.decode_db(torch.as_tensor(codes),
                                  torch.as_tensor(cent))


@pytest.mark.parametrize("block_rows", [256, 65536])
def test_decode_db_matches_jax(block_rows, monkeypatch):
    """bf16 rows identical (same f32 gather, same RTNE rounding); norms
    within rtol 1e-6 (M·L f32 squares summed in another order)."""
    cent, codes, _ = _setup()
    cent[:, -2:] = 1e18  # padded centroid rows (never addressed)
    codes = np.minimum(codes, cent.shape[1] - 3).astype(np.uint8)
    dec_j, norms_j = jdec.decode_db(jnp.asarray(codes.T), jnp.asarray(cent),
                                    block_rows=256)
    monkeypatch.setattr(scan_decoded, "BLOCK_ROWS", block_rows)
    dec_t, norms_t = _port_decoded(cent, codes)
    assert dec_t.dtype == torch.bfloat16
    np.testing.assert_array_equal(dec_t.float().numpy(),
                                  np.asarray(dec_j, dtype=np.float32))
    np.testing.assert_allclose(norms_t.numpy(), np.asarray(norms_j),
                               rtol=1e-6)


@pytest.mark.parametrize("seed,k", [(0, 10), (1, 20), (2, 5)])
def test_decoded_scan_topk_matches_jax_exact(seed, k, monkeypatch):
    """Same ids and exact distances as the JAX scan with exact=True."""
    cent, codes, q = _setup(seed=seed)
    dec_j, norms_j = jdec.decode_db(jnp.asarray(codes.T), jnp.asarray(cent))
    d_j, i_j = jdec.decoded_scan_topk(dec_j, norms_j, jnp.asarray(q), k,
                                      exact=True)
    dec_t, norms_t = _port_decoded(cent, codes)
    # a small block size exercises the running top-k merge across blocks
    monkeypatch.setattr(scan_decoded, "BLOCK_ROWS", 300)
    d_t, i_t = scan_decoded.decoded_scan_topk(dec_t, norms_t,
                                              torch.as_tensor(q), k)
    assert i_t.dtype == torch.int32
    assert_topk_match(d_t, i_t, d_j, i_j, rtol=1e-6)


def test_decoded_scan_topk_tombstones():
    """Rows with +inf norms never come back; with fewer live rows than k
    the tail is −1 / +inf, as in JAX."""
    cent, codes, q = _setup(seed=3, n=300)
    dead = np.r_[0, 5, 9, 17:300]
    dec_j, norms_j = jdec.decode_db(jnp.asarray(codes.T), jnp.asarray(cent))
    norms_j = norms_j.at[jnp.asarray(dead)].set(jnp.inf)
    d_j, i_j = jdec.decoded_scan_topk(dec_j, norms_j, jnp.asarray(q), 20,
                                      exact=True)
    dec_t, norms_t = _port_decoded(cent, codes)
    norms_t[dead] = torch.inf
    d_t, i_t = scan_decoded.decoded_scan_topk(dec_t, norms_t,
                                              torch.as_tensor(q), 20)
    i_t = i_t.numpy()
    assert not np.isin(i_t, dead).any()
    assert (i_t == -1).sum(axis=1).tolist() == [6] * q.shape[0]
    assert_topk_match(d_t, i_t, d_j, i_j, rtol=1e-6)


def test_decoded_search_e2e_matches_jax():
    """Projection + scan: the same path the index's decoded tier runs."""
    rng = np.random.default_rng(4)
    cent, codes, _ = _setup(seed=4)
    raw = rng.standard_normal((7, 40)).astype(np.float32)
    ev = rng.standard_normal((40, 32)).astype(np.float32)
    dec_j, norms_j = jdec.decode_db(jnp.asarray(codes.T), jnp.asarray(cent))
    d_j, i_j = jdec.decoded_search_e2e(jnp.asarray(raw), jnp.asarray(ev),
                                       dec_j, norms_j, 15, exact=True)
    dec_t, norms_t = _port_decoded(cent, codes)
    d_t, i_t = scan_decoded.decoded_search_e2e(
        torch.as_tensor(raw), torch.as_tensor(ev), dec_t, norms_t, 15)
    assert_topk_match(d_t, i_t, d_j, i_j, rtol=1e-6)


@pytest.mark.parametrize("n,k,block_rows", [(3000, 10, 131072),
                                            (3000, 10, 700), (50, 64, 16)])
def test_exact_search_matches_jax(n, k, block_rows, monkeypatch):
    """Blocked exact search: the matmul identity cancels, hence the absolute
    1e-4 on distances of magnitude ~2·d."""
    rng = np.random.default_rng(5)
    db = rng.standard_normal((n, 32)).astype(np.float32)
    q = rng.standard_normal((20, 32)).astype(np.float32)
    d_j, i_j = jdist.exact_search(jnp.asarray(q), jnp.asarray(db), k)
    monkeypatch.setattr(distances, "BLOCK_ROWS", block_rows)
    d_t, i_t = distances.exact_search(torch.as_tensor(q), torch.as_tensor(db),
                                      k)
    assert_topk_match(d_t, i_t, d_j, i_j, rtol=1e-5, atol=1e-4)


def test_compute_groundtruth_matches_jax():
    rng = np.random.default_rng(6)
    db = rng.standard_normal((2500, 48)).astype(np.float32)
    q = rng.standard_normal((12, 48)).astype(np.float32)
    gt_j = jdist.compute_groundtruth(q, db, 25)
    gt_t = distances.compute_groundtruth(q, db, 25, device="cpu")
    assert gt_t.shape == (12, 25) and gt_t.dtype == np.int32
    # random data has no near-ties at this size: labels are identical
    np.testing.assert_array_equal(gt_t, gt_j)


def test_pairwise_sq_dists_matches_jax():
    rng = np.random.default_rng(7)
    q = rng.standard_normal((9, 16)).astype(np.float32)
    x = rng.standard_normal((33, 16)).astype(np.float32)
    x[3] = q[2]  # an exact zero, clamped at 0 on both sides
    got = distances.pairwise_sq_dists(torch.as_tensor(q), torch.as_tensor(x))
    ref = np.asarray(jdist.pairwise_sq_dists(jnp.asarray(q), jnp.asarray(x)))
    assert float(got.min()) >= 0.0
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("k", [1, 10, 30])
def test_refine_topk_matches_jax(k):
    """Exact rerank; −1 labels (padding) never outrank a real row."""
    rng = np.random.default_rng(8)
    q = rng.standard_normal((6, 24)).astype(np.float32)
    cands = rng.standard_normal((6, 30, 24)).astype(np.float32)
    labels = rng.permutation(1000)[:180].reshape(6, 30).astype(np.int32)
    labels[:, -4:] = -1
    d_j, i_j = jlut.refine_topk(jnp.asarray(q), jnp.asarray(cands),
                                jnp.asarray(labels), k)
    d_t, i_t = scan_lut.refine_topk(torch.as_tensor(q),
                                    torch.as_tensor(cands),
                                    torch.as_tensor(labels), k)
    assert_topk_match(d_t, i_t, d_j, i_j, rtol=1e-6)


def _jax_decoded8(cent, codes):
    return jdec.decode_db_int8(jnp.asarray(codes.T), jnp.asarray(cent),
                               block_rows=256)


def test_decode_db_int8_matches_jax():
    """The int8 tier's rows: JAX's (D, n) int8 matrix transposed to the
    port's row-major (n, D), identical; scales identical (the same f32
    quotient); norms of the f32 decode within rtol 1e-6. Padded centroid
    rows (≥ 1e17) stay out of the scales."""
    cent, codes, _ = _setup(seed=10)
    cent[:, -2:] = 1e18
    codes = np.minimum(codes, cent.shape[1] - 3).astype(np.uint8)
    d8_j, sc_j, n_j = _jax_decoded8(cent, codes)
    d8_t, sc_t, n_t = scan_decoded.decode_db_int8(torch.as_tensor(codes),
                                                  torch.as_tensor(cent))
    assert d8_t.dtype == torch.int8 and d8_t.shape == (codes.shape[0], 32)
    np.testing.assert_array_equal(d8_t.numpy(), np.asarray(d8_j).T)
    np.testing.assert_array_equal(sc_t.numpy(), np.asarray(sc_j))
    np.testing.assert_array_equal(scan_decoded.int8_dim_scales(cent).numpy(),
                                  np.asarray(sc_j))
    np.testing.assert_allclose(n_t.numpy(), np.asarray(n_j), rtol=1e-6)


@pytest.mark.parametrize("seed,k,dead", [(0, 10, False), (1, 20, False),
                                         (2, 5, True), (3, 20, True)])
def test_decoded8_scan_topk_matches_jax_exact(seed, k, dead, monkeypatch):
    """Same ids and exact distances as JAX ``decoded8_scan_topk`` with
    exact=True (its winners rescored from the dequantized int8 rows); with
    tombstones (+inf norms), which never come back."""
    cent, codes, q = _setup(seed=seed, n=1500)
    d8_j, sc_j, n_j = _jax_decoded8(cent, codes)
    d8_t, sc_t, n_t = scan_decoded.decode_db_int8(torch.as_tensor(codes),
                                                  torch.as_tensor(cent))
    gone = np.arange(0, 1500, 7)
    if dead:
        n_j = n_j.at[jnp.asarray(gone)].set(jnp.inf)
        n_t[gone] = torch.inf
    d_j, i_j = jdec.decoded8_scan_topk(d8_j, sc_j, n_j, d8_j, jnp.asarray(q),
                                       k, exact=True)
    monkeypatch.setattr(scan_decoded, "BLOCK_ROWS", 400)
    d_t, i_t = scan_decoded.decoded8_scan_topk(d8_t, sc_t, n_t,
                                               torch.as_tensor(q), k)
    assert d_t.dtype == torch.float32 and i_t.dtype == torch.int32
    if dead:
        assert not np.isin(i_t.numpy(), gone).any()
    assert_topk_match(d_t, i_t, d_j, i_j, rtol=1e-6)
