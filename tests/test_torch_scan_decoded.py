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


# --- D1 (``decoded_topk_scan``): its partition and merge on the CPU --------

def _d1_rows(case, n, d, nq, seed=11):
    """bf16 rows, f32 norms and bf16 queries for a D1 case: ``random``;
    ``ties`` (each row repeated three times, so equal scores abound);
    ``zeros`` (every fifth row zero, its norm −0 or +0 in turn, so −0 and +0
    scores meet at the top); ``tombstones`` (+inf norms on all but 5 rows,
    so the kk lowest hold tombstones)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    if case == "ties":
        x = np.repeat(x[:-(-n // 3)], 3, axis=0)[:n]
    if case == "zeros":
        x[::5] = 0.0
    rows = torch.as_tensor(x).to(torch.bfloat16)
    norms = torch.sum(rows.float() ** 2, dim=1)
    if case == "zeros":
        sign = torch.where(torch.arange(0, n, 5) % 2 == 0, -0.0, 0.0)
        norms[::5] = sign
    if case == "tombstones":
        norms[5:] = torch.inf
    q = torch.as_tensor(rng.standard_normal((nq, d)).astype(np.float32))
    if case == "zeros":
        q = q * 1e-3      # zero rows score best
    return rows, norms, q.to(torch.bfloat16)


D1_CASES = [  # (case, n, d, nq, kk, splits, block_rows)
    ("random", 3000, 128, 7, 26, 33, 1000),
    ("random", 1000, 96, 5, 40, 3, 65536),    # n not a multiple of 64
    ("random", 777, 40, 1, 26, 132, 300),     # nq = 1, more splits than tiles
    ("random", 20, 40, 3, 20, 4, 65536),      # n < 2k: kk = n
    ("ties", 2000, 128, 6, 36, 7, 500),
    ("ties", 130, 96, 2, 130, 2, 65536),
    ("zeros", 1500, 40, 4, 26, 5, 700),
    ("zeros", 900, 128, 3, 200, 11, 65536),
    ("tombstones", 640, 96, 4, 26, 3, 200),
    ("tombstones", 64, 128, 2, 60, 1, 65536),
]


@pytest.mark.parametrize("case,n,d,nq,kk,splits,block_rows", D1_CASES)
def test_d1_partition_and_merge_equal_plain_scan(case, n, d, nq, kk, splits,
                                                 block_rows, monkeypatch):
    """D1's plain version (each split's kk lowest keys, then one sort)
    returns ``_scan_topk``'s ids, id for id and in order: ties to the lower
    id, −0 before +0, −1 for tombstones in the kk lowest."""
    monkeypatch.setattr(scan_decoded, "BLOCK_ROWS", block_rows)
    rows, norms, q = _d1_rows(case, n, d, nq)
    want = scan_decoded._scan_topk(rows, norms, q.float(), kk)
    keys = scan_decoded.decoded_topk_scan_ref(rows, norms, q, kk, splits)
    assert keys.shape == (nq, splits * kk) and keys.dtype == torch.int64
    got = scan_decoded._lowest_split_keys(keys, kk)
    assert got.dtype == torch.int32
    assert torch.equal(got, want)
    if case == "tombstones":
        assert (got[:, 5:] == -1).all() and (got[:, :5] >= 0).all()
    if case == "zeros":
        top = got[:, 0].tolist()
        assert all(i % 5 == 0 and (i // 5) % 2 == 0 for i in top)  # a −0 row


def test_d1_splits_keep_their_own_lowest_keys():
    """Each split holds the kk lowest keys of its own tiles (64-row tile t
    to split t mod S), ascending, and the empty key past its rows: at 300
    rows and 4 splits, split 0 holds tiles 0 and 4 (108 rows), split 3 only
    tile 3 (64 rows, 6 short of kk = 70)."""
    rows, norms, q = _d1_rows("random", 300, 40, 2)
    keys = scan_decoded.decoded_topk_scan_ref(rows, norms, q, 70, 4)
    scores = norms[None, :] - 2.0 * (q.float() @ rows.float().T)
    all_keys = scan_decoded._keys(scores, 0)
    tile_split = (torch.arange(300) // 64) % 4
    for s in range(4):
        mine = torch.sort(all_keys[:, tile_split == s], dim=1).values[:, :70]
        got = keys.reshape(2, 4, 70)[:, s]
        assert torch.equal(got[:, :mine.shape[1]], mine)
        assert (got[:, mine.shape[1]:] == scan_decoded._EMPTY_KEY).all()
    assert (keys.reshape(2, 4, 70)[:, 3] == scan_decoded._EMPTY_KEY).sum(
        dim=1).tolist() == [6, 6]


def test_d1_wrapper_on_cpu_is_its_plain_version_and_path_is_plain():
    """On a CPU tensor the wrapper returns its plain version at the H100's
    split, and ``decoded_scan_topk`` keeps the plain blocked scan."""
    rows, norms, q = _d1_rows("random", 2000, 96, 9)
    geo = scan_decoded._d1_geometry(9, 2000, 96, 26, 132)
    keys = scan_decoded.decoded_topk_scan(rows, norms, q, 26)
    assert torch.equal(keys, scan_decoded.decoded_topk_scan_ref(
        rows, norms, q, 26, geo.splits))
    assert not scan_decoded._d1_takes(rows, 26)
    before = scan_decoded.decoded_topk_scan.launches
    scan_decoded.decoded_scan_topk(rows, norms, q.float(), 5)
    assert scan_decoded.decoded_topk_scan.launches == before


@pytest.mark.parametrize("bad", ["rows_dtype", "q_dtype", "norms_dtype",
                                 "rows_ndim", "q_depth", "norms_len",
                                 "rows_strided", "q_strided", "device",
                                 "kk_zero", "kk_above_n", "kk_above_max",
                                 "too_deep"])
def test_d1_wrapper_rejects_what_it_does_not_take(bad):
    rows, norms, q = _d1_rows("random", 600, 32, 3)
    kk = 26
    if bad == "rows_dtype":
        rows = rows.float()
    elif bad == "q_dtype":
        q = q.float()
    elif bad == "norms_dtype":
        norms = norms.double()
    elif bad == "rows_ndim":
        rows = rows[None]
    elif bad == "q_depth":
        q = q[:, :16].contiguous()
    elif bad == "norms_len":
        norms = norms[:-1]
    elif bad == "rows_strided":
        rows = torch.cat([rows, rows], dim=1)[:, ::2]
    elif bad == "q_strided":
        q = torch.cat([q, q], dim=1)[:, ::2]
    elif bad == "device":
        norms = norms.to("meta")
    elif bad == "kk_zero":
        kk = 0
    elif bad == "kk_above_n":
        rows, norms, q = _d1_rows("random", 20, 32, 3)
        kk = 21
    elif bad == "kk_above_max":
        kk = scan_decoded.D1_MAX_KK + 1
    elif bad == "too_deep":
        d = scan_decoded.D1_MAX_DEPTH + 8
        rows, norms, q = _d1_rows("random", 100, d, 2)
    with pytest.raises(ValueError):
        scan_decoded.decoded_topk_scan(rows, norms, q, kk)


@pytest.mark.parametrize("d", [40, 96, 128, 512, 960])
@pytest.mark.parametrize("kk", [1, 26, 200, 400, 512])
@pytest.mark.parametrize("nq", [1, 100, 1024])
def test_d1_geometry_fits_a_block(d, kk, nq):
    """Every kk up to D1_MAX_KK at every depth up to D1_MAX_DEPTH fits one
    block's shared memory: the queries, heaps, staged keys and their counts
    of its warps
    and a ring of at least one 64-row stage; the grid covers the batch and
    fills the card at most once."""
    geo = scan_decoded._d1_geometry(nq, 10**6, d, kk, 132)
    row = 2 * (-(-d // 16) * 16 + 8)
    qw = 16 * geo.mt
    assert geo.smem == 128 + geo.stages * 64 * row + geo.warps * qw * (
        row + 8 * kk + 132)
    assert geo.smem <= scan_decoded._SMEM_LIMIT
    assert 1 <= geo.stages <= 4 and 1 <= geo.warps <= 8
    assert geo.groups * geo.warps * qw >= nq
    assert geo.groups * geo.splits <= max(132, geo.groups)


def test_d1_geometry_at_the_benchmark_shape():
    """1024 queries × 1M rows × 128 at k = 10 (kk = 26): eight 32-query
    warps, four stages, 4 query groups × 33 row splits on 132 SMs."""
    assert scan_decoded._d1_geometry(1024, 10**6, 128, 26, 132) == \
        scan_decoded.D1Geometry(2, 8, 4, 4, 33, 226432)
