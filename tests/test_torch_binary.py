"""The port's binary engine (vaq_tpu_torch/binary.py) against the JAX
package's (vaq_tpu/binary.py), both on the CPU, at the sizes of
tests/test_binary.py (4000 × 128, 64 queries; bit budgets 64, 128, 256).

Training and encoding are host numpy in both packages, so the states are
bit-equal. Hamming distances are integers and Jaccard distances one IEEE
division of integers, and both packages keep JAX's tie order (the k lowest
by (distance, id) in the flat scans, by (distance, candidate position) in
the cluster probe), so those searches must return identical ids and
distances — on tie data too, where every k-th place is a tie group. JAX's
``query`` defaults to ``approx_max_k`` on its matmul backend; the port's
top-k is exact, so the matmul backend is held to JAX's ``exact=True``.
Exact L2 / Manhattan scans sum floats in another order: Manhattan
distances to 1e-5 relative; L2 ones, formed by the matmul identity, which
cancels, to 1e-5 of ‖q‖² + ‖x‖² (``l2_atol``); ids up to ties at the k-th
distance (``assert_topk_match``).
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vaq_tpu.native
from test_torch_scan_decoded import assert_topk_match
from vaq_tpu import binary as jb
from vaq_tpu_torch import binary as tb
from vaq_tpu_torch import io as port_io
from vaq_tpu_torch import native as tnative
from vaq_tpu_torch.convert import (binary_index_from_numpy,
                                   hamming_clusters_from_numpy)

torch.set_num_threads(2)  # six test workers share the host

BUDGETS = [64, 128, 256]


def words_np(t):
    """A port word tensor as JAX's uint32 array."""
    return t.cpu().numpy().view(np.uint32)


def assert_same(a, b):
    """Two (dists, ids) results identical, dtypes included."""
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, (x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y)


def l2_atol(queries, base):
    """1e-5 of the largest ‖q‖² + ‖x‖²: the size of the terms the L2
    matmul identity sums."""
    return 1e-5 * float((queries ** 2).sum(1).max() + (base ** 2).sum(1).max())


def jax_state(idx):
    arrays = {"eigvecs": idx.eigvecs, "bits": idx.bits,
              "boundaries": idx.boundaries,
              "packed": np.asarray(idx.packed)}
    meta = {"bit_budget": idx.bit_budget, "seed": idx.seed,
            "total_bits": idx.total_bits, "orig_dim": idx.orig_dim,
            "n_rows": idx.n_rows}
    return arrays, meta


@pytest.fixture(scope="module", params=BUDGETS)
def pair(request, sift_like):
    """(budget, base, queries, JAX index, port index), each trained and
    encoded by its own package."""
    base, queries, _ = sift_like
    b = request.param
    jidx = jb.BinaryIndex(bit_budget=b).train(base).encode(base)
    tidx = tb.BinaryIndex(bit_budget=b, device="cpu").train(base).encode(base)
    return b, base, queries, jidx, tidx


@pytest.fixture(scope="module")
def tie_pair():
    """A state with four distinct bit patterns over 1000 rows: every
    distance ties with hundreds of rows."""
    rng = np.random.default_rng(5)
    protos = rng.standard_normal((4, 32)).astype(np.float32)
    base = protos[rng.integers(0, 4, 1000)]
    queries = base[:20] + 0.3 * rng.standard_normal((20, 32)).astype(np.float32)
    jidx = jb.BinaryIndex(bit_budget=32).train(base).encode(base)
    tidx = tb.BinaryIndex(bit_budget=32, device="cpu").train(base).encode(base)
    assert len(np.unique(np.asarray(jidx.packed), axis=0)) == 4
    return base, queries, jidx, tidx


# ---------------------------------------------------------------------------
# Packing
# ---------------------------------------------------------------------------

PACK_CASES = {
    "one_word": np.array([4, 4, 8, 2, 6]),
    "straddle": np.array([12, 12, 12]),
    "alloc": np.array([8, 7, 7, 6, 6, 5, 5, 4, 3, 3, 2, 1, 1, 0, 1, 0, 0, 5]),
}


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("case", sorted(PACK_CASES))
def test_pack_codes_and_unpack_equal(case, native, monkeypatch):
    """pack_codes/unpack_bits_01 bit-equal to JAX's on the native and on
    the numpy path, a dimension straddling a word boundary included."""
    bits = PACK_CASES[case]
    rng = np.random.default_rng(len(bits))
    buckets = np.stack([rng.integers(0, 1 << b, size=300) for b in bits],
                       axis=1)
    if not native:
        monkeypatch.setattr(tnative, "_mod", None)
        monkeypatch.setattr(tnative, "_tried", True)
        monkeypatch.setattr(vaq_tpu.native, "_mod", None)
        monkeypatch.setattr(vaq_tpu.native, "_tried", True)
    got = tb.pack_codes(buckets, bits)
    want = jb.pack_codes(buckets, bits)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    total = int(bits.sum())
    np.testing.assert_array_equal(tb.unpack_bits_01(got, total),
                                  jb.unpack_bits_01(want, total))
    dev = tb._unpack_words(tb._device_words(got, torch.device("cpu")), total)
    assert dev.dtype == torch.int8
    np.testing.assert_array_equal(dev.numpy(), jb.unpack_bits_01(want, total))


# ---------------------------------------------------------------------------
# Training and encoding
# ---------------------------------------------------------------------------

def test_train_state_equal(pair):
    b, _, _, jidx, tidx = pair
    for name in ("eigvecs", "bits", "boundaries"):
        np.testing.assert_array_equal(getattr(tidx, name),
                                      getattr(jidx, name))
    assert (tidx.total_bits, tidx.orig_dim) == (jidx.total_bits, jidx.orig_dim)
    assert tidx.total_bits == b


@pytest.mark.parametrize("budget", BUDGETS)
def test_train_simple_state_equal(sift_like, budget):
    base, queries, _ = sift_like
    jidx = jb.BinaryIndex(bit_budget=budget).train_simple(base).encode(base)
    tidx = tb.BinaryIndex(bit_budget=budget,
                          device="cpu").train_simple(base).encode(base)
    for name in ("eigvecs", "bits", "boundaries"):
        np.testing.assert_array_equal(getattr(tidx, name),
                                      getattr(jidx, name))
    assert tidx.total_bits == jidx.total_bits == min(budget, 128)
    np.testing.assert_array_equal(words_np(tidx.packed), np.asarray(jidx.packed))
    assert_same(tidx.query(queries, 20, backend="packed"),
                jidx.query(queries, 20, backend="packed"))


def test_encode_equal(pair):
    _, _, queries, jidx, tidx = pair
    assert tidx.packed.dtype == torch.int32 and tidx.db01.dtype == torch.int8
    np.testing.assert_array_equal(words_np(tidx.packed), np.asarray(jidx.packed))
    np.testing.assert_array_equal(tidx.db01.numpy(), np.asarray(jidx.db01))
    np.testing.assert_array_equal(tidx.db_pop.numpy(), np.asarray(jidx.db_pop))
    np.testing.assert_array_equal(tidx.encode_queries(queries),
                                  jidx.encode_queries(queries))


# ---------------------------------------------------------------------------
# Searches
# ---------------------------------------------------------------------------

def _jax_matmul(jidx, queries, k):
    q01 = jb.unpack_bits_01(jidx.encode_queries(queries), jidx.total_bits)
    d, i = jb.hamming_topk_matmul(jidx.db01, jidx.db_pop, jnp.asarray(q01), k,
                                  exact=True)
    return np.asarray(d), np.asarray(i)


@pytest.mark.parametrize("k", [1, 100])
def test_query_packed_matmul_jaccard_equal(pair, k):
    """Packed (H1's plain version), matmul (against JAX's exact=True),
    auto (= matmul) and Jaccard: identical ids and distances."""
    _, _, queries, jidx, tidx = pair
    packed = tidx.query(queries, k, backend="packed")
    assert_same(packed, jidx.query(queries, k, backend="packed"))
    assert_same(tidx.query(queries, k, backend="matmul"),
                _jax_matmul(jidx, queries, k))
    assert_same(tidx.query(queries, k), packed)
    assert_same(tidx.query(queries, k, metric="jaccard"),
                jidx.query(queries, k, metric="jaccard"))


def test_query_on_tie_data_equal(tie_pair):
    """Few distinct patterns: the k-th place is a tie group of hundreds of
    rows, and the ids must be exactly JAX's (the lowest ids of the group)."""
    base, queries, jidx, tidx = tie_pair
    for k in (7, 300):
        d, i = tidx.query(queries, k, backend="packed")
        assert (np.diff(d, axis=1) == 0).mean() > 0.9
        assert_same((d, i), jidx.query(queries, k, backend="packed"))
        assert_same(tidx.query(queries, k, backend="matmul"),
                    _jax_matmul(jidx, queries, k))
        assert_same(tidx.query(queries, k, metric="jaccard"),
                    jidx.query(queries, k, metric="jaccard"))
        for s in (1, 2):
            assert_same(tidx.query_filtering(queries, k, s),
                        jidx.query_filtering(queries, k, s))
    assert_same(tidx.query_filtering_heap(queries, 30, 2),
                jidx.query_filtering_heap(queries, 30, 2))


def test_hamming_topk_past_n_fills_like_jax():
    """k above the rows: (2^30, −1) fill, as JAX's running merge leaves."""
    rng = np.random.default_rng(2)
    db = rng.integers(0, 2 ** 32, (5, 3), dtype=np.uint32)
    q = rng.integers(0, 2 ** 32, (4, 3), dtype=np.uint32)
    d_j, i_j = jb.hamming_topk_packed(jnp.asarray(db), jnp.asarray(q), 9,
                                      block_rows=2)
    d_t, i_t = tb.hamming_topk_packed(torch.from_numpy(db.view(np.int32)),
                                      torch.from_numpy(q.view(np.int32)), 9,
                                      block_rows=2)
    assert_same((d_t.numpy(), i_t.numpy()), (np.asarray(d_j), np.asarray(i_j)))


def test_query_rerank_equal(pair):
    _, base, queries, jidx, tidx = pair
    d_t, i_t = tidx.query_rerank(queries, base, 10, factor=10)
    d_j, i_j = jidx.query_rerank(queries, base, 10, factor=10)
    assert_topk_match(d_t, i_t, d_j, i_j, rtol=1e-6)


@pytest.mark.parametrize("metric", ["l2", "manhattan"])
def test_query_naive_equal(pair, metric):
    _, base, queries, jidx, tidx = pair
    d_t, i_t = tidx.query_naive(queries, base, 10, metric=metric)
    d_j, i_j = jidx.query_naive(queries, base, 10, metric=metric)
    assert d_t.dtype == np.float32 and i_t.dtype == np.int32
    atol = l2_atol(queries, base) if metric == "l2" else 0.0
    assert_topk_match(d_t, i_t, d_j, i_j, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("s", [1, 2, 4])
def test_filtering_equal(pair, s, monkeypatch):
    """Both filtering variants, on queries (stop at round 1) and on rows of
    the base (zero-distance survivors, later stops); the port's query
    batches (here 7 queries) give the same answers as JAX's one stack."""
    _, base, queries, jidx, tidx = pair
    monkeypatch.setattr(tb, "FILTER_ELEMS", 7 * s * tidx.n_rows)
    for q in (queries[:16], base[:16]):
        assert_same(tidx.query_filtering(q, 10, s),
                    jidx.query_filtering(q, 10, s))
        assert_same(tidx.query_filtering_heap(q, 10, s),
                    jidx.query_filtering_heap(q, 10, s))


# ---------------------------------------------------------------------------
# CRUD and persistence
# ---------------------------------------------------------------------------

def test_crud_sequence_equal(sift_like):
    base, queries, _ = sift_like
    jidx = jb.BinaryIndex(bit_budget=64).train(base[:1000]).encode(base[:1000])
    tidx = tb.BinaryIndex(bit_budget=64,
                          device="cpu").train(base[:1000]).encode(base[:1000])
    np.testing.assert_array_equal(tidx.append(base[1000:1010]),
                                  jidx.append(base[1000:1010]))
    for ids in (1005, [0, 7, -1], np.array([3, 1003])):
        got = tidx.get_bitv(ids)
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, jidx.get_bitv(ids))
    for dead in ([0, 1], [5, 5000, -3], np.arange(990, 1002)):
        tidx.delete(dead)
        jidx.delete(dead)
        assert tidx.n_rows == jidx.n_rows
        np.testing.assert_array_equal(words_np(tidx.packed),
                                      np.asarray(jidx.packed))
        np.testing.assert_array_equal(tidx.db01.numpy(), np.asarray(jidx.db01))
        np.testing.assert_array_equal(tidx.db_pop.numpy(),
                                      np.asarray(jidx.db_pop))
    assert_same(tidx.query(queries, 10), jidx.query(queries, 10,
                                                    backend="packed"))
    with pytest.raises(IndexError):
        tidx.get_bitv(tidx.n_rows)


def test_save_load_both_ways(pair, tmp_path):
    _, _, queries, jidx, tidx = pair
    p_t, p_j = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tidx.save(p_t)
    jidx.save(p_j)
    arrays, _ = port_io.load_index_npz(p_t)
    assert arrays["packed"].dtype == np.uint32
    from_jax = tb.BinaryIndex.load(p_j, device="cpu")
    from_port = jb.BinaryIndex.load(p_t)
    np.testing.assert_array_equal(words_np(from_jax.packed),
                                  np.asarray(jidx.packed))
    np.testing.assert_array_equal(from_jax.db01.numpy(), np.asarray(jidx.db01))
    np.testing.assert_array_equal(np.asarray(from_port.packed),
                                  words_np(tidx.packed))
    assert (from_jax.total_bits, from_jax.n_rows, from_jax.bit_budget) == \
        (jidx.total_bits, jidx.n_rows, jidx.bit_budget)
    assert_same(from_jax.query(queries, 10, backend="packed"),
                from_port.query(queries, 10, backend="packed"))
    bare = binary_index_from_numpy(
        {k: v for k, v in jax_state(jidx)[0].items() if k != "packed"},
        jax_state(jidx)[1], "cpu")
    assert bare.packed is None and bare.n_rows == jidx.n_rows


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_query_naive_streaming_equal(sift_like, tmp_path, native,
                                     monkeypatch):
    """Chunks of 700 rows over 4000 (a short last chunk of 500), merged by
    the native module or by the stable sort."""
    base, queries, gt = sift_like
    if not native:
        monkeypatch.setattr(tnative, "_mod", None)
        monkeypatch.setattr(tnative, "_tried", True)
    p = str(tmp_path / "base.bin")
    base.astype(np.float32).tofile(p)
    d_t, i_t = tb.query_naive_streaming(p, 128, queries[:16], 10,
                                        batch_rows=700, device="cpu")
    d_j, i_j = jb.query_naive_streaming(p, 128, queries[:16], 10,
                                        batch_rows=700)
    assert_topk_match(d_t, i_t, d_j, i_j, rtol=1e-5,
                      atol=l2_atol(queries[:16], base))
    np.testing.assert_array_equal(i_t, gt[:16, :10])


# ---------------------------------------------------------------------------
# The cluster-pruned Hamming probe
# ---------------------------------------------------------------------------

def _converted(jstate):
    return hamming_clusters_from_numpy({
        "centroids": np.asarray(jstate.centroids), "cap": jstate.cap,
        "bucket_words": np.asarray(jstate.bucket_words),
        "bucket_ids": np.asarray(jstate.bucket_ids),
        "sizes": np.asarray(jstate.sizes)}, "cpu")


@pytest.fixture(scope="module")
def cluster_pair(pair):
    _, base, _, jidx, tidx = pair
    jstate = jb.build_hamming_clusters(jidx, base, n_clusters=16, iters=8)
    return jstate, _converted(jstate)


@pytest.mark.parametrize("n_probe", [4, 16])
def test_cluster_probe_equal(pair, cluster_pair, n_probe):
    """JAX's converted state searched by both packages: identical ids and
    distances, with 64 queries (qcap = nq) and with 300 (pick_qcap's
    static capacity, entries dropped)."""
    _, base, queries, jidx, tidx = pair
    jstate, tstate = cluster_pair
    many = base[:300] + 0.1 * queries[:1]
    for q in (queries, many):
        got = tb.query_hamming_clusters(tidx, tstate, q, 20, n_probe)
        want = jb.query_hamming_clusters(jidx, jstate, q, 20, n_probe)
        assert_same(got, want)


def test_cluster_probe_on_tie_data_equal(tie_pair):
    base, queries, jidx, tidx = tie_pair
    jstate = jb.build_hamming_clusters(jidx, base, n_clusters=8, iters=5)
    tstate = _converted(jstate)
    for n_probe in (1, 3, 8):
        assert_same(tb.query_hamming_clusters(tidx, tstate, queries, 40,
                                              n_probe),
                    jb.query_hamming_clusters(jidx, jstate, queries, 40,
                                              n_probe))


def test_build_hamming_clusters_groups_every_row(pair):
    """The port's own build: every row once, in row order within its
    bucket, its words beside it; probing every cluster gives the full
    scan's distances."""
    _, base, queries, _, tidx = pair
    st = tb.build_hamming_clusters(tidx, base, n_clusters=16, iters=8,
                                   device="cpu")
    ids = st.bucket_ids.numpy()
    live = ids >= 0
    assert np.array_equal(np.sort(ids[live]), np.arange(tidx.n_rows))
    assert (live.sum(1) == st.sizes.numpy()).all() and st.cap == ids.shape[1]
    assert all((np.diff(r[r >= 0]) > 0).all() for r in ids)
    np.testing.assert_array_equal(st.bucket_words.numpy()[live],
                                  tidx.packed.numpy()[ids[live]])
    d_full, _ = tidx.query(queries, 20, backend="packed")
    d_cl, i_cl = tb.query_hamming_clusters(tidx, st, queries, 20, 16)
    np.testing.assert_array_equal(d_cl, d_full)


# ---------------------------------------------------------------------------
# ScalarLUTIndex
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lut_pair(sift_like):
    base, queries, _ = sift_like
    jidx = jb.ScalarLUTIndex(bit_budget=128).train(base).encode(base)
    tidx = tb.ScalarLUTIndex(bit_budget=128, device="cpu").train(base)
    return base, queries[:16], jidx, tidx.encode(base)


def test_scalar_lut_state_equal(lut_pair):
    _, _, jidx, tidx = lut_pair
    j, t = jidx._vaq, tidx._vaq
    for name in ("eigvecs", "eigvals", "var_per_subs", "cum_var_per_subs",
                 "bits", "centroids", "centroid_counts"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    assert (t.subs_len, t.highest_subs, t.orig_dim) == \
        (j.subs_len, j.highest_subs, j.orig_dim)
    assert t.config.bit_budget == j.config.bit_budget
    np.testing.assert_array_equal(t.codes_rowmajor(), j.codes_rowmajor())


@pytest.mark.parametrize("backend", ["decoded", "lut_gather"])
def test_scalar_lut_queries_equal(lut_pair, backend):
    _, queries, jidx, tidx = lut_pair
    d_t, i_t = tidx.query(queries, 10, backend=backend)
    d_j, i_j = jidx.query(queries, 10, backend=backend)
    assert_topk_match(d_t, i_t, d_j, i_j, rtol=1e-5)


def test_scalar_lut_refine_and_save(lut_pair, tmp_path):
    base, queries, jidx, tidx = lut_pair
    d_t, i_t = tidx.query_refine(queries, base, 10, factor=10)
    d_j, i_j = jidx.query_refine(queries, base, 10, factor=10)
    assert_topk_match(d_t, i_t, d_j, i_j, rtol=1e-6)
    p = str(tmp_path / "slut.npz")
    tidx.save(p)
    back = jb.ScalarLUTIndex.load(p)
    again = tb.ScalarLUTIndex.load(p, device="cpu")
    assert back.bit_budget == again.bit_budget == tidx.bit_budget
    _, l_back = back.query(queries, 5, backend="decoded")
    _, l_again = again.query(queries, 5, backend="decoded")
    _, l_t = tidx.query(queries, 5, backend="decoded")
    np.testing.assert_array_equal(l_again, l_t)
    np.testing.assert_array_equal(l_back, l_t)


def test_port_index_searches_a_jax_state_in_memory(pair):
    """convert.binary_index_from_numpy on JAX's live state (no file)."""
    _, _, queries, jidx, _ = pair
    tidx = binary_index_from_numpy(*jax_state(jidx), "cpu")
    assert_same(tidx.query(queries, 10, backend="packed"),
                jidx.query(queries, 10, backend="packed"))
    buf = io.BytesIO()
    port_io.save_index_npz(buf, *tidx.state())
    buf.seek(0)
    back = jb.BinaryIndex.load(buf)
    np.testing.assert_array_equal(np.asarray(back.packed),
                                  np.asarray(jidx.packed))
