"""Port parity of the TI/IVF cluster probe (vaq_tpu_torch/ivf.py) against
vaq_tpu/ivf.py on the CPU.

Search is held to JAX's on one state: a vaq_tpu index and its probe buckets,
converted (``index_from_numpy``, ``ivf_state_from_numpy``), so no k-means
noise lies between the two. Both sides score the same bf16 queries against
the same int8 rows, products exact, sums in another order. Both return a
distance as ‖q‖² − score, a difference of two numbers of the size of ‖q‖²
that cancels to a far smaller one: distances agree to 1e-5 relative plus
1e-5 of ‖q‖² (``term_atol``), and ids up to ties within that at the k-th
distance (``assert_topk_match``). At d = 96 JAX stores the buckets
transposed (its K6/K8 kernels); the converted state is row-major, as every
port state is. The port's own build is compared through its invariants and
its recall, and row for row where k-means lands alike.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vaq_tpu
import vaq_tpu_torch
from test_torch_scan_decoded import assert_topk_match
from test_torch_vaq import jax_state
from vaq_tpu import ivf as jivf
from vaq_tpu import pca as jpca
from vaq_tpu_torch import ivf, metrics
from vaq_tpu_torch.convert import index_from_numpy, ivf_state_from_numpy
from vaq_tpu_torch.errors import ConfigError, NotReadyError
from vaq_tpu_torch.ops import probe_scan

torch.set_num_threads(2)  # six test workers share the host

METHOD = "VAQ128m16min7max8var1,TI32m16"


def ivf_arrays(st):
    """A JAX IVFState's fields as numpy arrays."""
    arrays = {"centroids": st.centroids, "seg_dims": st.seg_dims,
              "cap": st.cap, "bucket_rows": np.asarray(st.bucket_rows),
              "bucket_ids": np.asarray(st.bucket_ids),
              "sizes": np.asarray(st.sizes), "transposed": st.transposed}
    if st.dim_scales is not None:
        arrays["dim_scales"] = np.asarray(st.dim_scales)
    return arrays


def converted(jidx, state=None):
    """The port index holding the JAX index's state and probe buckets
    (``state``, the index's own by default), with no decoded tier
    resident."""
    tidx = index_from_numpy(*jax_state(jidx), "cpu")
    tidx.ivf = ivf.IVFSearcher(
        ivf_state_from_numpy(ivf_arrays(state or jidx.ivf.state), "cpu"),
        jidx.ivf.visit)
    return tidx


def jax_probe(jidx, queries, k, visit, resident, state=None):
    """JAX's probe search of ``queries`` on ``state`` (the index's own by
    default); the exact second stage runs when ``resident`` (JAX's build
    leaves the decoded tier resident)."""
    qp = jpca.project(queries, jidx.eigvecs, jidx.total_dim)
    d, i = jivf.IVFSearcher(state or jidx.ivf.state, visit).search(
        jidx if resident else None, jnp.asarray(qp), None, k)
    return np.asarray(d), np.asarray(i)


def term_atol(jidx, queries, rtol=1e-5):
    """rtol of the largest ‖q‖² of the batch: the size of the terms a
    probe distance ‖q‖² − score is the difference of."""
    qp = np.asarray(jpca.project(queries, jidx.eigvecs, jidx.total_dim))
    return rtol * float((qp * qp).sum(axis=1).max())


def port_probe(tidx, queries, k, visit, resident):
    tidx.ivf.visit = visit
    if resident:
        tidx._ensure_decoded()
    else:
        tidx.decoded = tidx.decoded_norms = None
    return tidx.search(queries, k, backend="ivf")


@pytest.fixture(scope="module")
def ti_pair(sift_like):
    """(base, queries, gt, JAX index with probe state, port index on the
    same converted state) — the fixture of tests/test_ivf.py:15-21."""
    base, queries, gt = sift_like
    jidx = vaq_tpu.VAQIndex(vaq_tpu.parse_method_string(METHOD))
    jidx.train(base).encode(base)
    jivf.attach_ivf(jidx)
    return base, queries, gt, jidx, converted(jidx)


@pytest.fixture(scope="module")
def port_built(ti_pair):
    """A port index that built its own probe state (on the CPU) from the
    JAX index's codes."""
    jidx = ti_pair[3]
    own = index_from_numpy(*jax_state(jidx), "cpu")
    vaq_tpu_torch.attach_ivf(own)
    return own


@pytest.fixture(scope="module")
def d96_pair():
    """The d = 96 fixture of tests/test_ivf.py:153-185: JAX stores these
    buckets transposed."""
    from vaq_tpu.ops.distances import exact_search
    rng = np.random.default_rng(5)
    base = (rng.standard_normal((4096, 96)) *
            np.linspace(3.0, 0.3, 96)[None, :]).astype(np.float32)
    queries = base[rng.choice(4096, 64, replace=False)] + \
        0.05 * rng.standard_normal((64, 96)).astype(np.float32)
    gt = np.asarray(exact_search(jnp.asarray(queries), jnp.asarray(base),
                                 10)[1])
    jidx = vaq_tpu.VAQIndex(
        vaq_tpu.parse_method_string("VAQ192m24min7max8var1,TI16m24"))
    jidx.train(base).encode(base)
    jivf.attach_ivf(jidx, visit=1.0)
    assert jidx.ivf.state.transposed
    return base, queries, gt, jidx, converted(jidx)


# --- host-side helpers, copied verbatim -------------------------------------

@pytest.mark.parametrize("n,ncl,cap,s", [(1000, 10, 120, 8), (500, 7, 80, 3),
                                         (300, 4, 75, 4), (64, 8, 8, 8)])
def test_fill_capacity_and_bucket_slots_match_jax(n, ncl, cap, s):
    """Skewed first choices (half the rows want cluster 0) force the
    round-based fill, and at n = ncl·cap the spill path; the candidates as
    ``build_ivf`` (int64) and ``build_ivf_streamed`` (int32) give them."""
    rng = np.random.default_rng(n)
    cand = np.stack([rng.permutation(ncl)[:s] for _ in range(n)])
    cand[: n // 2, 0] = 0
    want = jivf._fill_capacity(cand, ncl, cap)
    for dtype in (torch.int64, torch.int32):
        got = ivf._fill_capacity(torch.as_tensor(cand).to(dtype), ncl, cap)
        np.testing.assert_array_equal(got.numpy(), want)
        for g, r in zip(ivf._bucket_slots(got, ncl, cap),
                        jivf._bucket_slots(want, ncl, cap)):
            np.testing.assert_array_equal(g.numpy(), r)
    assert want.min() >= 0 and np.bincount(want, minlength=ncl).max() <= cap


@pytest.mark.parametrize("cap", [1, 188, 512, 513, 1500, 32768, 32769, 99000])
def test_round_cap_matches_jax(cap):
    assert ivf._round_cap(cap) == jivf._round_cap(cap)


def test_resolve_seg_num_matches_jax():
    cum = np.linspace(0.1, 1.0, 16)
    for method in ("VAQ128m16min7max8var1,TI32m4",
                   "VAQ128m16min7max8var1,TI32var0.5",
                   "VAQ128m16min7max8var1,TI32"):
        assert ivf.resolve_seg_num(vaq_tpu_torch.parse_method_string(method),
                                   cum, 16) == \
            jivf.resolve_seg_num(vaq_tpu.parse_method_string(method), cum, 16)


# --- search on one converted state ------------------------------------------

@pytest.mark.parametrize("visit,k,nq", [(0.25, 10, 64), (1.0, 20, 17),
                                        (0.1, 5, 64)])
@pytest.mark.parametrize("resident", [False, True])
def test_ivf_search_matches_jax(ti_pair, visit, k, nq, resident):
    """With and without the decoded tier resident: only with it does the
    exact second stage over the top 2k run (ivf.py:740-763)."""
    _, queries, _, jidx, tidx = ti_pair
    d_j, i_j = jax_probe(jidx, queries[:nq], k, visit, resident)
    d_t, i_t = port_probe(tidx, queries[:nq], k, visit, resident)
    assert (tidx.decoded is not None) == resident
    assert d_t.dtype == np.float32 and i_t.dtype == np.int32
    assert_topk_match(d_t, i_t, d_j, i_j, rtol=1e-5,
                      atol=term_atol(jidx, queries[:nq]))


@pytest.mark.parametrize("resident", [False, True])
def test_ivf_search_d96_matches_jax(d96_pair, resident):
    """d = 96: JAX runs its transposed-layout kernels (K6/K8), the port K5/K7
    on row-major rows."""
    _, queries, _, jidx, tidx = d96_pair
    assert tidx.ivf.state.bucket_rows.shape == (16, jidx.ivf.state.cap, 96)
    d_j, i_j = jax_probe(jidx, queries, 10, 1.0, resident)
    d_t, i_t = port_probe(tidx, queries, 10, 1.0, resident)
    assert_topk_match(d_t, i_t, d_j, i_j, rtol=1e-5,
                      atol=term_atol(jidx, queries))


@pytest.mark.parametrize("k,nq", [(10, 64), (100, 512), (150, 1), (5, 300),
                                  (50, 1000)])
@pytest.mark.parametrize("visit", [1e-9, 0.1, 0.5, 1.0])
def test_params_match_jax(ti_pair, k, nq, visit):
    """(p_visit, p_max, qcap, gs) decide what is scanned and what drops:
    JAX's rule on the same state (qcap = nq up to 256, pick_qcap above)."""
    jidx, tidx = ti_pair[3], ti_pair[4]
    got = ivf.IVFSearcher(tidx.ivf.state, visit).params(k, nq)
    assert got == jivf.IVFSearcher(jidx.ivf.state, visit).params(k, nq)[:4]


@pytest.mark.parametrize("visit", [1e-9, 0.1, 1.0])
def test_probes_match_jax(ti_pair, d96_pair, visit):
    """The legacy ``probes(k)`` accessor, ``params(k, 1)``'s p_max, equals
    JAX's on the converted states, from the k that one cluster holds to k
    past the visit's own probes."""
    for jidx, tidx in ((ti_pair[3], ti_pair[4]), (d96_pair[3], d96_pair[4])):
        port = ivf.IVFSearcher(tidx.ivf.state, visit)
        jax_ = jivf.IVFSearcher(jidx.ivf.state, visit)
        for k in (1, 10, 100, 1000):
            assert port.probes(k) == jax_.probes(k) == port.params(k, 1)[1]


def test_converted_state_is_row_major(d96_pair, ti_pair):
    for jidx, tidx in ((d96_pair[3], d96_pair[4]), (ti_pair[3], ti_pair[4])):
        js, ts = jidx.ivf.state, tidx.ivf.state
        rows = np.asarray(js.bucket_rows)
        if js.transposed:
            rows = rows.swapaxes(1, 2)
        assert ts.bucket_rows.dtype == torch.int8
        np.testing.assert_array_equal(ts.bucket_rows.numpy(), rows)
        np.testing.assert_array_equal(ts.bucket_ids.numpy(),
                                      np.asarray(js.bucket_ids))
        assert (ts.cap, ts.seg_dims, ts.ncl, ts.d_full) == \
            (js.cap, js.seg_dims, js.ncl, js.d_full)


# --- the port's own build -----------------------------------------------------

def test_port_built_state_invariants(port_built, ti_pair):
    """Every row once, cap a multiple of 512 within JAX's bound, sizes the
    live-id counts, dead slots id −1 holding the poison pattern."""
    base = ti_pair[0]
    st = port_built.ivf.state
    ids = st.bucket_ids.numpy()
    assert st.bucket_rows.shape == (32, st.cap, 128)
    assert st.bucket_rows.dtype == torch.int8
    valid = ids[ids >= 0]
    assert len(valid) == base.shape[0] == len(np.unique(valid))
    assert st.cap % 512 == 0
    cap_bound = max(int(st.sizes.max()), int(np.ceil(1.5 * base.shape[0] / 32)))
    assert st.cap <= -(-cap_bound // 512) * 512
    np.testing.assert_array_equal(st.sizes.numpy(), (ids >= 0).sum(axis=1))
    rows = st.bucket_rows.numpy()
    assert (rows[ids < 0] == probe_scan.poison_pattern(128)).all()


def _rows_by_id(ids, rows, cap):
    """(each live row id's bucket row, its cluster) of a row-major state."""
    ids = np.asarray(ids).reshape(-1)
    live = np.nonzero(ids >= 0)[0]
    out = np.empty((live.size, rows.shape[-1]), rows.dtype)
    out[ids[live]] = np.asarray(rows).reshape(-1, rows.shape[-1])[live]
    clus = np.empty(live.size, np.int64)
    clus[ids[live]] = live // cap
    return out, clus


def test_port_built_rows_match_jax(port_built, ti_pair):
    """k-means from the same numpy init lands (almost) every row in JAX's
    cluster; each row's int8 bucket row is JAX's exactly (same bf16 decode,
    same scales, round-half-even)."""
    jst = ti_pair[3].ivf.state
    st = port_built.ivf.state
    np.testing.assert_array_equal(st.dim_scales.numpy(),
                                  np.asarray(jst.dim_scales))
    rows_t, clus_t = _rows_by_id(st.bucket_ids.numpy(),
                                 st.bucket_rows.numpy(), st.cap)
    rows_j, clus_j = _rows_by_id(jst.bucket_ids, jst.bucket_rows, jst.cap)
    np.testing.assert_array_equal(rows_t, rows_j)
    assert (clus_t == clus_j).mean() >= 0.99
    np.testing.assert_allclose(st.centroids, jst.centroids, rtol=1e-4,
                               atol=1e-4)


def test_port_built_visit_knob_monotone(port_built, ti_pair):
    """tests/test_ivf.py:64-75 on the port's own build."""
    queries, gt = ti_pair[1], ti_pair[2]
    recalls = []
    for visit in (0.1, 0.5, 1.0):
        port_built.ivf.visit = visit
        _, labels = port_built.search(queries, 20, backend="ivf")
        assert labels.min() >= 0
        recalls.append(metrics.avg_recall(labels, gt, 20))
    assert recalls[0] <= recalls[1] + 0.02 <= recalls[2] + 0.04, recalls
    assert recalls[2] > 0.6 and recalls[0] > 0.3, recalls


def test_port_built_full_visit_matches_decoded(port_built, ti_pair):
    """tests/test_ivf.py:44-61: at visit 1.0 the probe sits at the
    exhaustive decoded tier's recall."""
    queries, gt = ti_pair[1], ti_pair[2]
    port_built.ivf.visit = 1.0
    _, l_ivf = port_built.search(queries, 50, backend="ivf")
    _, l_dec = port_built.search(queries, 50, backend="decoded")
    r_ivf = metrics.avg_recall(l_ivf, gt, 50)
    r_dec = metrics.avg_recall(l_dec, gt, 50)
    assert abs(r_ivf - r_dec) < 0.02, (r_ivf, r_dec)


def test_port_built_visit_until_k(port_built, ti_pair):
    """VAQ.cpp:1548-1551: a visit floor of one cluster still extends the
    probe until ≥ k members were seen, so k finite results come back."""
    queries = ti_pair[1]
    port_built.ivf.visit = 1e-9
    d, labels = port_built.search(queries[:8], 150, backend="ivf")
    assert (labels >= 0).all() and np.isfinite(d).all()


def test_port_built_correlated_queries_drop_nothing(port_built, ti_pair):
    """tests/test_ivf.py:109-120: 64 identical queries probe the same
    clusters; qcap = nq, so nothing drops."""
    q_same = np.repeat(ti_pair[1][:1], 64, axis=0)
    port_built.ivf.visit = 0.25
    _, labels = port_built.search(q_same, 10, backend="ivf")
    assert (labels >= 0).all()
    np.testing.assert_array_equal(labels, np.repeat(labels[:1], 64, axis=0))


def test_prebuild_tombstones_never_return(ti_pair):
    """Rows deleted before the build arrive as +inf decoded norms: their
    slots are dead (id −1, poison), the live counts leave them out, and the
    probe never returns them (ivf.py:198-201, 247)."""
    base, queries, gt, jidx, _ = ti_pair
    arrays, meta = jax_state(jidx)
    dead = np.unique(gt[:16, 0])
    arrays["deleted_ids"] = dead
    idx = index_from_numpy(arrays, meta, "cpu")
    vaq_tpu_torch.attach_ivf(idx, visit=1.0)
    st = idx.ivf.state
    ids = st.bucket_ids.numpy()
    assert not np.isin(ids[ids >= 0], dead).any()
    assert int(st.sizes.sum()) == base.shape[0] - dead.size
    rows = st.bucket_rows.numpy()
    assert (rows[ids < 0] == probe_scan.poison_pattern(128)).all()
    _, lab = idx.search(queries[:16], 10, backend="ivf")
    assert (lab >= 0).all() and not np.isin(lab, dead).any()


def test_port_built_d96_is_row_major_at_decoded_recall(d96_pair):
    """The port's own build at d = 96: row-major (ncl, cap, 96) int8
    buckets, and at visit 1.0 the recall of the decoded tier
    (tests/test_ivf.py:172-185)."""
    _, queries, gt, jidx, _ = d96_pair
    own = index_from_numpy(*jax_state(jidx), "cpu")
    vaq_tpu_torch.attach_ivf(own, visit=1.0)
    st = own.ivf.state
    assert st.bucket_rows.shape == (16, st.cap, 96) and st.d_full == 96
    _, lab = own.search(queries, 10, backend="ivf")
    _, lab_x = own.search(queries, 10, backend="decoded")
    rec = metrics.avg_recall(lab, gt, 10)
    rec_x = metrics.avg_recall(lab_x, gt, 10)
    assert abs(rec - rec_x) < 0.02, (rec, rec_x)


def test_bf16_buckets_match_jax(ti_pair):
    """rows_dtype="bf16": the bucket rows are the decoded tier's own bf16
    rows with 1e15 sentinels, no scales and no second stage; the port
    builds them from the same state and searches like JAX's bf16 state."""
    _, queries, _, jidx, _ = ti_pair
    jst = jivf.build_ivf(jidx, rows_dtype="bf16")
    tidx = converted(jidx, jst)
    assert tidx.ivf.state.bucket_rows.dtype == torch.bfloat16
    assert tidx.ivf.state.dim_scales is None
    d_j, i_j = jax_probe(jidx, queries, 10, 0.25, True, jst)
    d_t, i_t = port_probe(tidx, queries, 10, 0.25, True)
    assert_topk_match(d_t, i_t, d_j, i_j, rtol=1e-5,
                      atol=term_atol(jidx, queries))
    with pytest.raises(ConfigError, match="rows_dtype"):
        ivf.build_ivf(tidx, rows_dtype="fp8")


# --- routing --------------------------------------------------------------------

def test_auto_takes_the_probe_only_with_ti_and_state(ti_pair):
    """vaq.py:629-640: "auto" takes the probe when the config has TI and the
    state exists; "ivf" without state raises NotReadyError; a config
    without TI serves the decoded tier even with state attached."""
    _, queries, _, jidx, tidx = ti_pair
    tidx.ivf.visit = 0.25
    _, i_auto = tidx.search(queries[:8], 10)
    _, i_ivf = tidx.search(queries[:8], 10, backend="ivf")
    np.testing.assert_array_equal(i_auto, i_ivf)

    arrays, meta = jax_state(jidx)
    bare = index_from_numpy(arrays, meta, "cpu")
    with pytest.raises(NotReadyError, match="attach_ivf"):
        bare.search(queries[:8], 10, backend="ivf")
    _, i_bare = bare.search(queries[:8], 10)
    _, i_dec = bare.search(queries[:8], 10, backend="decoded")
    np.testing.assert_array_equal(i_bare, i_dec)

    meta["config"]["methods"] = int(vaq_tpu_torch.SearchMethod.HEAP)
    plain = index_from_numpy(arrays, meta, "cpu")
    plain.ivf = tidx.ivf
    np.testing.assert_array_equal(plain.search(queries[:8], 10)[1], i_dec)
