"""Port parity of the index mutations (vaq_tpu_torch/vaq.py ``add``,
``delete``, ``get_codes``, ``reconstruct``; ``ivf.poison_deleted``) against
vaq_tpu on the CPU (tests/test_vaq_e2e.py:213-250, 287-332, 355-373).

Each test mutates one JAX index and the port index converted from its
state, probe buckets included (``convert.index_from_numpy``,
``convert.ivf_state_from_numpy``), the same way, and compares what comes
out. On a realistic state the searches agree as the unmutated ones do
(tests/test_torch_vaq.py, test_torch_ivf.py): distances to rtol 1e-5 (plus
1e-5 of ‖q‖² on the probe, whose distance is a difference of terms that
size), ids up to ties at the k-th distance. On the tie-exact state of
tests/test_torch_ties.py (identity rotation, small-integer centroids and
queries, duplicated codes) every distance is exact in f32, and the ids must
be JAX's exactly. The poisoned probe state must equal JAX's slot for slot.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vaq_tpu
import vaq_tpu_torch
from test_torch_ivf import converted, ivf_arrays, term_atol
from test_torch_scan_decoded import assert_topk_match
from test_torch_ties import (assert_tied, ivf_tie_state, small_ints,
                             tie_index_state)
from test_torch_vaq import _jax_index, jax_state
from vaq_tpu import ivf as jivf
from vaq_tpu_torch import ivf
from vaq_tpu_torch.convert import index_from_numpy, ivf_state_from_numpy
from vaq_tpu_torch.errors import NotReadyError
from vaq_tpu_torch.ops import probe_scan, scan_codes

torch.set_num_threads(2)  # six test workers share the host

METHOD = "VAQ128m16min7max8var1,TI32m16"
TIERS = ("decoded", "decoded8", "codes", "ivf")


@pytest.fixture(scope="module")
def crud_base(sift_like):
    """(base, queries, rows to add, a JAX index with probe state): the
    fixture of tests/test_torch_ivf.py, plus 300 rows of another draw."""
    from vaq_tpu.data import make_sift_like
    base, queries, _ = sift_like
    jidx = vaq_tpu.VAQIndex(vaq_tpu.parse_method_string(METHOD))
    jidx.train(base).encode(base)
    jivf.attach_ivf(jidx)
    x_new = make_sift_like(n=300, n_queries=1, d=128, seed=43)[0]
    return base, queries, x_new, jidx


def fresh_pair(jidx, resident):
    """A JAX index and the port index on one copy of ``jidx``'s state and
    probe buckets, to be mutated alike; ``resident`` builds both decoded
    tiers first, so the mutations meet them."""
    j = _jax_index(*jax_state(jidx))
    j.ivf = jivf.IVFSearcher(dataclasses.replace(jidx.ivf.state),
                             jidx.ivf.visit)
    t = converted(jidx)
    if resident:
        for idx in (j, t):
            idx._ensure_decoded()
            idx._ensure_decoded8()
    return j, t


def jax_search(j, queries, k, tier):
    """JAX's answer on one tier. The codes tier goes through search_device
    with exact=True, the path the port mirrors: over deleted rows JAX's
    host search() sizes its windows for k + #deleted instead
    (tests/test_torch_vaq.py::test_tombstones_match_jax)."""
    if tier == "codes":
        d, i = j.search_device(jnp.asarray(queries), k, backend="codes",
                               exact=True)
        return np.asarray(d), np.asarray(i)
    return j.search(queries, k, backend=tier)


def assert_tiers_match(j, t, queries, k=10):
    """Every tier of the two indexes answers alike; returns the port's ids
    by tier."""
    out = {}
    for tier in TIERS:
        d_j, i_j = jax_search(j, queries, k, tier)
        d_t, i_t = t.search(queries, k, backend=tier)
        atol = term_atol(j, queries) if tier == "ivf" else 0.0
        assert_topk_match(d_t, i_t, d_j, i_j, rtol=1e-5, atol=atol)
        out[tier] = i_t
    return out


# --- add --------------------------------------------------------------------

@pytest.mark.parametrize("resident", [False, True])
def test_add_matches_jax(crud_base, resident):
    """New ids, the grown codes, every tier's answers; with the probe
    attached, the buckets stay as they were (JAX's add leaves them), so the
    probe never returns an added row."""
    base, queries, x_new, jidx = crud_base
    j, t = fresh_pair(jidx, resident)
    searcher, bucket_ids = t.ivf, t.ivf.state.bucket_ids.clone()
    ids_j, ids_t = j.add(x_new), t.add(x_new)
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_array_equal(ids_t, np.arange(4000, 4300))
    assert t.n_rows == j.n_rows == 4300
    np.testing.assert_array_equal(t.codes_rowmajor(), j.codes_rowmajor())
    assert (t.decoded is not None) == resident and t.decoded8 is None
    if resident:
        assert t.decoded.shape[0] == t.decoded_norms.shape[0] == 4300
    assert t.ivf is searcher and torch.equal(t.ivf.state.bucket_ids,
                                             bucket_ids)
    # the added rows used as queries: the exhaustive tiers find them
    got = assert_tiers_match(j, t, np.concatenate([queries, x_new[:32]]))
    assert (got["decoded"][-32:, 0] == ids_t[:32]).mean() >= 0.9
    assert not (got["ivf"] >= 4000).any()


def test_add_before_encode_raises():
    idx = vaq_tpu_torch.VAQIndex(vaq_tpu_torch.parse_method_string(METHOD),
                                 device="cpu")
    with pytest.raises(NotReadyError, match="encode"):
        idx.add(np.zeros((2, 128), np.float32))


# --- delete -------------------------------------------------------------------

@pytest.mark.parametrize("resident", [False, True])
def test_delete_matches_jax(crud_base, resident):
    """After an add, delete each query's best two, an added row and ids
    beyond the rows, twice over: the union of tombstones, +inf norms on the
    resident tiers, the probe state poisoned as JAX poisons it, and every
    tier's answers JAX's, none of them deleted."""
    base, queries, x_new, jidx = crud_base
    j, t = fresh_pair(jidx, resident)
    for idx in (j, t):
        idx.add(x_new)
        if resident:   # add dropped the int8 tier; rebuild it
            idx._ensure_decoded8()
    _, i0 = t.search(queries, 10, backend="decoded")
    dead = np.unique(np.concatenate([i0[:, :2].ravel(), [4005]]))
    for batch in (dead[::2], dead[1::2], dead[:3]):
        j.delete(batch)
        t.delete(batch)
        t._deleted_device()     # a cached device copy, dropped by delete
    j.delete([10**6])   # beyond the rows: tombstoned, nothing to poison
    t.delete([10**6])
    np.testing.assert_array_equal(t.deleted_ids, j.deleted_ids)
    assert t._deleted_dev is None
    if resident:
        assert torch.isinf(t.decoded_norms[torch.as_tensor(dead)]).all()
        assert torch.isinf(t.decoded8_norms[torch.as_tensor(dead)]).all()
    js, ts = j.ivf.state, t.ivf.state
    np.testing.assert_array_equal(ts.bucket_ids.numpy(),
                                  np.asarray(js.bucket_ids))
    np.testing.assert_array_equal(ts.sizes.numpy(), np.asarray(js.sizes))
    np.testing.assert_array_equal(ts.bucket_rows.numpy(),
                                  np.asarray(js.bucket_rows))
    in_buckets = np.isin(ivf_arrays(jidx.ivf.state)["bucket_ids"], dead)
    assert (ts.bucket_ids.numpy() == -1).sum() == \
        (np.asarray(jidx.ivf.state.bucket_ids) == -1).sum() + in_buckets.sum()
    assert (ts.bucket_rows.numpy()[ts.bucket_ids.numpy() == -1]
            == probe_scan.poison_pattern(128)).all()
    got = assert_tiers_match(j, t, queries)
    for tier, ids in got.items():
        assert not np.isin(ids, dead).any(), tier


def test_delete_out_of_range_ids_touch_no_row(crud_base, monkeypatch):
    """ROADMAP fault 15, a deliberate divergence from JAX (like fault 4):
    ids < 0 and ≥ n name no row in the port. Deleting them leaves the
    codes, the decoded and int8 tiers, the probe buckets and their sizes as
    they were; ``deleted_ids`` keeps them, and the codes tier's over-fetch
    counts them (k + #deleted), as JAX's does, with JAX's answers. JAX's
    scatter wraps −1 to the last row, so its decoded tiers hide row n − 1,
    and its probe matches −1 against every empty slot and takes those off
    its sizes."""
    _, queries, _, jidx = crud_base
    j, t = fresh_pair(jidx, True)
    n = t.n_rows
    tiers = ("codes", "decoded", "decoded_norms", "decoded8",
             "decoded8_norms")
    before = {name: getattr(t, name).clone() for name in tiers}
    st = t.ivf.state
    probe = (st.bucket_rows.clone(), st.bucket_ids.clone(), st.sizes.clone())
    out = np.array([-1, -7, n, n + 5])
    for idx in (j, t):
        idx.delete(out)
    for name in tiers:
        assert torch.equal(getattr(t, name), before[name]), name
    for got, was in zip((st.bucket_rows, st.bucket_ids, st.sizes), probe):
        assert torch.equal(got, was)
    np.testing.assert_array_equal(t.deleted_ids, np.sort(out))
    np.testing.assert_array_equal(t.deleted_ids, j.deleted_ids)

    fetched = []
    real = scan_codes.decode_scan_topk

    def spy(*args, **kw):
        fetched.append(args[4])
        return real(*args, **kw)

    monkeypatch.setattr(scan_codes, "decode_scan_topk", spy)
    k = 3   # 4000 // (64·3) rows: 16-row windows, the codes tier serves
    d_t, i_t = t.search(queries, k, backend="codes")
    assert fetched and set(fetched) == {k + len(out)}
    d_j, i_j = jax_search(j, queries, k, "codes")
    assert_topk_match(d_t, i_t, d_j, i_j, rtol=1e-5)

    assert np.isinf(np.asarray(j.decoded_norms)[n - 1])
    assert np.isinf(np.asarray(j.decoded8_norms)[n - 1])
    assert torch.isfinite(t.decoded_norms[n - 1])
    assert int(np.asarray(j.ivf.state.sizes).sum()) < int(st.sizes.sum())


def test_delete_poisons_like_jax_exactly():
    """The tie-exact probe state (int8 rows from 16 distinct ones, unit
    scales) poisoned by both packages' delete: the same ids, sizes and
    rows, and the probe then returns JAX's ids and distances exactly,
    ties included, and no deleted row. bf16 buckets take the 1e15
    sentinel."""
    arrays, meta = tie_index_state()
    t_arrays, _, _ = ivf_tie_state()
    j = _jax_index(arrays, meta)
    t = index_from_numpy(arrays, meta, "cpu")
    jstate = jivf.IVFState(
        centroids=t_arrays["centroids"], seg_dims=t_arrays["seg_dims"],
        cap=t_arrays["cap"],
        bucket_rows=jnp.asarray(t_arrays["bucket_rows"]),
        bucket_ids=jnp.asarray(t_arrays["bucket_ids"]),
        sizes=jnp.asarray(t_arrays["sizes"]),
        dim_scales=jnp.asarray(t_arrays["dim_scales"]))
    j.ivf = jivf.IVFSearcher(jstate, 0.5)
    t.ivf = ivf.IVFSearcher(ivf_state_from_numpy(t_arrays, "cpu"), 0.5)
    dead = np.random.default_rng(3).choice(2048, 300, replace=False)
    j.delete(dead)
    t.delete(dead)
    js, ts = j.ivf.state, t.ivf.state
    np.testing.assert_array_equal(ts.bucket_ids.numpy(),
                                  np.asarray(js.bucket_ids))
    np.testing.assert_array_equal(ts.sizes.numpy(), np.asarray(js.sizes))
    np.testing.assert_array_equal(ts.bucket_rows.numpy(),
                                  np.asarray(js.bucket_rows))
    assert int(ts.sizes.sum()) == 2048 - 300
    qp = small_ints((6, 16), 33, -4, 5)
    d_j, i_j = jivf.IVFSearcher(js, 0.5).search(None, jnp.asarray(qp),
                                                None, 10)
    d_t, i_t = t.ivf.search(None, torch.as_tensor(qp), 10)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    assert_tied(np.asarray(d_j), at_least=10)
    assert not np.isin(i_t.numpy(), dead).any()

    bf = dict(t_arrays, bucket_rows=t_arrays["bucket_rows"].astype(
        np.float32), dim_scales=None)
    st = ivf_state_from_numpy(bf, "cpu")
    ivf.poison_deleted(st, torch.as_tensor(dead))
    dead_rows = st.bucket_rows[st.bucket_ids == -1]
    assert dead_rows.shape[0] == 300
    assert (dead_rows.float() == torch.tensor(ivf.BF16_SENTINEL).to(
        torch.bfloat16).float()).all()


def test_crud_ties_match_jax_exactly():
    """The tie-exact index of tests/test_torch_ties.py: rows added as
    small-integer points encode to JAX's codes, and after a delete the
    decoded and codes tiers return JAX's ids and distances exactly. (The
    int8 tier's per-dimension scales are not powers of two here, so its
    distances are not exact in f32; it is held to JAX's as on realistic
    data.)"""
    arrays, meta = tie_index_state()
    j = _jax_index(arrays, meta)
    t = index_from_numpy(arrays, meta, "cpu")
    x_new = small_ints((200, 8), 45)
    np.testing.assert_array_equal(t.add(x_new), j.add(x_new))
    np.testing.assert_array_equal(t.codes_rowmajor(), j.codes_rowmajor())
    queries = small_ints((4, 8), 44, -4, 5)
    _, i0 = t.search_device(torch.as_tensor(queries), 4, backend="decoded")
    dead = np.unique(np.concatenate([i0[:, [0, 2]].numpy().ravel(),
                                     [8192, 8300]]))
    j.delete(dead)
    t.delete(dead)
    for tier in ("decoded", "codes", "decoded8"):
        d_j, i_j = j.search_device(jnp.asarray(queries), 4, backend=tier,
                                   exact=True)
        d_t, i_t = t.search_device(torch.as_tensor(queries), 4,
                                   backend=tier)
        assert not np.isin(i_t.numpy(), dead).any(), tier
        if tier == "decoded8":
            assert_topk_match(d_t, i_t, d_j, i_j, rtol=1e-5)
            continue
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
        np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
        assert_tied(np.asarray(d_j))


# --- reads and persistence --------------------------------------------------------

def wide_state(jidx):
    """``jidx``'s state with subspace 0 widened to 9 bits: codes in u16
    (JAX's dtype there), 512 centroids."""
    arrays, meta = jax_state(jidx)
    rng = np.random.default_rng(4)
    arrays["bits"] = arrays["bits"].copy()
    arrays["bits"][0] = 9
    arrays["centroid_counts"] = (1 << arrays["bits"]).astype(np.int64)
    cents = arrays["centroids"]
    wide = np.full((cents.shape[0], 512, cents.shape[2]), 1e18, np.float32)
    wide[:, :cents.shape[1]] = cents
    wide[0, 256:] = rng.standard_normal((256, cents.shape[2]))
    arrays["centroids"] = wide
    codes = arrays["codes"].astype(np.uint16)
    codes[:, 0] += 256 * rng.integers(0, 2, len(codes)).astype(np.uint16)
    arrays["codes"] = codes
    meta = dict(meta, config=dict(meta["config"], max_bits=9))
    return arrays, meta


@pytest.mark.parametrize("wide", [False, True])
def test_get_codes_and_reconstruct_match_jax(crud_base, wide):
    """u8 codes, and u16 where a subspace is wider than 8 bits (the port
    holds int32 on the device): JAX's values and dtype."""
    jidx = crud_base[3]
    arrays, meta = wide_state(jidx) if wide else jax_state(jidx)
    j = _jax_index(arrays, meta)
    t = index_from_numpy(arrays, meta, "cpu")
    assert t.codes.dtype == (torch.int32 if wide else torch.uint8)
    for ids in ([0, 17, 3999], 5, np.arange(40, 90)):
        got, want = t.get_codes(ids), j.get_codes(ids)
        assert got.dtype == want.dtype == (np.uint16 if wide else np.uint8)
        np.testing.assert_array_equal(got, want)
        rec = t.reconstruct(ids)
        assert rec.dtype == np.float32
        np.testing.assert_array_equal(rec, j.reconstruct(ids))
    np.testing.assert_array_equal(t.codes_rowmajor(), j.codes_rowmajor())
    assert t.codes_rowmajor().dtype == j.codes_rowmajor().dtype


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_tombstones_survive_save_load(crud_base, tmp_path, writer):
    """Rows deleted in one package stay deleted after save → load in the
    other (tests/test_vaq_e2e.py:355-373)."""
    base, queries, _, jidx = crud_base
    j, t = fresh_pair(jidx, False)
    _, i0 = t.search(queries, 5, backend="decoded")
    dead = np.unique(i0[:, 0])
    path = str(tmp_path / "del.npz")
    if writer == "port":
        t.delete(dead)
        t.save(path)
        back = vaq_tpu.VAQIndex.load(path)
        src = t
    else:
        j.delete(dead)
        j.save(path)
        back = vaq_tpu_torch.VAQIndex.load(path, device="cpu")
        src = j
    np.testing.assert_array_equal(back.deleted_ids, src.deleted_ids)
    for tier in ("decoded", "codes"):
        _, ids = back.search(queries, 5, backend=tier)
        assert not np.isin(ids, dead).any(), tier
