"""Port parity for the whole slice: a vaq_tpu index's state converted into a
vaq_tpu_torch index (convert.index_from_numpy) must search like the JAX
index, on both tiers, with refine, through npz in both directions and with
tombstones. (A port-trained index is held to the JAX index's recall in
tests/test_torch_recall.py.)

Tolerances: on a shared state both sides rescore exactly in f32 (sums in
different orders), so distances agree to rtol 1e-5 and ids agree up to ties
at the k-th distance (``assert_topk_match``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vaq_tpu
import vaq_tpu_torch
from test_torch_scan_decoded import assert_topk_match
from vaq_tpu_torch import metrics
from vaq_tpu_torch.convert import index_from_numpy
from vaq_tpu_torch.errors import ConfigError, NotReadyError, ShapeError

torch.set_num_threads(2)  # six test workers share the host

METHOD = "VAQ128m16min7max8var1,HEAP"


def jax_state(idx):
    """A vaq_tpu index's state as save() would write it."""
    arrays = {k: getattr(idx, k) for k in (
        "eigvecs", "eigvals", "var_per_subs", "cum_var_per_subs", "bits",
        "centroids", "centroid_counts")}
    arrays["codes"] = idx.codes_rowmajor()
    if idx.deleted_ids is not None:
        arrays["deleted_ids"] = idx.deleted_ids
    cfg = {k: v for k, v in dataclasses.asdict(idx.config).items()
           if k not in ("methods", "hardcoded_bits")}
    meta = {"config": {**cfg, "methods": int(idx.config.methods),
                       "hardcoded_bits": None},
            "subs_len": idx.subs_len, "highest_subs": idx.highest_subs,
            "orig_dim": idx.orig_dim, "n_rows": idx.n_rows}
    return arrays, meta


@pytest.fixture(scope="module")
def pair():
    """(base, queries, JAX index, port index on the same state) — the
    fixture of tests/test_scan_pallas.py:185-200."""
    from vaq_tpu.data import make_sift_like
    base, queries, _ = make_sift_like(n=8000, n_queries=8, d=64, seed=3)
    jidx = vaq_tpu.VAQIndex(vaq_tpu.parse_method_string(METHOD))
    jidx.train(base).encode(base)
    return base, queries, jidx, index_from_numpy(*jax_state(jidx))


def test_convert_holds_the_state(pair):
    _, _, jidx, tidx = pair
    assert tidx.codes.dtype == torch.uint8 and tidx.codes.is_contiguous()
    np.testing.assert_array_equal(tidx.codes_rowmajor(), jidx.codes_rowmajor())
    np.testing.assert_array_equal(tidx.centroids, jidx.centroids)
    assert (tidx.n_rows, tidx.total_dim, tidx.orig_dim) == \
        (jidx.n_rows, jidx.total_dim, jidx.orig_dim)
    assert tidx.config == vaq_tpu_torch.parse_method_string(METHOD)


@pytest.mark.parametrize("k", [5, 50])
def test_decoded_tier_matches_jax(pair, k):
    _, queries, jidx, tidx = pair
    d_j, i_j = jidx.search(queries, k, backend="decoded")
    d_t, i_t = tidx.search(queries, k, backend="decoded")
    assert d_t.dtype == np.float32 and i_t.dtype == np.int32
    assert_topk_match(d_t, i_t, d_j, i_j, rtol=1e-5)
    d_a, i_a = tidx.search(queries, k)          # auto serves the decoded tier
    np.testing.assert_array_equal(i_a, i_t)


@pytest.mark.parametrize("k", [2, 5])
def test_codes_tier_matches_jax(pair, k):
    """The JAX codes tier runs its Pallas kernels in interpret mode; the
    port runs K1/K2's plain versions."""
    _, queries, jidx, tidx = pair
    assert tidx._codes_block_rows(k) == jidx._codes_block_rows(k)
    d_j, i_j = jidx.search(queries, k, backend="codes")
    d_t, i_t = tidx.search(queries, k, backend="codes", query_batch=3)
    assert_topk_match(d_t, i_t, d_j, i_j, rtol=1e-5)


def test_codes_matches_decoded_and_is_adc_exact(pair):
    """tests/test_scan_pallas.py:185-205 on the port: top-1 agrees with the
    decoded tier; returned distances are exact ADC sums."""
    _, queries, _, tidx = pair
    _, i_dec = tidx.search(queries, 5, backend="decoded")
    d_cod, i_cod = tidx.search(queries, 5, backend="codes")
    assert (i_dec[:, 0] == i_cod[:, 0]).mean() >= 0.9
    qp = queries @ tidx.eigvecs[:, :tidx.total_dim]
    codes = tidx.codes_rowmajor()[i_cod.reshape(-1)].astype(np.int64)
    m = tidx.highest_subs
    xhat = tidx.centroids[np.arange(m)[None, :], codes].reshape(8, 5, -1)
    ref = ((qp[:, None, :] - xhat) ** 2).sum(2)
    np.testing.assert_allclose(d_cod, ref, rtol=1e-4, atol=1e-3)


def test_codes_falls_back_to_decoded_when_windows_are_few(pair):
    """k too large for 64·k windows of ≥ 16 rows: the decoded tier serves,
    as in JAX (vaq.py:442-449)."""
    _, queries, jidx, tidx = pair
    assert tidx._codes_block_rows(20) is None
    d_c, i_c = tidx.search(queries, 20, backend="codes")
    d_d, i_d = tidx.search(queries, 20, backend="decoded")
    np.testing.assert_array_equal(i_c, i_d)


def test_refine_matches_jax(pair):
    base, queries, jidx, tidx = pair
    _, cand = jidx.search(queries, 40)
    d_j, i_j = jidx.refine(queries, cand, base, 10)
    d_t, i_t = tidx.refine(queries, cand, base, 10)
    assert_topk_match(d_t, i_t, d_j, i_j, rtol=1e-6)


def test_npz_from_jax_to_port(pair, tmp_path):
    _, queries, jidx, tidx = pair
    jidx.save(str(tmp_path / "jax.npz"))
    loaded = vaq_tpu_torch.VAQIndex.load(str(tmp_path / "jax.npz"))
    np.testing.assert_array_equal(loaded.codes_rowmajor(),
                                  tidx.codes_rowmajor())
    np.testing.assert_array_equal(loaded.eigvecs, tidx.eigvecs)
    for backend in ("decoded", "codes"):
        np.testing.assert_array_equal(
            loaded.search(queries, 5, backend=backend)[1],
            tidx.search(queries, 5, backend=backend)[1])


def test_npz_from_port_to_jax(pair, tmp_path):
    _, queries, jidx, tidx = pair
    tidx.save(str(tmp_path / "port.npz"))
    back = vaq_tpu.VAQIndex.load(str(tmp_path / "port.npz"))
    assert back.config == jidx.config
    np.testing.assert_array_equal(back.codes_rowmajor(),
                                  jidx.codes_rowmajor())
    d_j, i_j = back.search(queries, 5, backend="decoded")
    d_t, i_t = tidx.search(queries, 5, backend="decoded")
    assert_topk_match(d_t, i_t, d_j, i_j, rtol=1e-5)
    # and the port reads its own file back to the same state
    again = vaq_tpu_torch.VAQIndex.load(str(tmp_path / "port.npz"))
    for a, b in zip(again.state()[0].values(), tidx.state()[0].values()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("backend,k", [("decoded", 5), ("codes", 5),
                                       ("codes", 2)])
def test_tombstones_match_jax(pair, tmp_path, backend, k):
    """Deleted rows never return: +inf norms on the decoded tier, over-fetch
    plus an on-device filter on the codes tier, as in JAX."""
    _, queries, jidx, _ = pair
    jidx.save(str(tmp_path / "x.npz"))
    jdel = vaq_tpu.VAQIndex.load(str(tmp_path / "x.npz"))
    _, i0 = jdel.search(queries, k, backend=backend)
    dead = np.unique(i0[:, :2])          # each query's current best two
    jdel.delete(dead)
    # search_device is the JAX path with the on-device filter (vaq.py:461-477)
    # that the port mirrors; JAX's host search() sizes its codes windows for
    # k + #deleted instead and here falls back to the decoded tier
    d_j, i_j = jdel.search_device(jnp.asarray(queries), k, backend=backend,
                                  exact=True)
    tdel = index_from_numpy(*jax_state(jdel))
    d_t, i_t = tdel.search(queries, k, backend=backend)
    assert not np.isin(i_t, dead).any()
    assert_topk_match(d_t, i_t, d_j, i_j, rtol=1e-5)


def test_metrics_match_jax():
    from vaq_tpu import metrics as jmetrics
    rng = np.random.default_rng(12)
    pred = rng.integers(0, 60, (10, 20))
    gt = rng.integers(1, 61, (10, 30))
    for name, args in (("avg_recall", (20, 1)), ("recall_at_r", (5, 1)),
                       ("mean_average_precision", (20, 1))):
        assert getattr(metrics, name)(pred, gt, *args) == \
            getattr(jmetrics, name)(pred, gt, *args), name


def test_unported_backends_and_bad_inputs_raise(pair):
    _, queries, _, tidx = pair
    for backend in ("decoded8", "ivf", "lut", "fast4", "lut_gather"):
        with pytest.raises(ConfigError, match="ROADMAP slice"):
            tidx.search(queries, 5, backend=backend)
        with pytest.raises(ConfigError, match="ROADMAP slice"):
            tidx.search_device(torch.as_tensor(queries), 5, backend=backend)
    with pytest.raises(ConfigError, match="unknown backend"):
        tidx.search(queries, 5, backend="bogus")
    with pytest.raises(ShapeError):
        tidx.search(queries[:, :10], 5)
    with pytest.raises(ShapeError):
        tidx.search(queries[0], 5)
    fresh = vaq_tpu_torch.VAQIndex(tidx.config)
    with pytest.raises(NotReadyError):
        fresh.search(queries, 5)
    with pytest.raises(NotReadyError):
        fresh.encode(queries)


def test_unported_fast_search_and_wide_training_raise(pair, tmp_path):
    """A FAST-family index loads (its LUT quantizers survive a save/load
    round trip) but its auto search raises until slice 3; >8-bit
    hierarchical codebooks raise in train."""
    _, queries, jidx, _ = pair
    arrays, meta = jax_state(jidx)
    meta["config"]["methods"] = int(vaq_tpu_torch.SearchMethod.FAST2)
    m = jidx.highest_subs
    arrays["lut_offsets"] = np.linspace(0, 1, m, dtype=np.float32)
    arrays["lut_scales"] = np.full(m, 3.0, np.float32)
    fast = index_from_numpy(arrays, meta)
    with pytest.raises(ConfigError, match="FAST"):
        fast.search(queries, 5)
    fast.save(str(tmp_path / "fast.npz"))
    back = vaq_tpu_torch.VAQIndex.load(str(tmp_path / "fast.npz"))
    np.testing.assert_array_equal(back.lut_offsets, arrays["lut_offsets"])
    np.testing.assert_array_equal(back.lut_scales, arrays["lut_scales"])
    wide = vaq_tpu_torch.VAQConfig(bit_budget=38, subspace_num=4,
                                   min_bits=9, max_bits=10,
                                   hierarchical_kmeans=True)
    x = np.random.default_rng(0).standard_normal((300, 8)).astype(np.float32)
    with pytest.raises(ConfigError, match="hierarchical"):
        vaq_tpu_torch.VAQIndex(wide).train(x)


def test_codes_tier_refuses_wide_codes(pair):
    """> 8-bit subspaces cannot be u8 codes: the codes tier raises instead
    of truncating (vaq.py:491-504)."""
    _, queries, jidx, _ = pair
    arrays, meta = jax_state(jidx)
    arrays["bits"] = arrays["bits"].copy()
    arrays["bits"][0] = 9
    wide = index_from_numpy(arrays, meta)
    assert wide.codes.dtype == torch.int32
    with pytest.raises(ConfigError, match="<= 8-bit"):
        wide.search(queries, 5, backend="codes")


@pytest.mark.parametrize("n,k", [(8000, 5), (8000, 2), (10**6, 100),
                                 (10**6, 200), (10**7, 10), (500, 1),
                                 (5 * 10**6, 1000)])
def test_codes_block_rows_matches_jax(n, k):
    """The window size decides which candidates survive: it stays the JAX
    rule (vaq.py:506-528)."""
    j = vaq_tpu.VAQIndex(vaq_tpu.parse_method_string(METHOD))
    t = vaq_tpu_torch.VAQIndex(vaq_tpu_torch.parse_method_string(METHOD))
    for idx in (j, t):
        idx.n_rows, idx.highest_subs, idx.subs_len = n, 32, 4
    assert t._codes_block_rows(k) == j._codes_block_rows(k)
