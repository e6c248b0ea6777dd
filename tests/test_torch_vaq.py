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
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vaq_tpu
import vaq_tpu_torch
from test_torch_scan_decoded import assert_topk_match
from vaq_tpu_torch import io as port_io
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
    if idx.lut_offsets is not None:
        arrays["lut_offsets"] = idx.lut_offsets
        arrays["lut_scales"] = idx.lut_scales
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
    return base, queries, jidx, index_from_numpy(*jax_state(jidx), "cpu")


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
    loaded = vaq_tpu_torch.VAQIndex.load(str(tmp_path / "jax.npz"),
                                          device="cpu")
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
    again = vaq_tpu_torch.VAQIndex.load(str(tmp_path / "port.npz"),
                                        device="cpu")
    for a, b in zip(again.state()[0].values(), tidx.state()[0].values()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("backend,k", [("decoded", 5), ("codes", 5),
                                       ("codes", 2), ("decoded8", 5)])
def test_tombstones_match_jax(pair, tmp_path, backend, k):
    """Deleted rows never return: +inf norms on the decoded and int8 tiers,
    over-fetch plus an on-device filter on the codes tier, as in JAX."""
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
    tdel = index_from_numpy(*jax_state(jdel), "cpu")
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
    """search_device serves the decoded, int8 and codes tiers only: the LUT
    backends raise there (JAX serves the decoded tier instead) and run
    through search(); unknown backends, bad shapes and an untrained index
    raise."""
    _, queries, _, tidx = pair
    for backend in ("lut", "fast4", "lut_gather", "auto", "ivf"):
        with pytest.raises(ConfigError, match="runs through search"):
            tidx.search_device(torch.as_tensor(queries), 5, backend=backend)
    with pytest.raises(ConfigError, match="unknown backend"):
        tidx.search(queries, 5, backend="bogus")
    with pytest.raises(ConfigError, match="unknown backend"):
        tidx.search_device(torch.as_tensor(queries), 5, backend="bogus")
    with pytest.raises(ShapeError):
        tidx.search(queries[:, :10], 5)
    with pytest.raises(ShapeError):
        tidx.search(queries[0], 5)
    fresh = vaq_tpu_torch.VAQIndex(tidx.config, device="cpu")
    with pytest.raises(NotReadyError):
        fresh.search(queries, 5)
    with pytest.raises(NotReadyError):
        fresh.encode(queries)
    with pytest.raises(NotReadyError):
        fresh.learn_quantization(queries)


def test_unported_fast_search_and_wide_training_raise(pair, tmp_path):
    """A FAST-family index with LUT quantizers survives a save/load round
    trip, and its auto search (the quantized LUT gather scan on the CPU)
    matches JAX's on the same state; >8-bit hierarchical codebooks now
    train (tests/test_torch_kmeans_wide.py holds them to JAX's), and the
    codes tier of such an index raises."""
    _, queries, jidx, _ = pair
    arrays, meta = jax_state(jidx)
    meta["config"]["methods"] = int(vaq_tpu_torch.SearchMethod.FAST2)
    m = jidx.highest_subs
    arrays["lut_offsets"] = np.linspace(0, 1, m, dtype=np.float32)
    arrays["lut_scales"] = np.full(m, 3.0, np.float32)
    fast = index_from_numpy(arrays, meta, "cpu")
    fast.save(str(tmp_path / "fast.npz"))
    back = vaq_tpu_torch.VAQIndex.load(str(tmp_path / "fast.npz"),
                                       device="cpu")
    np.testing.assert_array_equal(back.lut_offsets, arrays["lut_offsets"])
    np.testing.assert_array_equal(back.lut_scales, arrays["lut_scales"])
    jfast = vaq_tpu.VAQIndex.load(str(tmp_path / "fast.npz"))
    d_j, i_j = jfast.search(queries, 5)
    d_t, i_t = back.search(queries, 5)
    assert_topk_match(d_t, i_t, d_j, i_j, rtol=1e-5)
    wide = vaq_tpu_torch.VAQConfig(bit_budget=38, subspace_num=4,
                                   min_bits=9, max_bits=10,
                                   hierarchical_kmeans=True)
    x = np.random.default_rng(0).standard_normal((300, 8)).astype(np.float32)
    trained = vaq_tpu_torch.VAQIndex(wide, device="cpu").build(x)
    assert int(trained.bits.min()) >= 9
    with pytest.raises(ConfigError, match="<= 8-bit"):
        trained.search(x[:4], 5, backend="codes")


def test_codes_tier_refuses_wide_codes(pair):
    """> 8-bit subspaces cannot be u8 codes: the codes tier raises instead
    of truncating (vaq.py:491-504)."""
    _, queries, jidx, _ = pair
    arrays, meta = jax_state(jidx)
    arrays["bits"] = arrays["bits"].copy()
    arrays["bits"][0] = 9
    wide = index_from_numpy(arrays, meta, "cpu")
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
    t = vaq_tpu_torch.VAQIndex(vaq_tpu_torch.parse_method_string(METHOD),
                              device="cpu")
    for idx in (j, t):
        idx.n_rows, idx.highest_subs, idx.subs_len = n, 32, 4
    assert t._codes_block_rows(k) == j._codes_block_rows(k)


@pytest.mark.parametrize("k", [5, 40])
def test_decoded8_tier_matches_jax(pair, k):
    """The int8 tier through the index: JAX's search_device with
    exact=True, on the converted state."""
    _, queries, jidx, tidx = pair
    d_j, i_j = jidx.search_device(jnp.asarray(queries), k, backend="decoded8",
                                  exact=True)
    d_t, i_t = tidx.search(queries, k, backend="decoded8", query_batch=5)
    assert tidx.decoded8.dtype == torch.int8
    assert_topk_match(d_t, i_t, np.asarray(d_j), np.asarray(i_j), rtol=1e-6)


# --- The FAST/LUT family (tests/test_vaq_e2e.py:129-190, 335-352, 437-470) --

FAST = "VAQ128m32min1max4var1,FAST"
FAST3 = "VAQ96m16min2max8var1,FAST3"
FAST_LOW = "VAQ48m16min1max3var1,FAST"     # C = 8: the LUTs pad to 16


@pytest.fixture(scope="module")
def fast_data():
    from vaq_tpu.data import make_sift_like
    base, queries, _ = make_sift_like(n=4000, n_queries=8, d=64, seed=5)
    return base, queries


@pytest.fixture(scope="module")
def fast_pairs(fast_data):
    """Per config: (JAX index after learn_quantization, port index on its
    state, port index on its state without the LUT quantizers)."""
    base, _ = fast_data
    out = {}
    for method in (FAST, FAST3, FAST_LOW):
        jidx = vaq_tpu.VAQIndex(vaq_tpu.parse_method_string(method))
        jidx.train(base).encode(base)
        plain = index_from_numpy(*jax_state(jidx), "cpu")
        jidx.learn_quantization(base, sample_ratio=0.05)
        out[method] = (jidx, index_from_numpy(*jax_state(jidx), "cpu"),
                       plain)
    return out


@pytest.mark.parametrize("method", [FAST, FAST3, FAST_LOW])
def test_learn_quantization_matches_jax(fast_pairs, fast_data, method):
    """The same sample, α grid, quantiles and losses: JAX's α wins, with
    its offsets and scales to rtol 1e-5. The offsets are quantiles of LUT
    entries, so they carry the LUT build's tolerance (test_torch_scan_lut):
    1e-5 of the LUT's size as well, here its (1 − α) quantile,
    offset + 255/scale."""
    jidx, _, plain = fast_pairs[method]
    plain.learn_quantization(fast_data[0], sample_ratio=0.05)
    size = np.max(jidx.lut_offsets + 255.0 / jidx.lut_scales)
    np.testing.assert_allclose(plain.lut_offsets, jidx.lut_offsets,
                               rtol=1e-5, atol=1e-5 * size)
    np.testing.assert_allclose(plain.lut_scales, jidx.lut_scales, rtol=1e-5)
    plain.lut_offsets = plain.lut_scales = None


def test_learn_quantization_device_matches_jax(fast_pairs):
    """The α-grid search itself on one f32 LUT sample: JAX's offsets and
    scales to rtol 1e-5, its losses to rtol 1e-4 (f32 sums of 108,000
    squared errors each, blocked and reduced in another order), and the
    same α; a quarter of the entries are padding."""
    from vaq_tpu.vaq import _learn_quantization_device as jax_learn
    from vaq_tpu_torch.vaq import LUT_ALPHAS, _learn_quantization_device
    rng = np.random.default_rng(11)
    luts = (rng.random((1500, 6, 16)) ** 2 * 50.0).astype(np.float32)
    counts = np.array([16, 8, 16, 4, 16, 12], np.int32)
    valid = np.arange(16)[None, :] < counts[:, None]
    alphas = np.asarray(LUT_ALPHAS, np.float32)
    want = [np.asarray(a) for a in jax_learn(
        jnp.asarray(luts), jnp.asarray(valid), jnp.asarray(counts),
        jnp.asarray(alphas))]
    got = [a.numpy() for a in _learn_quantization_device(
        torch.as_tensor(luts), torch.as_tensor(valid),
        torch.as_tensor(counts), torch.as_tensor(alphas))]
    for g, w, rtol in zip(got, want, (1e-5, 1e-5, 1e-4)):
        np.testing.assert_allclose(g, w, rtol=rtol)
    best = [int(np.flatnonzero(x[2] <= x[2].min())[-1]) for x in (got, want)]
    assert best[0] == best[1]


@pytest.mark.parametrize("method,backend,quantized", [
    (FAST, "fast4", True), (FAST, "fast4", False), (FAST, "lut", True),
    (FAST, "lut_gather", True), (FAST, "auto", True),
    (FAST3, "auto", True), (FAST3, "lut_gather", True),
    (FAST_LOW, "fast4", True), (FAST_LOW, "fast4", False),
    (FAST_LOW, "lut_gather", True),
])
def test_fast_search_matches_jax(fast_pairs, fast_data, method, backend,
                                 quantized):
    """On the CPU JAX runs fast4 in interpret mode and serves "lut" and
    "auto" by the gather scan; the port takes the same routes. Quantized:
    K4 picks the winners on the u8 sums, distances are sums of the
    dequantized tables (FAST3: only its ≤ 4-bit subspaces)."""
    _, queries = fast_data
    jidx, tq, tp = fast_pairs[method]
    if not quantized:  # the same JAX state without its quantizers
        arrays, meta = jax_state(jidx)
        del arrays["lut_offsets"], arrays["lut_scales"]
        jidx = _jax_index(arrays, meta)
    tidx = tq if quantized else tp
    d_j, i_j = jidx.search(queries, 5, backend=backend)
    d_t, i_t = tidx.search(queries, 5, backend=backend, query_batch=5)
    assert (i_t >= 0).all() and np.isfinite(d_t).all()
    assert_topk_match(d_t, i_t, d_j, i_j, rtol=1e-5)


def _jax_index(arrays, meta):
    """A vaq_tpu index holding a numpy state (its own npz loader)."""
    buf = io.BytesIO()
    port_io.save_index_npz(buf, arrays, meta)
    buf.seek(0)
    return vaq_tpu.VAQIndex.load(buf)


def test_fast4_on_wide_index_raises(fast_pairs, fast_data):
    """fast4 keeps the reference's ≤ 4-bit constraint (VAQ.cpp:1263-1266):
    the FAST3 config allocates 8-bit subspaces."""
    _, tidx, _ = fast_pairs[FAST3]
    assert int(tidx.bits.max()) > 4
    with pytest.raises(ConfigError, match="max_bits <= 4"):
        tidx.search(fast_data[1], 5, backend="fast4")


@pytest.mark.parametrize("backend", ["fast4", "lut_gather", "auto"])
def test_lut_paths_drop_tombstones_like_jax(fast_pairs, fast_data, backend):
    """The LUT paths over-fetch k + #deleted and compact on the host with a
    stable argsort, as JAX's search() does (vaq.py:666-676, 807-818)."""
    _, queries = fast_data
    jidx = _jax_index(*jax_state(fast_pairs[FAST][0]))
    _, i0 = jidx.search(queries, 5, backend=backend)
    dead = np.unique(i0[:, :2])
    jidx.delete(dead)
    d_j, i_j = jidx.search(queries, 5, backend=backend)
    tdel = index_from_numpy(*jax_state(jidx), "cpu")
    d_t, i_t = tdel.search(queries, 5, backend=backend)
    assert not np.isin(i_t, dead).any()
    assert_topk_match(d_t, i_t, d_j, i_j, rtol=1e-5)


# _lut_route against the table of JAX's rule (vaq_tpu/vaq.py:626-800); the
# arguments are (backend, methods, max_bits, n_rows, k, codes_br, quantized,
# has_ivf), the results (on the card, on the CPU).
_SM = vaq_tpu_torch.SearchMethod
ROUTES = [
    (("auto", _SM.TI, 8, 10**6, 100, 128, False, True), ("ivf", "ivf")),
    (("auto", _SM.TI | _SM.FAST, 4, 10**6, 100, 128, True, True),
     ("ivf", "ivf")),
    (("auto", _SM.TI, 8, 10**6, 100, 128, False, False),
     ("decoded", "decoded")),
    (("auto", _SM.FAST, 4, 10**6, 100, 128, True, False),
     ("lut_codes", "lut_gather")),
    (("auto", _SM.FAST3, 8, 10**6, 100, 128, True, False),
     ("lut_codes", "lut_gather")),
    (("auto", _SM.FAST, 4, 10**6, 100, 128, False, False),
     ("decoded", "decoded")),
    (("auto", _SM.HEAP, 8, 10**6, 100, 128, False, False),
     ("decoded", "decoded")),
    (("lut", _SM.HEAP, 8, 10**6, 100, 128, False, False),
     ("lut_codes", "lut_gather")),
    (("lut", _SM.HEAP, 8, 8000, 20, None, False, False),
     ("fast4", "lut_gather")),          # no 16-row windows, but n ≥ 64·k
    (("lut", _SM.HEAP, 8, 1000, 20, None, False, False),
     ("lut_gather", "lut_gather")),     # n < 64·k
    (("lut", _SM.HEAP, 9, 10**6, 100, 128, False, False),
     ("lut_gather", "lut_gather")),     # codes wider than u8
    (("fast4", _SM.FAST, 4, 10**6, 100, 128, True, False),
     ("fast4", "fast4")),
    (("fast4", _SM.HEAP, 3, 1000, 100, None, False, False),
     ("fast4", "fast4")),               # forced, whatever the windows
    (("fast4", _SM.FAST3, 8, 10**6, 100, 128, True, False),
     (ConfigError, ConfigError)),
    (("lut_gather", _SM.FAST, 4, 10**6, 100, 128, True, False),
     ("lut_gather", "lut_gather")),
    (("codes", _SM.FAST, 4, 10**6, 100, 128, True, False),
     ("codes", "codes")),
    (("decoded8", _SM.HEAP, 8, 10**6, 100, 128, False, False),
     ("decoded8", "decoded8")),
    (("ivf", _SM.HEAP, 8, 10**6, 100, 128, False, True), ("ivf", "ivf")),
    (("bogus", _SM.HEAP, 8, 10**6, 100, 128, False, False),
     (ConfigError, ConfigError)),
]


@pytest.mark.parametrize("on_cuda", [True, False])
@pytest.mark.parametrize("args,want", ROUTES)
def test_lut_route_follows_the_jax_rule(args, want, on_cuda):
    from vaq_tpu_torch.vaq import _lut_route
    backend, methods, max_bits, n_rows, k, br, quantized, has_ivf = args
    expect = want[0] if on_cuda else want[1]
    call = lambda: _lut_route(backend, methods, max_bits, n_rows, k, br,  # noqa: E731
                              quantized, on_cuda, has_ivf)
    if expect is ConfigError:
        with pytest.raises(ConfigError):
            call()
    else:
        assert call() == expect


def test_fast4_block_rows_is_the_jax_rule():
    from vaq_tpu_torch.vaq import _fast4_block_rows
    for n, k, want in ((10**6, 100, 256), (10**6, 10, 512), (4000, 5, 256),
                       (5 * 10**6, 100, 512), (3 * 10**6, 100, 256)):
        br = max(256, min(512, n // (64 * k)))
        assert _fast4_block_rows(n, k) == 1 << (br.bit_length() - 1) == want
