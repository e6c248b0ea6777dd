"""Port parity of the 100M streamed path against vaq_tpu on the CPU:
``data.DeviceChunkSource``, the chunked exact searches of
``ops/distances.py``, ``ivf.build_ivf_streamed`` and the DEEP-100M script
``scripts/capacity_100m_torch.py``.

The chunk source's host parameters must equal JAX's bit for bit; its rows
come from torch's generator, so they are held to the mixture model and to
their own contract (one chunk, one function of (seed, i)). The chunked
searches get the same numpy chunks as JAX's: on seeded floats distances
agree to rtol 1e-5 (matmuls summed in another order) and ids up to ties at
the k-th distance (``assert_topk_match``); on small integers every distance
is exact in f32 and the ids must be JAX's exactly. The streamed build runs
on one converted JAX index: k-means from the same numpy draw lands its
centroids within 1e-4, and given JAX's centroids the capacity, slot table,
live sizes and int8 rows are JAX's exactly (JAX's d = 96 rows swapped from
its transposed layout).
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vaq_tpu
from test_torch_ivf import jax_probe, port_probe, term_atol
from test_torch_scan_decoded import assert_topk_match
from test_torch_ties import assert_tied, decoded_inputs, decoded_tier
from test_torch_ties import small_ints
from test_torch_vaq import _jax_index, jax_state
from vaq_tpu import data as jdata
from vaq_tpu import ivf as jivf
from vaq_tpu.ops import distances as jdist
from vaq_tpu_torch import data, ivf, kmeans
from vaq_tpu_torch.convert import index_from_numpy
from vaq_tpu_torch.ops import distances, probe_scan, scan_decoded

torch.set_num_threads(2)  # six test workers share the host

ROOT = Path(__file__).resolve().parent.parent


# --- DeviceChunkSource ---------------------------------------------------------

def chunk_source(n=2500, d=16, chunk_rows=1000, seed=7):
    return data.DeviceChunkSource(n, d, chunk_rows, seed=seed, device="cpu")


def test_chunks_are_pure_and_cover_n():
    """Chunk i is a function of (seed, i): read twice, or from another
    source of the same seed, it is the same; the chunks cover n with a
    short last chunk, differ from each other and from another seed's; an
    index outside [0, n_chunks) raises."""
    src = chunk_source()
    chunks = list(src.chunks())
    assert src.n_chunks == 3
    assert [tuple(c.shape) for c in chunks] == [(1000, 16), (1000, 16),
                                                (500, 16)]
    assert all(c.dtype == torch.float32 for c in chunks)
    for i, c in enumerate(chunks):
        assert torch.equal(src.chunk(i), c)
        assert torch.equal(chunk_source().chunk(i), c)
    assert not torch.equal(chunks[0], chunks[1])
    assert not torch.equal(chunks[2], chunks[0][:500])
    assert not torch.equal(chunk_source(seed=8).chunk(0), chunks[0])
    for bad in (-1, 3):
        with pytest.raises(IndexError):
            src.chunk(bad)


@pytest.mark.parametrize("n,d,seed", [(2500, 16, 7), (100_000_000, 96, 42)])
def test_host_parameters_equal_jax(n, d, seed):
    """scales, mix and centers come from the same numpy draws as JAX's
    (vaq_tpu/data.py:90-106), bit for bit; so do the chunk geometry."""
    j = jdata.DeviceChunkSource(n, d, 2_000_000, seed=seed)
    t = data.DeviceChunkSource(n, d, 2_000_000, seed=seed, device="cpu")
    for name in ("centers", "scales", "mix"):
        want = np.asarray(getattr(j, f"_{name}"))
        got = getattr(t, name)
        assert got.dtype == want.dtype == np.float32, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert (t.n_chunks, t.chunk_rows) == (j.n_chunks, j.chunk_rows)


def test_rows_follow_the_mixture():
    """Rows are (center + noise · scales) · mix: undone by mix⁻¹, each row
    sits by one of the centers with per-dimension spread ``scales``."""
    src = chunk_source(n=6000, d=16, chunk_rows=3000)
    x = torch.cat(list(src.chunks())).double().numpy()
    y = x @ np.linalg.inv(src.mix.astype(np.float64))
    near = ((y[:, None, :] - src.centers[None]) ** 2).sum(2).argmin(1)
    spread = (y - src.centers[near]).std(axis=0)
    np.testing.assert_allclose(spread, src.scales, rtol=0.1)
    assert np.unique(near).size == src.centers.shape[0]


def test_queries_and_host_sample():
    """queries: host f32, perturbed rows of chunk 0, the same on every
    call; host_sample: the rows at JAX's numpy draw of ids, as host f32,
    all rows when asked for more."""
    src = chunk_source()
    q = src.queries(40)
    assert q.shape == (40, 16) and q.dtype == np.float32
    np.testing.assert_array_equal(q, src.queries(40))
    c0 = src.chunk(0).numpy()
    nearest = ((q[:, None, :] - c0[None]) ** 2).sum(2).min(1)
    assert 0 < nearest.min() and nearest.max() < 0.25
    x = src.host_sample(300, seed=3)
    assert x.shape == (300, 16) and x.dtype == np.float32
    take = np.sort(np.random.default_rng(7 + 3).choice(2500, 300,
                                                       replace=False))
    np.testing.assert_array_equal(x, torch.cat(list(src.chunks())).numpy()[
        take])
    assert src.host_sample(10_000).shape == (2500, 16)


# --- the chunked exact searches -----------------------------------------------

N_CH, CHUNK = 2900, 700          # four full chunks and a short one of 200


def search_inputs(kind, nq=12, d=24, seed=3):
    """(base, queries): seeded floats, or small integers drawn from 40
    distinct rows so that exact distance ties abound."""
    rng = np.random.default_rng(seed)
    if kind == "floats":
        return (rng.standard_normal((N_CH, d)).astype(np.float32),
                rng.standard_normal((nq, d)).astype(np.float32))
    pool = small_ints((40, d), seed, -2, 3)
    return (pool[rng.integers(0, 40, N_CH)],
            small_ints((nq, d), seed + 1, -2, 3))


def chunk_fn(base, as_tensor=False):
    def fn(i):
        c = base[i * CHUNK:(i + 1) * CHUNK]
        return torch.as_tensor(c) if as_tensor else c
    return fn


def assert_same(kind, d_t, i_t, d_j, i_j):
    if kind == "ties":
        np.testing.assert_array_equal(i_t, np.asarray(i_j))
        np.testing.assert_array_equal(d_t, np.asarray(d_j))
        if d_t.shape[1] > 1:
            assert_tied(d_j)
    else:
        assert_topk_match(d_t, i_t, d_j, i_j, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("k", [1, 10, 250])
@pytest.mark.parametrize("kind", ["floats", "ties"])
def test_exact_search_chunked_matches_jax(kind, k, as_tensor):
    """The same chunks, host arrays or tensors, through both packages; at
    k = 250 the short last chunk contributes all its 200 rows."""
    base, q = search_inputs(kind)
    d_j, i_j = jdist.exact_search_chunked(q, chunk_fn(base), N_CH, CHUNK, k)
    d_t, i_t = distances.exact_search_chunked(
        q, chunk_fn(base, as_tensor), N_CH, CHUNK, k, device="cpu")
    assert d_t.shape == i_t.shape == (q.shape[0], k)
    assert d_t.dtype == np.float32 and i_t.dtype == np.int32
    assert_same(kind, d_t, i_t, d_j, i_j)


@pytest.mark.parametrize("kind", ["floats", "ties"])
def test_exact_search_host_stream_matches_jax(kind):
    base, q = search_inputs(kind, seed=5)
    d_j, i_j = jdist.exact_search_host_stream(q, base, 20, chunk_rows=1000)
    d_t, i_t = distances.exact_search_host_stream(q, base, 20,
                                                  chunk_rows=1000,
                                                  device="cpu")
    assert_same(kind, d_t, i_t, d_j, i_j)


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("kind", ["floats", "ties"])
def test_exact_rescore_chunked_matches_jax(kind, as_tensor):
    """Candidates with −1, ids ≥ n and a duplicate: ids that land in no
    chunk keep +inf and sort last in candidate order; the duplicate ties
    exactly and keeps its order."""
    base, q = search_inputs(kind, seed=7)
    rng = np.random.default_rng(9)
    cand = rng.integers(0, N_CH, (q.shape[0], 50)).astype(np.int32)
    cand[:, 5], cand[:, 7], cand[:, 9] = -1, N_CH, N_CH + 1000
    cand[:, 12] = cand[:, 11]
    c_in = torch.as_tensor(cand) if as_tensor else cand
    for k in (10, 50):
        d_j, i_j = jdist.exact_rescore_chunked(q, cand, chunk_fn(base), N_CH,
                                               CHUNK, k)
        d_t, i_t = distances.exact_rescore_chunked(
            q, c_in, chunk_fn(base, as_tensor), N_CH, CHUNK, k, device="cpu")
        assert d_t.shape == i_t.shape == (q.shape[0], k)
        assert_same(kind, d_t, i_t, d_j, i_j)
    assert np.isinf(d_t[:, -3:]).all()
    np.testing.assert_array_equal(i_t[:, -3:],
                                  np.tile([-1, N_CH, N_CH + 1000],
                                          (q.shape[0], 1)))


# --- the fold of lowest_over_blocks -----------------------------------------

def count_folds(monkeypatch):
    calls = []
    real = distances._lowest_by_key

    def spy(vals, ids, k):
        calls.append(len(vals))
        return real(vals, ids, k)

    monkeypatch.setattr(distances, "_lowest_by_key", spy)
    return calls


@pytest.mark.parametrize("slack", [8, 1])
@pytest.mark.parametrize("tier", ["decoded", "decoded8"])
def test_folded_decoded_scan_keeps_jax_ties(monkeypatch, tier, slack):
    """The decoded tiers over six 16-row blocks with the kept entries
    folded after every block: JAX's ids and distances exactly, ties
    included."""
    monkeypatch.setattr(scan_decoded, "BLOCK_ROWS", 16)
    monkeypatch.setattr(distances, "TIE_SLACK", slack)
    monkeypatch.setattr(distances, "FOLD_WIDTH", 20)
    calls = count_folds(monkeypatch)
    rows, norms, qp = decoded_inputs()
    (d_j, i_j), (d_t, i_t) = decoded_tier(tier, rows, norms, qp, 12)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    assert_tied(d_j)
    assert len(calls) >= 6


@pytest.mark.parametrize("k", [5, 40])
def test_folded_exact_search_keeps_jax_ties(monkeypatch, k):
    monkeypatch.setattr(distances, "BLOCK_ROWS", 16)
    monkeypatch.setattr(distances, "FOLD_WIDTH", k + 1)
    calls = count_folds(monkeypatch)
    rows, _, qp = decoded_inputs(seed=12)
    d_j, i_j = jdist.exact_search(jnp.asarray(qp), jnp.asarray(rows), k,
                                  block_rows=16)
    d_t, i_t = distances.exact_search(torch.as_tensor(qp),
                                      torch.as_tensor(rows), k)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    assert len(calls) >= 6


# --- build_ivf_streamed ---------------------------------------------------------

N_IVF, IVF_CHUNK, IVF_SAMPLE = 6500, 1000, 3000   # 7 chunks, the last 500


@pytest.fixture(scope="module", params=[128, 96], ids=["d128", "d96"])
def stream_pair(request):
    """(queries, a JAX index at N_IVF rows, its streamed probe state): d =
    128 with 32 clusters over 16 subspaces, d = 96 with 16 over 8 (JAX
    stores those buckets transposed)."""
    d = request.param
    if d == 128:
        base, queries, _ = jdata.make_sift_like(n=N_IVF, n_queries=32, d=128,
                                                seed=11)
        method, over = "VAQ128m16min7max8var1,TI32m16", {}
    else:
        rng = np.random.default_rng(5)
        base = (rng.standard_normal((N_IVF, 96)) *
                np.linspace(3.0, 0.3, 96)[None, :]).astype(np.float32)
        queries = base[:32] + 0.05 * rng.standard_normal((32, 96)).astype(
            np.float32)
        method = "VAQ192m24min7max8var1,TI16m24"
        over = {"ti_segment_num": 8}
    jidx = vaq_tpu.VAQIndex(vaq_tpu.parse_method_string(method))
    jidx.train(base).encode(base)
    jst = jivf.build_ivf_streamed(jidx, chunk_rows=IVF_CHUNK,
                                  sample_n=IVF_SAMPLE, **over)
    assert jst.transposed == (d == 96)
    return queries, jidx, jst, over


def jax_rows(jst):
    rows = np.asarray(jst.bucket_rows)
    return rows.swapaxes(1, 2) if jst.transposed else rows


def port_build(jidx, over, deleted=None, jax_cents=None, monkeypatch=None,
               **kw):
    """The port's streamed build on the converted index (with
    ``deleted_ids`` set), k-means replaced by ``jax_cents`` when given."""
    arrays, meta = jax_state(jidx)
    if deleted is not None:
        arrays["deleted_ids"] = np.asarray(deleted)
    tidx = index_from_numpy(arrays, meta, "cpu")
    if jax_cents is not None:
        samples = []

        def lloyd(x, c0, iters=25):
            samples.append(tuple(x.shape))
            return torch.tensor(np.asarray(jax_cents))

        monkeypatch.setattr(kmeans, "lloyd", lloyd)
    st = ivf.build_ivf_streamed(tidx, chunk_rows=IVF_CHUNK,
                                sample_n=IVF_SAMPLE, **over, **kw)
    if jax_cents is not None:
        # the first 428 rows of each chunk (the last has 500)
        assert samples == [(7 * (IVF_SAMPLE // 7), st.seg_dims)]
    return tidx, st, st.build_stats


def assert_states_equal(st, jst):
    assert (st.cap, st.seg_dims, st.ncl, st.d_full) == \
        (jst.cap, jst.seg_dims, jst.ncl, jst.d_full)
    assert st.bucket_rows.dtype == torch.int8
    np.testing.assert_array_equal(st.bucket_ids.numpy(),
                                  np.asarray(jst.bucket_ids))
    np.testing.assert_array_equal(st.sizes.numpy(), np.asarray(jst.sizes))
    np.testing.assert_array_equal(st.bucket_rows.numpy(), jax_rows(jst))
    np.testing.assert_array_equal(st.dim_scales.numpy(),
                                  np.asarray(jst.dim_scales))
    np.testing.assert_array_equal(st.centroids, np.asarray(jst.centroids))


def test_streamed_build_centroids_match_jax(stream_pair):
    """k-means from the same numpy init on the same sampled prefix: the
    centroids within 1e-4 (Lloyd's sums in another order), the bucket
    geometry and the scales exactly, every row once."""
    _, jidx, jst, over = stream_pair
    _, st, stats = port_build(jidx, over)
    np.testing.assert_allclose(st.centroids, jst.centroids, rtol=1e-4,
                               atol=1e-4)
    assert (st.cap, st.seg_dims, st.d_full) == (jst.cap, jst.seg_dims,
                                                jst.d_full)
    np.testing.assert_array_equal(st.dim_scales.numpy(),
                                  np.asarray(jst.dim_scales))
    ids = st.bucket_ids.numpy()
    assert np.array_equal(np.sort(ids[ids >= 0]), np.arange(N_IVF))
    assert stats["cap"] == st.cap and stats["spilled"] >= 0
    assert stats["sizes_max"] <= st.cap


def test_streamed_build_given_jax_centroids_is_jax_state(stream_pair,
                                                         monkeypatch):
    """Given JAX's centroids: the capacity, slot table, live sizes and
    int8 rows (poison in every dead slot) are JAX's exactly."""
    _, jidx, jst, over = stream_pair
    _, st, _ = port_build(jidx, over, jax_cents=jst.centroids,
                          monkeypatch=monkeypatch)
    assert_states_equal(st, jst)
    dead = st.bucket_rows.numpy()[st.bucket_ids.numpy() < 0]
    assert (dead == probe_scan.poison_pattern(st.d_full)).all()


def test_streamed_build_tombstones_match_jax(stream_pair, monkeypatch):
    """Rows deleted before the build: dead slots with poison rows, left out
    of the live sizes, as JAX's build leaves them (ivf.py:467-478 and
    :497-498); ids outside [0, n) name no row and change nothing (ROADMAP
    fault 15: JAX would wrap −1 to the last row)."""
    _, jidx, jst, over = stream_pair
    dead = np.random.default_rng(2).choice(N_IVF, 40, replace=False)
    j = _jax_index(*jax_state(jidx))
    j.deleted_ids = np.unique(dead)
    jdel = jivf.build_ivf_streamed(j, chunk_rows=IVF_CHUNK,
                                   sample_n=IVF_SAMPLE, **over)
    _, st, _ = port_build(jidx, over, deleted=np.unique(dead),
                          jax_cents=jdel.centroids, monkeypatch=monkeypatch)
    assert_states_equal(st, jdel)
    ids = st.bucket_ids.numpy()
    assert not np.isin(ids, dead).any()
    assert int(st.sizes.sum()) == N_IVF - 40
    rows = st.bucket_rows.numpy()
    assert (rows[ids < 0] == probe_scan.poison_pattern(st.d_full)).all()
    _, st_out, _ = port_build(jidx, over, deleted=[-3, -1, N_IVF, N_IVF + 9],
                              jax_cents=jst.centroids,
                              monkeypatch=monkeypatch)
    assert_states_equal(st_out, jst)


def test_stage_cache_loads_in_either_package(stream_pair, tmp_path,
                                             monkeypatch):
    """A cache JAX wrote gives the port JAX's state (without codes); one
    the port wrote gives JAX the port's state."""
    _, jidx, jst, over = stream_pair
    j_path, t_path = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jivf.build_ivf_streamed(_jax_index(*jax_state(jidx)),
                            chunk_rows=IVF_CHUNK, sample_n=IVF_SAMPLE,
                            stage_cache=j_path, **over)
    arrays, meta = jax_state(jidx)
    del arrays["codes"]
    no_codes = index_from_numpy(arrays, meta, "cpu")
    assert no_codes.codes is None
    assert_states_equal(ivf.build_ivf_streamed(no_codes, stage_cache=j_path,
                                               **over), jst)
    tidx, st, _ = port_build(jidx, over, jax_cents=jst.centroids,
                             monkeypatch=monkeypatch, stage_cache=t_path,
                             free_codes_before_upload=True)
    assert tidx.codes is None
    j_loaded = jivf.build_ivf_streamed(_jax_index(*jax_state(jidx)),
                                       stage_cache=t_path, **over)
    assert_states_equal(st, j_loaded)


@pytest.mark.parametrize("visit", [0.25, 1.0])
def test_streamed_state_searches_like_jax(stream_pair, monkeypatch, visit):
    """IVFSearcher on JAX's streamed state and on the port's (built with
    JAX's centroids): the same ids up to ties, the same distances."""
    queries, jidx, jst, over = stream_pair
    tidx, st, _ = port_build(jidx, over, jax_cents=jst.centroids,
                             monkeypatch=monkeypatch)
    tidx.ivf = ivf.IVFSearcher(st, visit)
    d_j, i_j = jax_probe(jidx, queries, 10, visit, False, jst)
    d_t, i_t = port_probe(tidx, queries, 10, visit, False)
    assert (i_t >= 0).all()
    assert_topk_match(d_t, i_t, d_j, i_j, rtol=1e-5,
                      atol=term_atol(jidx, queries))


# --- the DEEP-100M script ---------------------------------------------------------

def load_capacity_script():
    spec = importlib.util.spec_from_file_location(
        "capacity_100m_torch", ROOT / "scripts" / "capacity_100m_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_capacity_script_runs_end_to_end_on_cpu():
    """run() at 20k × 96 on the CPU: every stage reports; refined recall
    500 ≥ 100 ≥ the int8 tier's; the probe at visit 1.0 within 0.03 of
    the int8 tier's recall and at 0.25 no above it; ``search("auto")``
    serves the bf16 tier, D1's CPU version picks the plain scan's
    candidates there, and the tier is released before the probe; the
    kernels' wrappers took their plain versions (no launch)."""
    out, idx, st, qp = load_capacity_script().run(
        n=20_000, d=96, queries=48, k=10, batch=32, chunk=3000,
        train_sample=4096, clusters=32, segments=16, visits=(1.0, 0.25),
        reps=1, device="cpu")
    s = out["stages"]
    for name in ("source", "train", "encode", "groundtruth", "codes",
                 "decoded_build", "auto", "d1", "decoded8_build", "decoded8", "refine100", "refine500",
                 "ivf_build", "ivf_visit1.0", "ivf_visit0.25"):
        assert s[name]["wall_s"] >= 0, name
    r8 = s["decoded8"]["recall_at_k"]
    assert s["refine500"]["recall_at_k"] >= s["refine100"]["recall_at_k"] \
        >= r8
    assert abs(s["ivf_visit1.0"]["recall_at_k"] - r8) <= 0.03
    assert s["ivf_visit0.25"]["recall_at_k"] <= \
        s["ivf_visit1.0"]["recall_at_k"] + 1e-9
    assert s["codes"]["recall_at_k"] > 0.3 and s["codes"]["qps"] > 0
    assert s["ivf_build"]["cap"] == 1024 and s["ivf_build"]["spilled"] >= 0
    assert s["auto"]["recall_at_k"] > 0.3 and s["auto"]["qps"] > 0
    assert s["decoded_build"]["resident_bytes"] == 20_000 * (96 * 2 + 4)
    assert s["d1"]["d1_check"] and s["d1"]["kk"] == 26
    assert s["d1"]["d1_detail"]["queries_differing"] == 0
    assert s["d1"]["rows_past_2_31_bytes"] == 0 and "d1_ms" not in s["d1"]
    assert idx.codes is not None and idx.decoded8 is not None
    assert idx.decoded is None and idx.decoded_norms is None
    assert st.cap == 1024 and tuple(qp.shape) == (48, 96)
    assert "decoded_topk_scan" in out["launches"]
    assert set(out["launches"].values()) == {0}
    assert out["resident_bytes"]["buckets"] == 32 * 1024 * (96 + 4)


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("fault", [None, "check", "no_row_past_2_31"])
def test_deep100m_d1_entry_holds_the_capacity_runs_d1_stage(fault):
    """chip_smoke's ``[deep100m]`` entry of D1, made from run()'s ``d1``
    stage: bound by the products of 1024 × 100M × 96 at the bf16 peak,
    the check's excess as its error; a failed check, or one that found no
    row past 2^31 bytes, fails the phase."""
    held = {"kk": 26, "d1_check": fault != "check",
            "d1_detail": {"queries_differing": 7, "same_order": False,
                          "max_excess_over_tol": 0.0148},
            "rows_past_2_31_bytes": 0 if fault == "no_row_past_2_31" else 9,
            "d1_ms": 85.0, "plain_ms": 2625.0}
    smoke = load_chip_smoke()
    if fault:
        with pytest.raises(AssertionError):
            smoke._deep100m_d1_entry(held, 100_000_000, 1024)
        return
    entry = smoke._deep100m_d1_entry(held, 100_000_000, 1024)
    assert entry["name"] == "decoded_topk_scan_100m"
    assert entry["bound_by"] == "operations"
    assert entry["bound_ms"] == pytest.approx(2 * 1024 * 1e8 * 96 / 989e12 * 1e3)
    assert entry["max_abs_err"] == 0.0148 and entry["queries_differing"] == 7
    assert (entry["ms"], entry["plain_ms"], entry["library_ms"]) == \
        (85.0, 2625.0, None)
    assert smoke._counter_of(entry["name"]) == "decoded_topk_scan"
