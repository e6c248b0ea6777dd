"""The port's spans and counters (``vaq_tpu_torch/profiling.py``) on the
CPU: ``span`` makes a ``record_function`` range only while a profiler
records, each search route marks its stages with spans nested as the
package documents them, the probe's entry counters equal a recount of its
dispatch, and no route's answers change with the profiler on.
"""

import numpy as np
import pytest
import torch

import vaq_tpu_torch
from vaq_tpu_torch import data, ivf, profiling
from vaq_tpu_torch.ops import probe as probe_ops

torch.set_num_threads(2)  # six test workers share the host

PREFIXES = ("index.", "decoded.", "codes.", "ivf.", "fast.")
K = 4
NQ, QUERY_BATCH = 40, 16
# each route's spans other than index.search, by their parent
ROUTES = {
    "decoded": {"index.prepare": "index.search",
                "index.upload": "index.search",
                "decoded.scan": "index.search",
                "decoded.scores": "decoded.scan",
                "index.copy_back": "index.search"},
    "codes": {"index.prepare": "index.search",
              "index.upload": "index.search",
              "codes.scan": "index.search", "codes.select": "index.search",
              "codes.rescore": "index.search",
              "index.copy_back": "index.search"},
    "ivf": {"index.prepare": "index.search", "index.upload": "index.search",
            "ivf.params": "index.search", "ivf.probe": "index.search",
            "ivf.groupmin": "index.search", "ivf.merge": "index.search",
            "ivf.rescore": "index.search",
            "ivf.second_stage": "index.search",
            "index.copy_back": "index.search"},
    "fast4": {"index.prepare": "index.search",
              "index.upload": "index.search", "fast.lut": "index.search",
              "fast.scan": "index.search", "fast.select": "index.search",
              "fast.rescore": "index.search", "fast.topk": "index.search",
              "index.copy_back": "index.search"},
}
METHODS = {"decoded": "VAQ48m8min4max8var1,HEAP",
           "codes": "VAQ48m8min4max8var1,HEAP",
           "ivf": "VAQ48m8min4max8var1,TI16m4",
           "fast4": "VAQ32m8min1max4var1,FAST"}


@pytest.fixture(scope="module")
def rows():
    """4096 × 32 base rows (1024·k of them, so that the codes tier takes
    16-row windows) and 40 queries."""
    return data.make_anisotropic_gaussian(4096, 32, NQ, 0)


@pytest.fixture(scope="module")
def indexes(rows):
    """One CPU index a method, the TI one with its probe state."""
    base, _ = rows
    out = {}
    for method in set(METHODS.values()):
        idx = vaq_tpu_torch.VAQIndex(
            vaq_tpu_torch.parse_method_string(method), device="cpu")
        idx.train(base).encode(base)
        if ",TI" in method:
            vaq_tpu_torch.attach_ivf(idx)
        out[method] = idx
    return out


def search(indexes, rows, route):
    idx = indexes[METHODS[route]]
    backend = "auto" if route == "ivf" else route
    return idx.search(rows[1], K, query_batch=QUERY_BATCH, backend=backend)


def program_spans(prof):
    """(name, parent's name) of the profile's program spans, in order."""
    return [(e.name, e.cpu_parent.name if e.cpu_parent else None)
            for e in prof.events() if e.name.startswith(PREFIXES)]


def test_span_is_a_range_only_while_recording(monkeypatch):
    assert not profiling.recording()
    with torch.profiler.profile() as prof:
        assert profiling.recording()
        with profiling.span("index.test"):
            torch.ones(3).sum()
    assert not profiling.recording()
    assert [e.name for e in prof.events()].count("index.test") == 1

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(profiling, "record_function", refuse)
    first = profiling.span("index.a")
    with first:
        with profiling.span("index.b"):
            pass
    assert profiling.span("index.c") is first


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_route_spans_nest(indexes, rows, route):
    if route == "codes":
        # windows form, so the codes tier runs and not its decoded fallback
        assert indexes[METHODS[route]]._codes_block_rows(K) == 16
    with torch.profiler.profile() as prof:
        search(indexes, rows, route)
    spans = program_spans(prof)
    batches = -(-NQ // QUERY_BATCH)
    names = [n for n, _ in spans]
    assert names.count("index.search") == 1
    assert dict(spans)["index.search"] not in ROUTES[route]
    assert names.count("index.prepare") == 1
    assert names.count("index.upload") == batches
    assert names.count("index.copy_back") == batches
    want = ROUTES[route]
    assert {n for n in names if n != "index.search"} == set(want)
    for name, parent in spans:
        if name != "index.search":
            assert parent == want[name], (name, parent)
    if route == "codes":
        assert names.count("codes.scan") == batches
        assert names.count("codes.select") == 2 * batches


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_answers_equal_with_profiler_on_and_off(indexes, rows, route,
                                                monkeypatch):
    """Bit-equal answers; with the profiler off no range is made at all."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    with monkeypatch.context() as m:
        m.setattr(profiling, "record_function", refuse)
        d_off, i_off = search(indexes, rows, route)
    with torch.profiler.profile():
        d_on, i_on = search(indexes, rows, route)
    np.testing.assert_array_equal(i_on, i_off)
    np.testing.assert_array_equal(d_on.view(np.int32), d_off.view(np.int32))


def recount(qp, st, k, p_visit, p_max, qcap):
    """(active entries, entries ranked at or past qcap in their cluster),
    ranked here by query id within each cluster."""
    cd = probe_ops.cluster_sq_dists(qp[:, :st.centroids.shape[1]],
                                    torch.as_tensor(st.centroids))
    probe, active = probe_ops.dynamic_probe(cd, st.sizes, k, p_visit, p_max)
    probe, active = probe.numpy(), active.numpy()
    seen = {}
    dropped = 0
    for q in range(probe.shape[0]):
        for c in probe[q][active[q]]:
            dropped += seen.get(c, 0) >= qcap
            seen[c] = seen.get(c, 0) + 1
    return int(active.sum()), dropped


@pytest.mark.parametrize("qcap", [2, NQ])
def test_probe_counters_equal_a_recount(indexes, rows, qcap):
    idx = indexes[METHODS["ivf"]]
    st = idx.ivf.state
    qp = vaq_tpu_torch.pca.project(torch.as_tensor(rows[1]),
                                   idx._eigvecs_device())
    p_visit, p_max, _, gs = idx.ivf.params(K, NQ)

    def probe():
        return ivf.probe_scan(qp, torch.as_tensor(st.centroids),
                              st.bucket_rows, st.bucket_ids, st.sizes, K,
                              p_visit, p_max, qcap, gs,
                              dim_scales=st.dim_scales)

    profiling.reset_counters()
    try:
        probe()
        assert profiling.counters() == {}
        with torch.profiler.profile():
            probe()
            probe()
        entries, dropped = recount(qp, st, K, p_visit, p_max, qcap)
        assert (dropped > 0) == (qcap < NQ)
        assert profiling.counters() == {"ivf.entries": 2 * entries,
                                        "ivf.entries_dropped": 2 * dropped}
    finally:
        profiling.reset_counters()


def test_count_adds_only_while_recording():
    profiling.reset_counters()
    try:
        profiling.count("x", torch.tensor(5))
        assert profiling.counters() == {}
        with torch.profiler.profile():
            profiling.count("x", torch.tensor(3))
            profiling.count("x", torch.tensor([True, False, True]).sum())
            profiling.count("y", torch.tensor(2))
        profiling.count("x", torch.tensor(100))
        assert profiling.counters() == {"x": 5, "y": 2}
    finally:
        profiling.reset_counters()
    assert profiling.counters() == {}
