"""The port's continuous-batching server (vaq_tpu_torch/serving.py) against
JAX's (vaq_tpu/serving.py), case for case with tests/test_serving.py, on the
CPU: JAX's server over a JAX index, the port's over the same state converted
(``index_from_numpy``), so both answer the same queries from one index. The
served answers must equal each package's own ``search`` and each other's:
ids exactly, distances to 1e-5 relative (one f32 GEMM in another order).
"""

import numpy as np
import pytest
import torch

import vaq_tpu
from test_torch_vaq import jax_state
from vaq_tpu import metrics
from vaq_tpu.serving import SearchServer as JaxServer
from vaq_tpu_torch.convert import index_from_numpy
from vaq_tpu_torch.profiling import LatencyStats, PhaseTimer, device_trace
from vaq_tpu_torch.serving import SearchServer

torch.set_num_threads(2)  # six test workers share the host


@pytest.fixture(scope="module")
def server_setup(sift_like):
    """(JAX index, port index on its state, queries, gt) — the fixture of
    tests/test_serving.py:14-19."""
    base, queries, gt = sift_like
    cfg = vaq_tpu.parse_method_string("VAQ128m16min7max8var1,SORT")
    jidx = vaq_tpu.VAQIndex(cfg).train(base).encode(base)
    return jidx, index_from_numpy(*jax_state(jidx), "cpu"), queries, gt


def served_like_jax(jidx, queries, k, **kw):
    """JAX's server's answers to ``queries``, one submit each."""
    srv = JaxServer(jidx, k=k, **kw)
    try:
        res = [srv.submit(q).result(60) for q in queries]
    finally:
        srv.close()
    return (np.concatenate([d for d, _ in res]),
            np.concatenate([i for _, i in res]))


def test_single_query_roundtrip(server_setup):
    jidx, idx, queries, _ = server_setup
    srv = SearchServer(idx, k=10, max_batch=32, max_wait_ms=1.0)
    try:
        d, i = srv.search(queries[0])
        assert d.shape == (1, 10) and i.shape == (1, 10)
        assert d.dtype == np.float32 and i.dtype == np.int32
        ref_d, ref_i = idx.search(queries[:1], 10)
        np.testing.assert_array_equal(i, ref_i)
        np.testing.assert_allclose(d, ref_d, rtol=1e-6)
    finally:
        srv.close()
    jd, ji = served_like_jax(jidx, queries[:1], 10, max_batch=32,
                             max_wait_ms=1.0)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(d, jd, rtol=1e-5)


def test_concurrent_clients_batched(server_setup):
    jidx, idx, queries, gt = server_setup
    srv = SearchServer(idx, k=10, max_batch=16, max_wait_ms=20.0)
    try:
        futs = [srv.submit(queries[j]) for j in range(48)]
        results = [f.result(60) for f in futs]
        labels = np.concatenate([i for _, i in results], axis=0)
        dists = np.concatenate([d for d, _ in results], axis=0)
        rec = metrics.avg_recall(labels, gt[:48], 10)
        ref_rec = metrics.avg_recall(idx.search(queries[:48], 10)[1],
                                     gt[:48], 10)
        assert abs(rec - ref_rec) < 1e-6
        # coalescing actually happened (48 queries in ≤ ~6 batches, not 48)
        assert srv.batches_served <= 12, srv.batches_served
        assert srv.queries_served == srv.sum_fill == 48
        assert srv.sum_fetch_s >= 0.0
    finally:
        srv.close()
    jd, ji = served_like_jax(jidx, queries[:48], 10, max_batch=16,
                             max_wait_ms=20.0)
    np.testing.assert_array_equal(labels, ji)
    np.testing.assert_allclose(dists, jd, rtol=1e-5)


def test_group_submit(server_setup):
    _, idx, queries, _ = server_setup
    srv = SearchServer(idx, k=5, max_batch=64)
    try:
        d, i = srv.search(queries[:7])
        assert i.shape == (7, 5)
        np.testing.assert_array_equal(i, idx.search(queries[:7], 5)[1])
    finally:
        srv.close()


def test_close_idempotent(server_setup):
    _, idx, queries, _ = server_setup
    srv = SearchServer(idx, k=5)
    srv.search(queries[0])
    srv.close()
    # after close, thread is gone
    assert not srv._thread.is_alive()


def test_latency_stats_collected(server_setup):
    _, idx, queries, _ = server_setup
    srv = SearchServer(idx, k=5, max_batch=16, max_wait_ms=5.0)
    try:
        futs = [srv.submit(queries[j]) for j in range(20)]
        [f.result(60) for f in futs]
        s = srv.stats.summary()
        assert s["queries"] == 20
        assert s["qps"] > 0
        assert s["p50_ms"] > 0
    finally:
        srv.close()


def test_phase_timer():
    t = PhaseTimer(sync=False)
    with t.phase("a"):
        pass
    with t.phase("a"):
        pass
    assert t.counts["a"] == 2
    assert "a" in t.report()


def test_latency_stats_and_trace_match_jax(tmp_path):
    """LatencyStats is JAX's, summary for summary; device_trace writes a
    torch.profiler trace into log_dir."""
    from vaq_tpu.profiling import LatencyStats as JaxStats
    got, want = LatencyStats(), JaxStats()
    for s in (0.003, 0.001, 0.002, 0.010):
        got.record(s, 2)
        want.record(s, 2)
    a, b = got.summary(), want.summary()
    assert {k: v for k, v in a.items() if k != "qps"} == \
        {k: v for k, v in b.items() if k != "qps"}
    got.reset()
    assert got.summary() == {}
    with device_trace(str(tmp_path / "trace")) as prof:
        torch.ones(8).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert prof.key_averages()


def test_oversized_group_rejected(server_setup):
    _, idx, queries, _ = server_setup
    srv = SearchServer(idx, k=5, max_batch=8)
    try:
        fut = srv.submit(queries[:20])
        with pytest.raises(ValueError):
            fut.result(10)
    finally:
        srv.close()


def test_batch_overflow_carries_over(server_setup):
    _, idx, queries, _ = server_setup
    srv = SearchServer(idx, k=5, max_batch=10, max_wait_ms=30.0)
    try:
        # 3 groups of 6: no two fit in one 10-batch; all must still be served
        futs = [srv.submit(queries[i * 6:(i + 1) * 6]) for i in range(3)]
        res = [f.result(60) for f in futs]
        for d, i in res:
            assert i.shape == (6, 5)
        assert srv.queries_served == 18
        np.testing.assert_array_equal(
            np.concatenate([i for _, i in res]),
            idx.search(queries[:18], 5)[1])
    finally:
        srv.close()


def test_failed_dispatch_fails_its_futures(server_setup):
    """A batch whose search raises resolves its futures with the exception
    (serving.py:196-205); the server goes on serving."""
    _, idx, queries, _ = server_setup
    srv = SearchServer(idx, k=5, max_batch=8, backend="ivf")
    try:
        with pytest.raises(Exception, match="search_device serves"):
            srv.search(queries[0], timeout=10)
        srv.backend = "decoded"
        assert srv.search(queries[0], timeout=10)[1].shape == (1, 5)
    finally:
        srv.close()


@pytest.mark.parametrize("backend", ["codes", "decoded8"])
def test_backends_served_like_search_device(server_setup, backend):
    """Every tier search_device serves, through the batcher, padded to
    max_batch, equals search_device of the same rows (the codes tier through
    K1/K2's plain versions here). recall_target has no effect."""
    _, idx, queries, _ = server_setup
    srv = SearchServer(idx, k=10, max_batch=32, backend=backend,
                       recall_target=0.5)
    try:
        got = [srv.submit(queries[j:j + 3]) for j in range(0, 30, 3)]
        i = np.concatenate([f.result(60)[1] for f in got])
    finally:
        srv.close()
    want = idx.search_device(torch.as_tensor(queries[:30]), 10,
                             backend=backend)[1].numpy()
    np.testing.assert_array_equal(i, want)
