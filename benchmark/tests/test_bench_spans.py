"""The readers of the program's spans and counters (``harness/spans.py``
and the ``layer_metrics`` that use it) on synthetic traces whose device
operations, device ranges and host spans are known, so that each reading
has one exact value."""

import math

import pytest
import torch

from benchmark.harness import peaks, spans, spec, trace

BATCH_US = 500.0


def _batch(off):
    """One decoded-tier batch at ``off`` µs: (device ops, device ranges,
    host spans). Scores 110 µs of device time, the scan's own ops 155 µs,
    idle inside ``index.search`` 165 µs."""
    host = [("bench.search_batch", 10, 480), ("index.search", 20, 470),
            ("index.prepare", 20, 40), ("index.upload", 40, 60),
            ("decoded.scan", 70, 400), ("decoded.scores", 80, 150),
            ("aten::mm", 85, 140), ("decoded.scores", 200, 260),
            ("index.copy_back", 400, 470)]
    ops = [("Memcpy HtoD", 60, 70), ("cvt", 95, 100), ("gemm", 120, 160),
           ("sub", 160, 180), ("topk", 185, 200), ("gemm", 250, 290),
           ("sub", 290, 300), ("topk", 305, 320), ("rescore", 330, 450),
           ("Memcpy DtoH", 455, 465)]
    ranges = [("decoded.scan", 95, 450), ("decoded.scores", 120, 180),
              ("decoded.scores", 250, 300)]

    def shift(xs):
        return [(n, a + off, b + off) for n, a, b in xs]

    return shift(ops), shift(ranges), shift(host)


def decoded_trace(batches=2, program=True):
    ops, ranges, host = [], [], []
    for j in range(batches):
        o, r, h = _batch(j * BATCH_US)
        ops += o
        ranges += r
        host += h
    if not program:
        keep = ("bench.", "aten::")
        ranges = []
        host = [s for s in host if s[0].startswith(keep)]
    host.append((trace.WINDOW_RANGE, 0.0, batches * BATCH_US))
    return trace.Trace(ops, ranges, host, 0.0, batches * BATCH_US)


def ctx_of(tr, batches=2, **kw):
    return {"trace": tr, "window": {"batches": batches}, **kw}


def read(name, ctx):
    return spec.load_reader(name)(ctx)


def test_decoded_stages_split_the_scan_by_its_nested_scores():
    ctx = ctx_of(decoded_trace())
    assert read("decoded.scores_ms", ctx) == pytest.approx(0.110, abs=1e-12)
    assert read("decoded.select_ms", ctx) == pytest.approx(0.155, abs=1e-12)
    # the stages and the two copies make up every device op of a batch
    busy_ms = 1e3 * trace.busy_s(ctx["trace"]) / 2
    assert busy_ms == pytest.approx(0.110 + 0.155 + 0.020, abs=1e-12)


@pytest.mark.parametrize("cell", ["decoded", "deep100m"])
def test_api_idle_of_each_decoded_cell_reads_the_same_trace(cell, capsys):
    got = read(f"api.idle_ms.{cell}", ctx_of(decoded_trace()))
    assert got == pytest.approx(0.165, abs=1e-12)
    assert f"api.idle_ms.{cell} by span, ms a batch: decoded.scores " \
        "0.0850" in capsys.readouterr().err


def test_api_idle_splits_program_from_harness(capsys):
    tr = decoded_trace()
    inside, split = spans.api_idle(tr)
    assert inside == pytest.approx(2 * 165e-6, abs=1e-15)
    want_us = {"index.prepare": 40, "index.upload": 40, "decoded.scan": 60,
               "decoded.scores": 170, "index.copy_back": 20,
               "bench.search_batch": 40, "bench.window": 60}
    assert split.keys() == want_us.keys()
    for name, us in want_us.items():
        assert split[name] == pytest.approx(us * 1e-6, abs=1e-15), name
    # every idle instant is named once, and the names sum to the idle time
    assert sum(split.values()) == pytest.approx(
        trace.idle_share(tr) * tr.window_s, abs=1e-15)
    got = read("api.idle_ms.decoded", ctx_of(tr))
    assert got == pytest.approx(0.165, abs=1e-12)
    err = capsys.readouterr().err
    assert "api.idle_ms.decoded by span, ms a batch: decoded.scores 0.0850" \
        in err
    assert "bench.window 0.0300" in err


@pytest.mark.parametrize("name", ["decoded.scores_ms", "decoded.select_ms",
                                  "api.idle_ms.decoded", "api.idle_ms.codes",
                                  "api.idle_ms.probe", "api.idle_ms.deep100m",
                                  "codes.scan_roofline",
                                  "decoded.scores_roofline"])
def test_readers_read_nothing_without_the_spans(name):
    class Index:
        n_rows, total_dim = 1 << 20, 128

    ctx = ctx_of(decoded_trace(program=False), index=Index(),
                 traffic={"query_batch": 1024})
    assert read(name, ctx) is None
    empty = trace.Trace([], [], [(trace.WINDOW_RANGE, 0.0, 1.0)], 0.0, 1.0)
    assert read(name, ctx_of(empty, index=Index(),
                             traffic={"query_batch": 1024})) is None


def test_innermost_names_each_piece_by_the_span_opened_last():
    got = spans.innermost([("a", 0, 10), ("b", 2, 5), ("c", 3, 4),
                           ("d", 7, 12)])
    assert got == [(0, 2, "a"), (2, 3, "b"), (3, 4, "c"), (4, 5, "b"),
                   (5, 7, "a"), (7, 10, "d"), (10, 12, "d")]
    assert spans.intersect([(0, 3), (5, 9)], [(2, 6), (8, 10)]) == \
        [(2, 3), (5, 6), (8, 9)]


def test_codes_scan_roofline_reads_the_stage_with_k1s_bound():
    nq, n, dim, batches = 1024, 1 << 20, 128, 3
    k1 = "decode_window_scan_kernel<true>"
    ops, ranges, host = [], [], []
    for j in range(batches):
        a = 100.0 + 2000.0 * j
        ops += [(k1, a, a + 1200.0), ("topk", a + 1210.0, a + 1300.0)]
        ranges += [("codes.scan", a, a + 1200.0),
                   ("codes.select", a + 1210.0, a + 1300.0)]
        host += [("codes.scan", a - 50.0, a - 10.0)]
    tr = trace.Trace(ops, ranges, host, 0.0, 2000.0 * batches)

    class Index:
        n_rows, total_dim = n, dim

    ctx = ctx_of(tr, batches, index=Index(), traffic={"query_batch": nq})
    want = 100.0 * peaks.scan_bound_s(nq, n, dim) / 1200e-6
    assert math.isclose(read("codes.scan_roofline", ctx), want,
                        rel_tol=1e-12)
    # 2 · 1024 · 2^20 · 128 bf16 operations at 989 TFLOP/s, spelt out
    assert math.isclose(want, 100.0 * 2 * nq * n * dim / 989e12 / 1200e-6,
                        rel_tol=1e-12)


def test_dropped_pct_reads_the_programs_counters(monkeypatch):
    from vaq_tpu_torch import profiling
    ctx = ctx_of(decoded_trace())
    profiling.reset_counters()
    try:
        assert read("ivf.dropped_pct", ctx) is None
        with torch.profiler.profile():
            profiling.count("ivf.entries", torch.tensor(400))
            profiling.count("ivf.entries_dropped", torch.tensor(30))
        assert read("ivf.dropped_pct", ctx) == pytest.approx(7.5)
        monkeypatch.delattr(profiling, "counters")
        assert read("ivf.dropped_pct", ctx) is None
    finally:
        profiling.reset_counters()
