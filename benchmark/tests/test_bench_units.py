"""The benchmark's arithmetic on made-up inputs: rows from a seed, rates and
due-time percentiles, a trace's idle share and stage attribution, K1's
bound."""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.harness import cell as cell_mod
from benchmark.harness import datagen, peaks, stats, trace

HERE = Path(__file__).resolve().parent


def _reader_module(name):
    path = HERE.parent / "layer_metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", [0, 2**31 + 11, 3 * 2**40 + 5, -7])
def test_seeded_rows_are_deterministic(seed):
    a = datagen.make_rows(3000, 16, 50, seed, "cpu")
    b = datagen.make_rows(3000, 16, 50, seed, "cpu")
    c = datagen.make_rows(3000, 16, 50, seed + 1, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert a[0].shape == (3000, 16) and a[1].shape == (50, 16)
    assert torch.equal(datagen.train_rows(3000, 100, seed, "cpu"),
                       datagen.train_rows(3000, 100, seed, "cpu"))
    assert datagen.train_rows(3000, 3000, seed, "cpu") is None


def test_window_rate_and_due_time_percentiles_with_misses():
    due = [0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9]
    done = [0.01, 0.12, 0.23, 0.34, 0.45, 0.56, 0.67, 0.78, math.nan,
            0.95]
    lat = stats.due_latencies(due, done)
    assert lat[8] == math.inf
    assert lat[0] == pytest.approx(0.01)
    # nearest rank: sorted[int(p * n)]; the missing answer sorts last
    assert stats.percentile(lat, 0.95) == math.inf
    assert stats.percentile(lat, 0.5) == pytest.approx(0.05)
    assert stats.percentile(lat[:8], 0.95) == pytest.approx(0.08)
    assert stats.rate(4096, 2.0) == 2048.0


def _trace():
    ops = [("k1", 10.0, 20.0), ("k2", 15.0, 30.0), ("k3", 50.0, 60.0),
           ("k4", 62.0, 64.0), ("memcpy", 90.0, 100.0)]
    ranges = [("ivf.merge", 45.0, 61.0), ("ivf.groupmin", 8.0, 31.0),
              ("ivf.merge", 150.0, 160.0)]
    host = [("bench.window", 0.0, 100.0), ("aten::item", 30.0, 50.0),
            ("cudaStreamSynchronize", 30.2, 49.0), ("python", 64.0, 90.0)]
    return trace.Trace(ops, ranges, host, 0.0, 100.0)


def test_idle_share_and_stage_attribution_on_a_made_up_trace():
    tr = _trace()
    # busy: [10, 30] ∪ [50, 60] ∪ [62, 64] ∪ [90, 100] = 42 µs of 100
    assert trace.busy_s(tr) == pytest.approx(42e-6)
    assert trace.idle_share(tr) == pytest.approx(0.58)
    assert tr.window_s == pytest.approx(100e-6)
    # ops starting inside the merge range (45-61): k3 only; the second
    # merge range lies outside the window
    assert trace.in_range_s(tr, "ivf.merge") == pytest.approx(10e-6)
    assert trace.range_count(tr, "ivf.merge") == 1
    assert trace.in_range_s(tr, "ivf.groupmin") == pytest.approx(25e-6)
    assert trace.op_time_s(tr, lambda n: n.startswith("k")) == \
        (pytest.approx(37e-6), 4)
    gaps = trace.idle_gaps(tr)
    # longest gap 64-90 under "python"; 30-50 under the sync, the
    # innermost op open as it began; 0-10 under no op
    assert gaps[0] == ["python", pytest.approx(26e-6)]
    assert gaps[1] == ["cudaStreamSynchronize", pytest.approx(20e-6)]
    assert gaps[2] == ["host, outside any op", pytest.approx(10e-6)]
    top = trace.top_device_ops(tr)
    assert top[0] == ["k2", pytest.approx(15e-6)]


def test_window_layer_readers_on_a_made_up_trace():
    tr = _trace()
    ctx = {"trace": tr, "window": {"batches": 2}}
    assert _reader_module("device.idle_pct.decoded").read(ctx) == \
        pytest.approx(58.0)
    assert _reader_module("ivf.merge_ms").read(ctx) == pytest.approx(1e-2)
    for cell in ("codes", "probe", "deep100m"):
        assert _reader_module(f"device.idle_pct.{cell}").read(ctx) == \
            pytest.approx(58.0)
    # a reader that finds nothing to read returns nothing, never 0
    empty = trace.Trace([], [], [], 0.0, 100.0)
    assert _reader_module("device.idle_pct.probe").read(
        {"trace": empty}) is None
    for name in ("codes.scan_roofline", "decoded.scores_roofline"):
        assert _reader_module(name).read(
            {"trace": empty, "window": {"batches": 3}}) is None


def test_k1_bound_reproduces_the_known_figure():
    # K1's and D1's bound: 0.2651 ms at 1024 × 1M × 128, 9.9397 at the
    # DEEP cell's 1024 × 50M × 96
    assert peaks.scan_bound_s(1024, 1_000_000, 128) * 1e3 == pytest.approx(
        0.2651, abs=5e-5)
    assert peaks.scan_bound_s(1024, 50_000_000, 96) * 1e3 == pytest.approx(
        9.9397, abs=5e-5)


def test_host_calibration_times_a_fixed_loop():
    got = cell_mod.host_calibration()
    assert set(got) == {"python_s", "numpy_s"}
    assert all(0 < v < 5 for v in got.values()), got


def test_k5_bytes_count_occupied_buckets_and_dispatched_entries():
    k5 = _reader_module("groupmin_window_scan_roofline")
    # 4 clusters on a line; queries next to clusters 0 and 1 only
    cents = torch.tensor([[0.0], [10.0], [20.0], [30.0]])
    sizes = torch.tensor([5, 3, 5, 5])
    qp = torch.tensor([[0.1], [0.2], [9.9], [0.3]])
    b = k5.batch_bytes(qp, cents, sizes, dim=1, elem_bytes=1, k=1,
                       p_visit=1, p_max=2, qcap=2, gs=4)
    # cluster 0 takes 3 queries, capped at qcap 2; cluster 1 takes 1: the
    # live rows of the two buckets (5 + 3 one-byte rows, not their
    # capacity), 3 entries of 2-byte rows, and each entry's minima, one a
    # group of 4 live rows (2 groups in cluster 0, 1 in cluster 1)
    assert b == (5 + 3) * 1 + 3 * 2 + (2 * 2 + 1 * 1) * 4


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
@pytest.mark.parametrize("budget,lo,hi", [(256, 7, 8), (256, 5, 12),
                                          (128, 1, 4)])
def test_reference_bit_allocation_equals_the_ports(seed, budget, lo, hi):
    from vaq_tpu_torch import bitalloc
    from benchmark.reference import train as ref_train
    rng = np.random.default_rng(seed)
    var = np.sort(rng.gamma(0.6, size=32))[::-1]
    var = var / var.sum()
    cum = np.cumsum(var)
    ref = ref_train.allocate_bits(var, cum, budget, lo, hi, 1.0)
    port = bitalloc.allocate_bits(var, budget, lo, hi, cum_var=cum,
                                  percent_var_explained=1.0)
    assert ref.sum() == budget
    assert float(var @ ref) == pytest.approx(float(var @ port), abs=1e-12)


def test_reference_rotation_and_quantizer_on_made_up_rows():
    from benchmark.reference import train as ref_train
    base, _ = datagen.make_rows(4000, 16, 10, 3, "cpu")
    rot = ref_train.rotation(base, 8)
    e = rot["eigvecs"]
    assert torch.allclose(e.T @ e, torch.eye(16, dtype=torch.float64),
                          atol=1e-10)
    assert np.all(np.diff(rot["var_per_subs"]) <= 1e-12)
    gen = torch.Generator().manual_seed(0)
    qs = ref_train.quantizers(base, 8, 32, 2, 6, 1.0, gen)
    q = qs[0]
    assert q["bits"].sum() == 32 and len(q["books"]) == 8
    err = ref_train.recon_error(base, q)
    # a trained quantizer beats one whose codebooks are a single centroid
    flat = {**q, "books": [b[:1] * 0 for b in q["books"]]}
    assert 0 < err < 0.5 * ref_train.recon_error(base, flat)
