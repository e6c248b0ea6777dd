"""The ``deep100m-heap.batch`` cell at a size a CPU test run holds (its
method, ``min5max8`` over 32 subspaces of 96 dimensions, on 12,288 rows):
the port agrees with the plain reference, a broken timed path comes out not
correct, ``qps.deep100m`` is the window's rate, and the cell's readers read
the number their inputs give."""

import json
import math

import pytest

from benchmark.harness import cell as cell_mod
from benchmark.harness import spec, trace
from benchmark.tests import tiny

CELL = "deep100m-heap.batch"
SEED = 2**32 + 2**31 + 22


def _run(variant=None):
    return cell_mod.run_cell(tiny.cell(CELL), SEED, 0.5, False, "cpu",
                             variant=variant)


@pytest.fixture(scope="module")
def sound():
    return _run()


def test_the_cell_names_its_own_rate_and_readers():
    c = tiny.cell(CELL)
    assert [m.name for m in c.end_to_end] == ["qps.deep100m", "peak_gib",
                                             "setup_s"]
    assert {m.name for m in c.per_layer} == {
        "decoded.scores_roofline", "decoded.kept_per_query",
        "device.idle_pct.deep100m", "api.idle_ms.deep100m"}


def test_the_cell_at_test_size_agrees_with_the_reference(sound):
    c = tiny.cell(CELL)
    assert c.config["d"] == 96 and c.config["method"] == \
        "VAQ256m32min5max8var1,HEAP" and c.config["probe"] is None
    out = sound
    nums, lim = out["numbers"], c.limits["limits"]
    for name in ("failed", "bad_answers", "bad_state", "rows_remade"):
        assert nums[name] == 0, (name, nums)
    for name in ("dist_err", "code_mismatch", "rot_offdiag", "quant_excess"):
        assert nums[name] <= lim[name], (name, nums)
    line = out["line"]
    assert line["correct"] is True and line["attempted"] > 0
    assert set(line["metrics"]) == {"qps.deep100m", "peak_gib", "setup_s"}


def test_the_cells_rate_is_the_windows_rate(sound, capsys):
    win = sound["notes"]["window"]
    got = sound["line"]["metrics"]["qps.deep100m"]
    assert got == {"value": win["qps"], "unit": "queries/s"}
    assert win["qps"] == win["queries"] / win["seconds"] > 0
    # the host's calibration is in the notes alone, printed before the
    # checks, which stay the last lines
    assert set(sound["notes"]["host_calib"]) == {"python_s", "numpy_s"}
    assert "host_calib" not in json.dumps(sound["line"])
    cell_mod.report(sound)
    err = capsys.readouterr().err.splitlines()
    calib = next(i for i, x in enumerate(err) if x.startswith("host_calib"))
    checks = [i for i, x in enumerate(err) if x.startswith("check ")]
    assert checks and calib < min(checks)
    assert checks == list(range(len(err) - len(checks), len(err)))


@pytest.mark.parametrize("fault", ["fault:altered", "fault:untrained"])
def test_a_broken_timed_path_is_not_correct(fault):
    out = _run(fault)
    assert out["line"]["correct"] is False, out["numbers"]


class _Index:
    n_rows, total_dim = 100_000_000, 96


def _ctx(tr, batches, nq=1024):
    return {"trace": tr, "window": {"batches": batches}, "index": _Index(),
            "traffic": {"query_batch": nq}}


def _read(name, ctx):
    return spec.load_reader(name)(ctx)


def test_scores_roofline_reads_the_spans_device_time_against_the_bound():
    batches, d1_us = 4, 95_000.0
    ops, ranges = [], []
    for j in range(batches):
        a = 1000.0 + 100_000.0 * j
        # D1 and its bound's fill inside the span, the merge outside
        ops += [("fill", a, a + 2.0), ("decoded_topk_scan_kernel", a + 3.0,
                                        a + 3.0 + d1_us - 2.0),
                ("radixSortKVInPlace", a + d1_us + 5.0, a + d1_us + 300.0)]
        ranges += [("decoded.scan", a, a + d1_us + 400.0),
                   ("decoded.scores", a, a + d1_us + 1.0)]
    tr = trace.Trace(ops, ranges, [], 0.0, 100_000.0 * batches)
    # 2 · 1024 · 1e8 · 96 bf16 operations at 989 TFLOP/s: 19.88 ms a batch
    bound = 2.0 * 1024 * 100_000_000 * 96 / 989e12
    want = 100.0 * bound / (d1_us * 1e-6)
    assert math.isclose(_read("decoded.scores_roofline", _ctx(tr, batches)),
                        want, rel_tol=1e-12)
    assert 20.9 < want < 21.0
    none = trace.Trace(ops, [r for r in ranges if r[0] != "decoded.scores"],
                       [], 0.0, 100_000.0 * batches)
    assert _read("decoded.scores_roofline", _ctx(none, batches)) is None
    assert _read("decoded.scores_roofline", _ctx(tr, 0)) is None


def test_kept_per_query_reads_the_programs_counter(monkeypatch):
    from vaq_tpu_torch import profiling
    tr = trace.Trace([], [], [], 0.0, 1.0)
    monkeypatch.setattr(profiling, "counters",
                        lambda: {"decoded.kept": 3 * 1024 * 2500,
                                 "ivf.entries": 7})
    assert _read("decoded.kept_per_query", _ctx(tr, 3)) == 2500.0
    assert _read("decoded.kept_per_query", _ctx(tr, 3, nq=512)) == 5000.0
    assert _read("decoded.kept_per_query", _ctx(tr, 0)) is None
    monkeypatch.setattr(profiling, "counters", lambda: {"ivf.entries": 7})
    assert _read("decoded.kept_per_query", _ctx(tr, 3)) is None
    monkeypatch.delattr(profiling, "counters")
    assert _read("decoded.kept_per_query", _ctx(tr, 3)) is None
