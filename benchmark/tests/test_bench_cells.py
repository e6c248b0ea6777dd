"""The benchmark end to end at a size a CPU test run holds: each cell's
path agrees with the plain reference, a run with its timed path broken
underneath comes out not correct, nothing of JAX is loaded, and a cell, a mix
and a metric are added as files alone."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.harness import cell as cell_mod
from benchmark.harness import spec
from benchmark.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
CELLS = ("sift1m-heap.batch", "sift1m-heap.batch-codes", "deep10m-ti.batch")
SEED = 2**31 + 101


def _run(workload, variant=None, seed=SEED):
    return cell_mod.run_cell(tiny.cell(workload), seed, 0.5, False, "cpu",
                             variant=variant)


@pytest.mark.parametrize("workload", CELLS)
def test_reference_agrees_with_the_port(workload):
    out = _run(workload)
    nums, lim = out["numbers"], tiny.cell(workload).limits["limits"]
    for name in ("failed", "bad_answers", "bad_state", "rows_remade"):
        assert nums[name] == 0, (name, nums)
    assert nums["dist_err"] <= lim["dist_err"], nums
    assert nums["code_mismatch"] <= lim["code_mismatch"], nums
    assert nums["rot_offdiag"] <= lim["rot_offdiag"], nums
    assert nums["quant_excess"] <= lim["quant_excess"], nums
    if "bucket_far" in lim:
        assert nums["bucket_far"] <= lim["bucket_far"], nums
    # at this size the probe visits 4 of 32 clusters: a looser miss than
    # the cell's own
    assert nums["miss"] <= 0.3, nums
    line = out["line"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {m.name for m in
                                    tiny.cell(workload).end_to_end}


@pytest.mark.parametrize("workload,fault", [
    ("sift1m-heap.batch", "fault:half"),
    ("sift1m-heap.batch", "fault:altered"),
    ("sift1m-heap.batch", "fault:untrained"),
    ("sift1m-heap.batch-codes", "fault:codebooks"),
    ("deep10m-ti.batch", "fault:half"),
    ("deep10m-ti.batch", "fault:codebooks"),
    ("deep10m-ti.batch", "fault:clusters"),
    ("deep10m-ti.batch", "fault:buckets"),
])
def test_a_broken_timed_path_is_not_correct(workload, fault):
    out = _run(workload, fault)
    assert out["line"]["correct"] is False, out["numbers"]


@pytest.mark.parametrize("workload", ["sift1m-heap.batch",
                                      "sift1m-heap.batch-codes"])
def test_the_control_reads_worse_than_the_program(workload):
    prog = _run(workload)["numbers"]
    ctl = _run(workload, "control")["numbers"]
    assert ctl["dist_err"] > 2 * prog["dist_err"], (prog, ctl)


def test_a_run_loads_nothing_of_jax_and_the_reference_nothing_of_the_port():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import benchmark.reference.adc, benchmark.harness.check\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "assert not top & {'jax', 'jaxlib', 'flax', 'vaq_tpu', "
        "'vaq_tpu_torch'}, top\n"
        "from benchmark.tests import tiny\n"
        "from benchmark.harness import cell\n"
        "cell.run_cell(tiny.cell('deep10m-ti.batch'), 5, 0.3, True, 'cpu')\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "assert 'vaq_tpu_torch' in top\n"
        "assert not top & {'jax', 'jaxlib', 'flax', 'vaq_tpu'}, top\n"
        "assert cell.forbidden_modules() == []\n"
        "sys.modules['vaq_tpu.sub'] = sys\n"
        "assert cell.forbidden_modules() == ['vaq_tpu.sub']\n"
        "print('ok')\n" % str(ROOT))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, env=env, timeout=600)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", \
        proc.stderr[-3000:]


def test_run_refuses_without_a_card_and_prints_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "sift1m-heap.batch", "--seed", str(2**33 + 1), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT, env=env,
        timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_run_fails_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "sift1m-heap.batch", "--seed", "3", "--seconds", "1"],
        capture_output=True, text=True, cwd=tmp_path, env=env, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_a_cell_a_mix_and_a_metric_are_added_as_files_alone(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    b = tmp_path / "benchmark"
    cfg = json.loads((b / "configs" / "sift1m-heap.json").read_text())
    cfg.update(name="sift-small", n=6000, n_queries=300, train_rows=6000,
               encode_chunk_rows=2500)
    (b / "configs" / "sift-small.json").write_text(json.dumps(cfg))
    # a new kind of traffic is a file of its own too
    (b / "loops" / "half_batches.py").write_text(
        "from benchmark.harness.loops import ClosedBatch\n"
        "def make(idx, queries, traffic, k, seed):\n"
        "    t = {**traffic, 'query_batch': traffic['query_batch'] // 2}\n"
        "    return ClosedBatch(idx, queries, t, k)\n")
    (b / "traffic" / "batch-small.json").write_text(json.dumps(
        {"loop": "half_batches", "backend": "decoded", "query_batch": 32}))
    (b / "limits" / "sift-small.batch-small.json").write_text(
        (b / "limits" / "sift1m-heap.batch.json").read_text())
    (b / "layer_metrics" / "window.batches.py").write_text(
        "def read(ctx):\n    return float(ctx['window']['batches'])\n")
    bench["configs"].append({"name": "sift-small", "source": "x",
                             "file": "benchmark/configs/sift-small.json",
                             "reduced": ["n"], "why": "test"})
    bench["workloads"].append({"name": "sift-small.batch-small",
                               "config": "sift-small",
                               "traffic": "batch-small", "chips": 1,
                               "why": "test"})
    bench["end_to_end"][0]["workloads"].append("sift-small.batch-small")
    bench["per_layer"].append({"name": "window.batches", "unit": "batches",
                               "better": "higher", "source": "host_clock",
                               "layer": "index API", "moves": "qps",
                               "workloads": ["sift-small.batch-small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    c = spec.load_cell("sift-small.batch-small", root=tmp_path)
    assert c.config["n"] == 6000 and c.traffic["query_batch"] == 32
    assert [m.name for m in c.per_layer] == ["window.batches"]
    out = cell_mod.run_cell(c, 11, 0.3, True, "cpu")
    assert out["line"]["metrics"]["window.batches"]["value"] >= 1
    assert out["numbers"]["bad_answers"] == 0
    assert out["notes"]["window"]["queries"] == \
        16 * out["notes"]["window"]["batches"]
