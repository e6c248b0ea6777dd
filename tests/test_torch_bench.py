"""bench_torch.py against bench.py on the CPU.

Both scripts run as subprocesses from copies in a temporary directory (each
writes its caches and its full record beside its own file, so nothing lands
in the repository), JAX with ``JAX_PLATFORMS=cpu`` and the port with
``--device cpu``, at a small size: 8192 × 128 rows, 32 queries, 32-query
batches, 2 timed iterations, 32 IVF clusters. The oracle runs on a 1024-row
slice: it costs about 14 ms a row on the host, in both scripts alike. QPS
fields are CPU timings and are not compared.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import bench_torch  # noqa: E402

SMALL = ["--n", "8192", "--queries", "32", "--batch", "32", "--iters", "2",
         "--ivf-clusters", "32", "--oracle-n", "1024"]
ONLY_SERVING = ["--no-secondary", "--no-capacity", "--no-ivf", "--no-oracle",
                "--no-kernel-check", "--serving-rate-max", "4000"]
# The recall fields of the record and how far the port's may lie from JAX's:
# the IVF probe's wider, since JAX's bench calls it with exact=False (an
# approximate top-k) and the port's probe is exact. The oracle's own recall
# is the same numpy code on the same rows in both scripts, so it must be
# equal; the engine's on the oracle's slice, and its gap to the oracle, are
# each package's own.
RECALL_TOL = {"recall_at_10": 0.005, "recall_at_100": 0.005,
              "recall_at_10_refined": 0.005, "codes_recall_at_k": 0.005,
              "fast4_recall_at_k": 0.005,
              "engine_oracle_slice_recall_at_k": 0.005,
              "oracle_delta_recall": 0.005, "ivf_recall_at_k": 0.02}
TIMEOUT_S = 300


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """One directory with both scripts and tests/oracle_ref.py; the cases
    share its caches (the first builds the data and indexes)."""
    d = tmp_path_factory.mktemp("bench")
    shutil.copy(ROOT / "bench.py", d / "bench.py")
    shutil.copy(ROOT / "bench_torch.py", d / "bench_torch.py")
    (d / "tests").mkdir()
    shutil.copy(ROOT / "tests" / "oracle_ref.py",
                d / "tests" / "oracle_ref.py")
    return d


def _start(workdir: Path, script: str, args: list) -> subprocess.Popen:
    # two torch threads: the runs share the host with each other and with
    # the other test workers, and an oversubscribed torch crawls
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "2"}
    cmd = [sys.executable, script, *args]
    if script == "bench.py":
        env["JAX_PLATFORMS"] = "cpu"
    else:
        cmd += ["--device", "cpu"]
    return subprocess.Popen(cmd, cwd=workdir, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _finish(proc: subprocess.Popen):
    """(exit code, the last stdout line parsed, the number of stdout
    lines); the stderr tail on failure."""
    try:
        out, err = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    lines = out.strip().splitlines()
    assert lines, err[-3000:]
    return proc.returncode, json.loads(lines[-1]), len(lines), err


def _both(workdir: Path, args: list):
    jax_p = _start(workdir, "bench.py", args)
    port_p = _start(workdir, "bench_torch.py", args)
    return _finish(jax_p), _finish(port_p)


def _sidecars(workdir: Path):
    with open(workdir / "bench_runs" / "last_full.json") as f:
        jax_full = json.load(f)
    with open(workdir / ".bench_cache" / "torch" / "last_full.json") as f:
        port_full = json.load(f)
    return jax_full, port_full


def test_fields_and_recalls_match_bench_py(workdir):
    (j_rc, j_line, j_n, j_err), (p_rc, p_line, p_n, p_err) = _both(
        workdir, [*SMALL, "--no-serving"])
    assert j_rc == 0, j_err[-3000:]
    assert p_rc == 0, p_err[-3000:]
    assert p_n == 1                    # stdout carries the one line only
    assert len(json.dumps(p_line)) <= bench_torch._STDOUT_BUDGET
    # value_unstable is written only when the headline's runs spread more
    # than 15%: a property of this host's timing, not of the fields
    assert set(j_line) - {"value_unstable"} == \
        set(p_line) - {"value_unstable"}
    assert j_line["kernel_parity_ok"] is None
    assert p_line["kernel_parity_ok"] is None
    assert p_line["n"] == j_line["n"] == 8192
    assert p_line["config"] == j_line["config"]

    # the full records: every field of the line and the arrays beside it
    jax_full, port_full = _sidecars(workdir)
    assert set(jax_full) - {"value_unstable"} <= set(port_full)
    for key, tol in RECALL_TOL.items():
        assert abs(port_full[key] - jax_full[key]) <= tol, \
            (key, port_full[key], jax_full[key])
    assert port_full["oracle_recall_at_k"] == jax_full["oracle_recall_at_k"]
    assert port_full["env"]["device"] == "cpu"
    # the kernel shapes of the codes and IVF steps: at 8192 rows the codes
    # tier has no windows at k = 10 (8192 // 640 < 16 rows) and serves the
    # decoded tier; up to 256 queries the probe gives every query a slot
    shapes = port_full["kernel_shapes"]
    assert shapes["codes"] == {"n": 8192, "M": 32, "C": 256, "L": 4,
                               "nq": 32, "block_rows": None, "launches": {}}
    assert [shapes["fast4"][k] for k in ("M", "C", "L", "block_rows")] == \
        [64, 16, 2, None]
    (visit,) = shapes["ivf"]["visits"]
    assert (visit["visit"], visit["ncl"], visit["nq"], visit["qcap"],
            visit["windows"]) == (0.1, 32, 32, 32, 20)
    # no kernel launches on the CPU: the wrappers ran their plain versions
    assert port_full["launches"] == {}
    assert {"data_build_groundtruth", "recall", "headline_first",
            "kernel_parity", "secondary", "capacity", "ivf", "oracle",
            "headline_last"} == set(port_full["section_s"])
    assert len(port_full["value_runs"]) == 5


# bench.py:186-204: the fields of one served tier, by whether a knee was
# found
SERVING_FIELDS = {
    False: {"serving_sweep"},
    True: {"serving_sweep", "serving_knee_qps", "serving_qps",
           "serving_p50_ms", "serving_p95_ms", "serving_onchip_batch_ms"}}


def _serving_fields(full: dict, prefix: str) -> set:
    return {k[len(prefix):] for k in full
            if k.startswith(prefix + "serving_")}


def _replayed(sweep: list, rate_max: float) -> list:
    """The offered rates that the port's rule gives when each probe keeps
    up or not as the sweep's own probe did."""
    recorded = iter(sweep)

    def run_rate(rate):
        point = next(recorded)
        return (rate if point["sustained"] else 0.0), 1.0, 2.0

    _, points = bench_torch.sweep_offered_rates(run_rate, rate_max)
    return [p["offered"] for p in points]


def test_serving_fields_match_bench_py(workdir):
    (j_rc, _, _, j_err), (p_rc, p_line, _, p_err) = _both(
        workdir, [*SMALL, *ONLY_SERVING])
    assert j_rc == 0, j_err[-3000:]
    assert p_rc == 0, p_err[-3000:]
    jax_full, port_full = _sidecars(workdir)
    for prefix in ("", "codes_"):
        for full in (jax_full, port_full):
            knee = f"{prefix}serving_knee_qps" in full
            assert _serving_fields(full, prefix) == SERVING_FIELDS[knee]
            sweep = full[f"{prefix}serving_sweep"]
            assert all(set(p) == {"offered", "achieved", "p50_ms", "p95_ms",
                                  "sustained"} for p in sweep)
            assert [p["offered"] for p in sweep] == _replayed(sweep, 4000.0)
    assert {k for k in p_line if "serving" in k} <= \
        {k for k in bench_torch._STDOUT_KEYS if "serving" in k}


# Achieved rates per offered rate, and the offered sequence and knee that
# bench.py:163-185 gives for them, worked out by hand: a knee at 2000, then
# 4000 fails, the midpoint 3000 fails, 2500 fails and lies within 1.26× of
# the knee; every rate kept up with to the cap; the first rate missed; a
# midpoint that keeps up, after which the doubling starts again.
SWEEPS = [
    ({2000.0: 1995.0, 4000.0: 2600.0, 3000.0: 2500.0, 2500.0: 2400.0},
     4000.0, [2000.0, 4000.0, 3000.0, 2500.0], 2000.0),
    ({r: r for r in (2000.0, 4000.0, 8000.0, 16000.0, 32000.0)},
     32000.0, [2000.0, 4000.0, 8000.0, 16000.0, 32000.0], 32000.0),
    ({2000.0: 1900.0}, 32000.0, [2000.0], None),
    ({2000.0: 2000.0, 4000.0: 3990.0, 8000.0: 5000.0, 6000.0: 5900.0,
      12000.0: 6100.0, 9000.0: 6200.0, 7500.0: 6300.0},
     32000.0, [2000.0, 4000.0, 8000.0, 6000.0, 12000.0, 9000.0, 7500.0],
     6000.0),
]


@pytest.mark.parametrize("achieved,rate_max,offered,knee", SWEEPS)
def test_sweep_rule_on_a_fixed_table(achieved, rate_max, offered, knee):
    got_knee, points = bench_torch.sweep_offered_rates(
        lambda r: (achieved[r], 5.0, 9.0), rate_max)
    assert [p["offered"] for p in points] == offered
    assert got_knee == knee
    assert [p["sustained"] for p in points] == \
        [achieved[r] >= 0.97 * r for r in offered]


def test_a_failed_section_writes_its_error_and_exits_1(workdir):
    proc = _start(workdir, "bench_torch.py", [
        *SMALL, "--ivf-clusters", "0", "--no-secondary",
        "--no-capacity", "--no-serving", "--no-oracle", "--no-kernel-check"])
    rc, line, n_lines, err = _finish(proc)
    assert rc == 1, err[-3000:]
    assert n_lines == 1
    assert "ConfigError" in line["ivf_error"]
    assert len(line["ivf_error"]) <= 80
    assert {"value", "recall_at_10", "value_spread_pct"} <= set(line)
    with open(workdir / ".bench_cache" / "torch" / "last_full.json") as f:
        assert "ti_cluster_num" in json.load(f)["ivf_error"]
