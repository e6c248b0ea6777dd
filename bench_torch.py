"""Benchmark entry point of the PyTorch port (``vaq_tpu_torch``), one card.

    python3 bench_torch.py                 # on the card, bench.py's defaults
    python3 bench_torch.py --device cpu    # the same sections on the CPU

It runs ``bench.py``'s sections in ``bench.py``'s order, with its flags, its
defaults and its field names: SIFT1M-scale ADC search QPS at measured recall
(1M × 128-d, ``VAQ256m32min7max8var1,HEAP``), the kernel gate, the int8 and
Hamming tiers, the codes tier on the HEAP and on a FAST index, the IVF probe,
the continuous-batching server, the engine-vs-oracle recall and the 10M
section. One flag is its own: ``--device`` (``cuda`` by default; without a
card the run raises ``DeviceError`` and prints no line).

Timing is ``bench.py``'s marginal cost, (T(iters) − T(1)) / (iters − 1),
each T the minimum of three runs after one warm-up call, each run the host
wall clock of back-to-back calls on one device batch between two
synchronisations: the host's time between launches counts, as users feel it.
A CUDA stream runs the calls in order and elides none, so ``bench.py``'s
chained-dependency trick is not needed. The headline is measured five times,
two before the other sections and three after them, and reported as the
median with its spread.

All progress goes to stderr; stdout carries exactly one JSON line, at the
end (``slim_line``: at most 1900 characters). A section that raises writes a
``<name>_error`` field and the later sections still run; the run then exits
with status 1, as it does when the kernel gate reports
``kernel_parity_ok: false``. Data, groundtruth, the oracle's recall and the
built indexes are cached under ``.bench_cache/torch/`` beside this file (the
indexes keyed by a hash of the ``vaq_tpu_torch`` sources); the full record,
with the card's ``nvidia-smi`` name and power limit, the CUDA and ``nvcc``
versions, each section's wall seconds and each kernel's launches, and the
kernel shapes of the codes and IVF steps, goes to
``.bench_cache/torch/last_full.json`` after every section.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import hashlib
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

import vaq_tpu_torch
from vaq_tpu_torch import metrics, pca
from vaq_tpu_torch.device import resolve

HERE = os.path.dirname(os.path.abspath(__file__))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# _STDOUT_KEYS, _STDOUT_BUDGET and slim_line are copied from bench.py:31-74,
# so that both benches print the same line from the same record.

#: Keys allowed on the one stdout JSON line, in priority order (a caller
#: that captures the output keeps only ~2000 chars, and BENCH_r03/r04 both
#: lost their parsed headline to an over-long line — VERDICT r4 #1).
#: Array-valued fields (sweeps, per-run samples) go to the sidecar only.
_STDOUT_KEYS = (
    "metric", "value", "unit", "vs_baseline",
    "recall_at_10", "recall_at_100", "recall_at_10_refined",
    "batch_latency_ms", "n", "config",
    "value_spread_pct", "value_unstable",
    "kernel_parity_ok", "oracle_delta_recall",
    "ivf_qps", "ivf_recall_at_k", "ivf_visit",
    "tenm_qps", "tenm_recall_at_k",
    "tenm_ivf_qps", "tenm_ivf_visit", "tenm_ivf_recall_at_k",
    "tenm_ivf_all_beat_exhaustive",
    "tenm_codes_qps", "tenm_codes_recall_at_k",
    "codes_qps", "codes_recall_at_k", "fast4_qps", "fast4_recall_at_k",
    "decoded8_qps", "hamming_qps",
    "serving_knee_qps", "serving_p50_ms", "serving_p95_ms",
    "serving_onchip_batch_ms", "codes_serving_knee_qps",
    "build_s", "tenm_build_s", "tenm_n", "widebits_qps",
    "widebits_recall_at_k",
)
_STDOUT_BUDGET = 1900  # stay under a 2000-char capture window


def slim_line(out: dict) -> str:
    """The stdout JSON line: whitelisted scalar fields + truncated errors,
    trimmed from the tail of the priority list if it would still exceed the
    capture window. The full dict goes to the sidecar file.
    A copy of bench.py:56-74."""
    slim = {k: out[k] for k in _STDOUT_KEYS if k in out}
    for k, v in out.items():
        if k.endswith("_error"):
            slim[k] = str(v)[:80]
    line = json.dumps(slim)
    while len(line) > _STDOUT_BUDGET:
        for k in reversed(_STDOUT_KEYS):
            if k in slim and k not in ("metric", "value", "unit",
                                       "vs_baseline"):
                del slim[k]
                break
        else:
            break
        line = json.dumps(slim)
    return line


def parser() -> argparse.ArgumentParser:
    """bench.py:381-421's flags and defaults, and ``--device``."""
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=1_000_000)
    p.add_argument("--d", type=int, default=128)
    p.add_argument("--queries", type=int, default=1024)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--config", default="VAQ256m32min7max8var1,HEAP")
    p.add_argument("--batch", type=int, default=1024,
                   help="query batch size for the timed runs")
    p.add_argument("--iters", type=int, default=32)
    p.add_argument("--no-cache", action="store_true")
    p.add_argument("--no-secondary", action="store_true",
                   help="skip decoded8/hamming measurements")
    p.add_argument("--no-capacity", action="store_true",
                   help="skip the codes-tier measurements (HEAP and FAST)")
    p.add_argument("--no-ivf", action="store_true",
                   help="skip the IVF cluster-probe measurement")
    p.add_argument("--no-serving", action="store_true",
                   help="skip the SearchServer latency measurement")
    p.add_argument("--ivf-visit", default="0.10",
                   help="visit fraction(s); comma-separated list sweeps "
                        "several fractions over one IVF build")
    p.add_argument("--ivf-clusters", type=int, default=1000)
    p.add_argument("--serving-rate-max", type=float, default=32000.0,
                   help="upper bound for the serving offered-load sweep")
    p.add_argument("--serving-wait-ms", type=float, default=5.0)
    p.add_argument("--serving-depth", type=int, default=4)
    p.add_argument("--oracle-n", type=int, default=100_000,
                   help="slice size for the engine-vs-oracle recall "
                        "companion (0 disables)")
    p.add_argument("--no-oracle", action="store_true")
    p.add_argument("--no-kernel-check", action="store_true")
    p.add_argument("--second-n", type=int, default=10_000_000,
                   help="row count for the second-scale section (0 disables)")
    p.add_argument("--no-10m", action="store_true",
                   help="skip the second-scale section (codes tier + "
                        "IVF-vs-exhaustive at 10M)")
    p.add_argument("--ivf-visit-10m", default="0.25,0.10,0.05",
                   help="visit-fraction sweep for the second-scale IVF "
                        "section (Fig. 11 fractions)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the run; 'cpu' runs the kernels' "
                        "plain versions (no CPU fallback from 'cuda')")
    return p


def bench_data(cache_dir: str, n: int, d: int, queries: int,
               use_cache: bool = True):
    """(base, queries): ``make_anisotropic_gaussian(n, d, queries,
    seed=42)``, read from ``cache_dir``'s npz of that size where it exists
    (and ``use_cache``), else made and written there."""
    from vaq_tpu_torch.data import make_anisotropic_gaussian
    t0 = time.perf_counter()
    path = os.path.join(cache_dir, f"data_n{n}_d{d}_q{queries}.npz")
    if os.path.exists(path) and use_cache:
        with np.load(path) as z:
            base, qs = z["base"], z["queries"]
        log(f"data loaded from cache: {time.perf_counter() - t0:.1f}s")
        return base, qs
    base, qs = make_anisotropic_gaussian(n, d, queries, seed=42)
    os.makedirs(cache_dir, exist_ok=True)
    np.savez(path, base=base, queries=qs)
    log(f"data gen: {time.perf_counter() - t0:.1f}s")
    return base, qs


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------

def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_time(step_fn, qb: torch.Tensor, iters: int) -> float:
    """Host wall seconds of ``iters`` back-to-back ``step_fn(qb)`` calls,
    between two synchronisations of the batch's device."""
    _sync(qb.device)
    t0 = time.perf_counter()
    for _ in range(iters):
        step_fn(qb)
    _sync(qb.device)
    return time.perf_counter() - t0


def measure_qps(step_fn, qb: torch.Tensor, batch: int, iters: int):
    """(qps, ms_per_batch) via marginal cost (T(iters) − T(1)) / (iters−1)
    (bench.py:108-114)."""
    run_time(step_fn, qb, 1)  # warm-up
    t1 = min(run_time(step_fn, qb, 1) for _ in range(3))
    tn = min(run_time(step_fn, qb, iters) for _ in range(3))
    ms = (tn - t1) / (iters - 1) * 1000.0
    return batch / (ms / 1000.0), ms


# ---------------------------------------------------------------------------
# The run's record
# ---------------------------------------------------------------------------

def kernel_launches() -> dict:
    """Each kernel wrapper's launch counter, by kernel."""
    from vaq_tpu_torch.ops import (hamming, probe_scan, rescore, scan_codes,
                                   scan_decoded)
    f4 = scan_codes.fast4_window_scan.launches
    return {"decode_window_scan": scan_codes.decode_window_scan.launches,
            "decode_rescore": scan_codes.decode_rescore.launches,
            "fast4_window_scan": f4["K3"],
            "fast4_window_scan_int8": f4["K4"],
            "groupmin_window_scan": probe_scan.groupmin_window_scan.launches,
            "gather_rescore": rescore.gather_rescore.launches,
            "popcount_dists": hamming.popcount_dists.launches,
            "decoded_topk_scan": scan_decoded.decoded_topk_scan.launches}


def launches_since(before: dict) -> dict:
    """The kernels launched since ``before`` (a :func:`kernel_launches`
    reading), and how often."""
    after = kernel_launches()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def codes_shape(idx, nq: int, k: int) -> dict:
    """The shape at which the codes tier runs K1 on ``idx`` for one batch
    of ``nq`` queries at ``k``: the rows, the codebook's (M, C, L) and the
    window rows."""
    m, c, l = idx.centroids.shape
    return {"n": idx.n_rows, "M": m, "C": c, "L": l, "nq": nq,
            "block_rows": idx._codes_block_rows(k)}


def ivf_shape(state, visit: float, nq: int, k: int) -> dict:
    """The shapes at which ``IVFSearcher(state, visit)`` runs K5 and K7 for
    one batch of ``nq`` queries at ``k``: the buckets, the query slots a
    cluster (qcap), the group rows (gs) and the windows each query
    rescores."""
    from vaq_tpu_torch.ivf import IVFSearcher
    _, p_max, qcap, gs = IVFSearcher(state, visit).params(k, nq)
    return {"visit": visit, "ncl": state.ncl, "cap": state.cap,
            "d": state.d_full, "rows_dtype": str(state.bucket_rows.dtype),
            "nq": nq, "p_max": p_max, "qcap": qcap, "gs": gs,
            "windows": min(max(2 * k, 16), p_max * (state.cap // gs))}


def _tool_output(cmd) -> str | None:
    """A tool's stdout, or None where it is missing or fails."""
    try:
        return subprocess.run(cmd, capture_output=True, text=True, check=True,
                              timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def environment(dev: torch.device) -> dict:
    """The card and the toolchain the run's numbers belong to."""
    from vaq_tpu_torch import _build
    try:
        nvcc = _tool_output([_build._nvcc(), "--version"])
    except _build.KernelBuildError:
        nvcc = None
    return {"device": str(dev),
            "device_name": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
            "nvidia_smi": _tool_output(["nvidia-smi",
                                        "--query-gpu=name,power.limit",
                                        "--format=csv,noheader"]),
            "torch": torch.__version__, "torch_cuda": torch.version.cuda,
            "nvcc": nvcc, "python": sys.version.split()[0]}


def source_hash() -> str:
    """sha256 of the ``vaq_tpu_torch`` sources: what a cached index was
    built by."""
    root = Path(vaq_tpu_torch.__file__).parent
    h = hashlib.sha256()
    for p in sorted(root.rglob("*")):
        if p.is_file() and p.suffix in (".py", ".cu", ".cuh", ".cpp"):
            h.update(str(p.relative_to(root)).encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


class Record:
    """Each section's fields, wall seconds and kernel launches, in run
    order. :meth:`section` rewrites the sidecar after every section, so a
    run cut short keeps what it measured."""

    def __init__(self, path: str, env: dict, ref_qps=None):
        self.path = path
        self.env = env
        self.ref_qps = ref_qps
        self.fields: dict = {}
        self.section_s: dict = {}
        self.launches: dict = {}
        # the kernel shapes of a section's steps, and their launches
        self.shapes: dict = {}
        self.t0 = time.perf_counter()

    def section(self, name: str, fn, guard: bool = True) -> dict:
        """Run ``fn`` as section ``name``. Guarded (bench.py:536-541), an
        exception becomes a ``<name>_error`` field and the run goes on."""
        before = kernel_launches()
        t0 = time.perf_counter()
        try:
            fields = fn() or {}
        except Exception as e:  # noqa: BLE001 — the later sections still run
            if not guard:
                raise
            log(f"{name} section failed: {e!r}")
            fields = {f"{name}_error": repr(e)}
        self.section_s[name] = round(time.perf_counter() - t0, 3)
        self.launches[name] = launches_since(before)
        self.fields[name] = fields
        self.write()
        return fields

    def result(self) -> dict:
        """The bench record of the sections run so far."""
        return assemble(self.fields, self.ref_qps)

    def write(self) -> None:
        """The sidecar: the whole record, the environment, each section's
        seconds and launches, the run's launches by kernel, and the kernel
        shapes of the codes and IVF steps with their launches."""
        total: dict = {}
        for counts in self.launches.values():
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
        full = {**self.result(), "env": self.env,
                "section_s": self.section_s,
                "wall_s": round(time.perf_counter() - self.t0, 3),
                "launches": total, "launches_by_section": self.launches,
                "kernel_shapes": self.shapes}
        try:
            with open(self.path, "w") as f:
                json.dump(full, f, indent=1)
        except OSError as e:
            log(f"sidecar write failed: {e!r}")


_SECTION_ORDER = ("kernel_parity", "oracle", "secondary", "capacity", "ivf",
                  "serving", "serving_codes")


def assemble(sections: dict, ref_qps=None) -> dict:
    """The bench record from the sections measured so far, in bench.py's
    order (bench.py:699-778): the headline, the median of its runs so far,
    then the gate, oracle, secondary, capacity, IVF, serving and 10M
    fields, the 10M IVF sweep flattened to its best point."""
    first = sections.get("recall", {})
    runs = sections.get("headline_first", {}).get("runs", []) + \
        sections.get("headline_last", {}).get("runs", [])
    out = {k: first[k] for k in ("metric",) if k in first}
    if runs:
        qps_vals = sorted(r[0] for r in runs)
        ms_vals = sorted(r[1] for r in runs)
        qps = qps_vals[len(qps_vals) // 2]
        spread = (qps_vals[-1] - qps_vals[0]) / qps
        out.update(value=round(qps, 1), unit="qps",
                   vs_baseline=round(qps / ref_qps, 3) if ref_qps else 1.0)
    out.update({k: first[k] for k in ("recall_at_10", "recall_at_100",
                                      "recall_at_10_refined") if k in first})
    if runs:
        out["batch_latency_ms"] = round(ms_vals[len(ms_vals) // 2], 3)
    out.update({k: first[k] for k in ("n", "config") if k in first})
    if runs:
        out["value_runs"] = [round(v, 1) for v in qps_vals]
        out["value_spread_pct"] = round(spread * 100, 1)
        if spread > 0.15:
            out["value_unstable"] = True
    for name in _SECTION_ORDER:
        out.update(sections.get(name, {}))
    if "build_s" in first:
        out["build_s"] = first["build_s"]
    out.update(sections.get("tenm", {}))
    sweep = out.get("tenm_ivf_sweep")
    if sweep:
        best = max(sweep, key=lambda s: s["qps"])
        out["tenm_ivf_qps"] = best["qps"]
        out["tenm_ivf_visit"] = best["visit"]
        out["tenm_ivf_recall_at_k"] = best["recall_at_k"]
        tx = out.get("tenm_qps")
        if tx:
            out["tenm_ivf_all_beat_exhaustive"] = bool(
                min(s["qps"] for s in sweep if s["visit"] <= 0.1) > tx)
    return out


def exit_status(out: dict) -> int:
    """1 where a section failed (an ``_error`` field) or the kernel gate
    found a kernel that disagrees with its plain version, else 0."""
    failed = any(k.endswith("_error") for k in out)
    return 1 if failed or out.get("kernel_parity_ok") is False else 0


# ---------------------------------------------------------------------------
# Sections
# ---------------------------------------------------------------------------

def sweep_offered_rates(run_rate, rate_max: float):
    """bench.py:163-185's sweep: offered rates doubling from 2000/s while
    the server keeps up (achieved ≥ 97% of offered) up to ``rate_max``,
    then one midpoint probe between the knee and the first failure while
    that failure lies more than 1.26× above the knee. ``run_rate(rate)``
    gives (achieved, p50_ms, p95_ms). Returns (knee or None, the points)."""
    rates = [2000.0]
    knee = None
    results = []
    while rates:
        rate = rates.pop(0)
        ach, p50, p95 = run_rate(rate)
        sustained = ach >= 0.97 * rate
        results.append({"offered": rate, "achieved": round(ach, 1),
                        "p50_ms": round(p50, 2), "p95_ms": round(p95, 2),
                        "sustained": sustained})
        log(f"serving sweep: offered {rate:.0f} achieved {ach:.0f} "
            f"p50={p50:.1f}ms p95={p95:.1f}ms"
            f"{' (knee passed)' if sustained else ' (saturated)'}")
        if sustained:
            knee = rate
            if rate >= rate_max:
                break
            rates = [min(rate * 2, rate_max)]
        elif knee is not None and rate > knee * 1.26:
            rates = [round((knee + rate) / 2, -2)]  # one refinement probe
        else:
            break
    return knee, results


def serving_knee_fields(args, idx, queries, backend="decoded", prefix=""):
    """bench.py:117-211: the offered-load sweep to the knee on one warm
    ``SearchServer`` (8 submitter threads, 4096 single-row requests a
    rate), p50/p95 at ~80% of the knee, and the bare device step at the
    server's batch size (``serving_onchip_batch_ms``)."""
    from vaq_tpu_torch.serving import SearchServer

    srv = SearchServer(idx, k=args.k, max_batch=256,
                       max_wait_ms=args.serving_wait_ms,
                       pipeline_depth=args.serving_depth, backend=backend)
    try:
        srv.search(queries[0])  # warm the path

        def run_rate(rate, n_off=4096):
            offered = queries[np.arange(n_off) % queries.shape[0]]
            n_threads = 8
            per = n_off // n_threads
            spacing = n_threads / rate
            futs = [None] * n_off
            srv.stats.reset()
            t0 = time.perf_counter()

            def submitter(t):
                for j in range(per):
                    i = t * per + j
                    target = t0 + j * spacing + t * spacing / n_threads
                    while True:
                        dt = target - time.perf_counter()
                        if dt <= 0:
                            break
                        time.sleep(min(dt, 0.0005))
                    futs[i] = srv.submit(offered[i])

            threads = [threading.Thread(target=submitter, args=(t,))
                       for t in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            for f in futs:
                f.result(timeout=120)
            wall = time.perf_counter() - t0
            lat = srv.stats.summary()
            return n_off / wall, lat.get("p50_ms"), lat.get("p95_ms")

        knee, results = sweep_offered_rates(run_rate, args.serving_rate_max)
        fields = {f"{prefix}serving_sweep": results}
        if knee is not None:
            fields[f"{prefix}serving_knee_qps"] = knee
            ach, p50, p95 = run_rate(round(0.8 * knee, -2))
            fields[f"{prefix}serving_qps"] = round(ach, 1)
            fields[f"{prefix}serving_p50_ms"] = round(p50, 2)
            fields[f"{prefix}serving_p95_ms"] = round(p95, 2)
            log(f"serving @80% of knee ({0.8 * knee:.0f}): achieved "
                f"{ach:.0f}, p50={p50:.1f}ms p95={p95:.1f}ms")
            qb = torch.as_tensor(queries[: srv.max_batch], device=idx.device)
            _, onchip_ms = measure_qps(
                lambda q: idx.search_device(q, args.k, backend=backend),
                qb, srv.max_batch, 16)
            fields[f"{prefix}serving_onchip_batch_ms"] = round(onchip_ms, 2)
            log(f"device batch latency at max_batch={srv.max_batch}: "
                f"{onchip_ms:.2f} ms (p50 − this = batching and fetch)")
        nb = max(srv.batches_served, 1)
        log(f"serving totals: fill={srv.sum_fill / nb:.0f}/{srv.max_batch}, "
            f"fetch={srv.sum_fetch_s / nb * 1000:.1f}ms/batch, {nb} batches")
    finally:
        srv.close()
    return fields


def oracle_fields(args, base, queries, cache_dir, dev):
    """bench.py:214-268: engine-vs-oracle recall on a slice of the base.
    The oracle (``tests/oracle_ref.py``, a numpy transliteration of the
    reference's VAQ.cpp train → encode → searchSort) and the engine run the
    same config on the same rows; recall is against exact groundtruth on
    the slice. The oracle runs on the host and is slow, so its recall is
    cached per (n, d, queries, config)."""
    from vaq_tpu_torch.io import pad_dims
    from vaq_tpu_torch.ops.distances import exact_search

    n_o = min(args.n, args.oracle_n)
    sub = base[:n_o]
    k = args.k
    _, gt = exact_search(torch.as_tensor(queries, device=dev),
                         torch.as_tensor(sub, device=dev), k)
    gt = gt.cpu().numpy()

    cfg = vaq_tpu_torch.parse_method_string(args.config)
    eng = vaq_tpu_torch.VAQIndex(cfg, device=dev).train(sub).encode(sub)
    _, lab = eng.search(queries, k)
    eng_rec = metrics.avg_recall(lab, gt, k)

    ocache = os.path.join(cache_dir,
                          f"oracle_n{n_o}_d{args.d}_q{queries.shape[0]}_"
                          f"{dev.type}_{args.config.replace(',', '_')}.json")
    if os.path.exists(ocache) and not args.no_cache:
        with open(ocache) as f:
            orec = json.load(f)["oracle_recall"]
        log(f"oracle recall loaded from cache: {orec:.4f}")
    else:
        sys.path.insert(0, os.path.join(HERE, "tests"))
        from oracle_ref import OracleVAQ
        t0 = time.perf_counter()
        o = OracleVAQ(cfg.bit_budget, cfg.subspace_num, cfg.min_bits,
                      cfg.max_bits, var=cfg.percent_var_explained,
                      seed=cfg.seed)
        sub_p = pad_dims(sub, cfg.subspace_num)
        q_p = pad_dims(queries, cfg.subspace_num)
        o.train(sub_p).encode(sub_p)
        _, olab = o.search(q_p, k)
        orec = metrics.avg_recall(olab, gt, k)
        with open(ocache, "w") as f:
            json.dump({"oracle_recall": round(orec, 4)}, f)
        log(f"oracle pipeline at n={n_o}: {time.perf_counter() - t0:.0f}s")
    log(f"oracle parity: engine {eng_rec:.4f} vs oracle {orec:.4f} "
        f"(Δ={eng_rec - orec:+.4f}) at n={n_o}")
    return {"oracle_n": n_o,
            "oracle_recall_at_k": round(float(orec), 4),
            "engine_oracle_slice_recall_at_k": round(float(eng_rec), 4),
            "oracle_delta_recall": round(float(eng_rec - orec), 4)}


def ivf_sweep(idx, state, qb, queries, gt, visits, k, batch, iters, tag=""):
    """One IVF build's visit sweep (bench.py:650-666, :358-372): QPS of one
    batch and recall over every query, per visit fraction. The port's
    ``IVFSearcher.search`` is exact (JAX's bench calls ``exact=False``)."""
    from vaq_tpu_torch.ivf import IVFSearcher

    ev = torch.as_tensor(idx.eigvecs, device=idx.device)
    qp_b = pca.project(qb, ev, idx.total_dim)
    qp_all = pca.project(torch.as_tensor(queries, device=idx.device), ev,
                         idx.total_dim)
    results = []
    for visit in visits:
        searcher = IVFSearcher(state, visit)
        v_qps, v_ms = measure_qps(
            lambda q, s=searcher: s.search(idx, qp_b, k), qb, batch, iters)
        _, l_iv = searcher.search(idx, qp_all, k)
        v_rec = metrics.avg_recall(l_iv.cpu().numpy(), gt, k)
        results.append({"visit": visit, "qps": round(v_qps, 1),
                        "ms": round(v_ms, 3), "recall_at_k": round(v_rec, 4)})
        log(f"{tag}ivf QPS={v_qps:.1f} ({v_ms:.3f}ms/batch) "
            f"recall@{k}={v_rec:.4f} (visit={visit})")
    return results


def second_scale_fields(args, cache_dir, dev, src_tag):
    """bench.py:271-377: the codes tier, the exhaustive decoded tier and
    the IVF visit sweep at ``--second-n`` rows. Rows come from
    ``data.DeviceChunkSource``, made on the device chunk by chunk (the
    port's torch generator: not JAX's rows); only the groundtruth is
    cached."""
    from vaq_tpu_torch.data import DeviceChunkSource
    from vaq_tpu_torch.ivf import build_ivf
    from vaq_tpu_torch.ops.distances import exact_search_chunked

    n2, d, chunk = args.second_n, args.d, 2_000_000
    tag = f"[{n2 / 1e6:g}M] "
    cfg = vaq_tpu_torch.parse_method_string(args.config)
    src = DeviceChunkSource(n2, d, chunk, device=dev)
    queries = src.queries(args.queries)

    t0 = time.perf_counter()
    idx = vaq_tpu_torch.VAQIndex(cfg, device=dev).train(
        src.host_sample(262_144))
    idx.encode_chunks(src.chunk, n2, chunk)
    _sync(dev)
    build_s = time.perf_counter() - t0
    log(f"{tag}build (streamed): {build_s:.0f}s")

    gt_cache = os.path.join(cache_dir, f"gt_dev_n{n2}_d{d}_q{args.queries}"
                                       f"_c{chunk}_{src_tag}.npy")
    if os.path.exists(gt_cache) and not args.no_cache:
        gt = np.load(gt_cache)
        log(f"{tag}groundtruth loaded from cache")
    else:
        t0 = time.perf_counter()
        _, gt = exact_search_chunked(queries, src.chunk, n2, chunk, 100,
                                     device=dev)
        np.save(gt_cache, gt)
        log(f"{tag}groundtruth (streamed exact): "
            f"{time.perf_counter() - t0:.0f}s")

    qb = torch.as_tensor(queries[: args.batch], device=dev)
    iters_slow = max(2, args.iters // 4)
    fields = {"tenm_n": n2, "tenm_build_s": round(build_s, 1)}

    qps_c, ms_c = measure_qps(
        lambda q: idx.search_device(q, args.k, backend="codes"),
        qb, args.batch, iters_slow)
    _, lab = idx.search(queries, args.k, backend="codes")
    rec_c = metrics.avg_recall(lab, gt, args.k)
    log(f"{tag}codes QPS={qps_c:.1f} ({ms_c:.3f}ms/batch) "
        f"recall@{args.k}={rec_c:.4f}")
    fields["tenm_codes_qps"] = round(qps_c, 1)
    fields["tenm_codes_recall_at_k"] = round(rec_c, 4)

    # the exhaustive decoded bf16 scan: the IVF comparison point
    qps_x, ms_x = measure_qps(lambda q: idx.search_device(q, args.k),
                              qb, args.batch, args.iters)
    _, lab = idx.search(queries, args.k)
    rec_x = metrics.avg_recall(lab, gt, args.k)
    log(f"{tag}exhaustive QPS={qps_x:.1f} ({ms_x:.3f}ms/batch) "
        f"recall@{args.k}={rec_x:.4f}")
    fields["tenm_qps"] = round(qps_x, 1)
    fields["tenm_recall_at_k"] = round(rec_x, 4)

    # guarded, as bench.py's, so that an IVF failure keeps the fields above
    try:
        visits = [float(v) for v in str(args.ivf_visit_10m).split(",")]
        t0 = time.perf_counter()
        state = build_ivf(idx, ti_cluster_num=args.ivf_clusters,
                          ti_segment_num=16)
        _sync(dev)
        log(f"{tag}ivf build ({args.ivf_clusters} clusters): "
            f"{time.perf_counter() - t0:.0f}s")
        fields["tenm_ivf_sweep"] = ivf_sweep(
            idx, state, qb, queries, gt, visits, args.k, args.batch,
            iters_slow, tag)
    except Exception as e:  # noqa: BLE001 — keep the fields measured above
        log(f"{tag}ivf subsection failed: {e!r}")
        fields["tenm_ivf_error"] = repr(e)
    return fields


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    args = parser().parse_args(argv)
    dev = resolve(args.device)

    from vaq_tpu_torch.ops.distances import (exact_search,
                                             exact_search_host_stream)

    cache_dir = os.path.join(HERE, ".bench_cache", "torch")
    os.makedirs(cache_dir, exist_ok=True)
    env = environment(dev)
    log(f"device: {env['device_name']}; nvidia-smi: {env['nvidia_smi']}; "
        f"torch {env['torch']}, CUDA {env['torch_cuda']}")
    ref_qps = None
    bl_path = os.path.join(HERE, "baseline_measured.json")
    if os.path.exists(bl_path):
        with open(bl_path) as f:
            ref_qps = json.load(f).get("reference_qps")
    rec = Record(os.path.join(cache_dir, "last_full.json"), env, ref_qps)
    # what the port computed is cached per device and per source tree, so
    # a parent commit's index is never timed as the change's
    src_tag = f"{dev.type}_{source_hash()}"
    rng_tag = f"n{args.n}_d{args.d}_{args.config.replace(',', '_')}"
    cfg = vaq_tpu_torch.parse_method_string(args.config)

    def build():
        cache = os.path.join(cache_dir, f"{rng_tag}_{src_tag}.npz")
        if os.path.exists(cache) and not args.no_cache:
            log(f"loaded cached index {cache}")
            return vaq_tpu_torch.VAQIndex.load(cache, device=dev), None
        t0 = time.perf_counter()
        # the build's progress lines go to stderr: stdout is the one line
        with contextlib.redirect_stdout(sys.stderr):
            idx = vaq_tpu_torch.VAQIndex(cfg, device=dev).build(
                base, verbose=True)
        _sync(dev)
        build_s = time.perf_counter() - t0
        log(f"build: {build_s:.1f}s")
        idx.save(cache)
        return idx, build_s

    def groundtruth():
        gt_cache = os.path.join(cache_dir,
                                f"{rng_tag}_gt{args.queries}_{src_tag}.npy")
        if os.path.exists(gt_cache) and not args.no_cache:
            log("groundtruth loaded from cache")
            return np.load(gt_cache)
        t0 = time.perf_counter()
        if args.n > 4_000_000:   # keep device memory O(chunk) at scale
            _, gt = exact_search_host_stream(queries, base, 100, device=dev)
        else:
            _, gt = exact_search(torch.as_tensor(queries, device=dev),
                                 torch.as_tensor(base, device=dev), 100)
            gt = gt.cpu().numpy()
        np.save(gt_cache, gt)
        log(f"groundtruth: {time.perf_counter() - t0:.1f}s")
        return gt

    if dev.type == "cuda":
        # nvcc builds the kernels at their first launch: here, so that no
        # section's wall holds it
        from vaq_tpu_torch import _build
        t0 = time.perf_counter()
        _build.library()
        rec.section_s["kernel_build"] = round(time.perf_counter() - t0, 3)
    t0 = time.perf_counter()
    base, queries = bench_data(cache_dir, args.n, args.d, args.queries,
                               not args.no_cache)
    idx, build_s = build()
    gt = groundtruth()
    rec.section_s["data_build_groundtruth"] = round(time.perf_counter() - t0,
                                                    3)
    qb = torch.as_tensor(queries[: args.batch], device=dev)

    def recall_section():
        # recall over the full query set, one pass, and refine 100 → 10
        # (the reference's Fig. 10-style configuration)
        _, labels = idx.search(queries, 100, query_batch=args.batch)
        recall10 = metrics.avg_recall(labels[:, :10], gt, 10)
        recall100 = metrics.avg_recall(labels, gt, 100)
        _, refined = idx.refine(queries, labels, base, 10)
        recall10_refined = metrics.avg_recall(refined, gt, 10)
        log(f"recall@10={recall10:.4f} recall@100={recall100:.4f} "
            f"refined@10={recall10_refined:.4f}")
        fields = {
            "metric": (f"ADC search QPS/chip ({args.n / 1e6:g}M x {args.d}d, "
                       f"{cfg.bit_budget}-bit VAQ)"),
            "recall_at_10": round(recall10, 4),
            "recall_at_100": round(recall100, 4),
            "recall_at_10_refined": round(recall10_refined, 4),
            "n": args.n, "config": args.config}
        if build_s is not None:
            fields["build_s"] = round(build_s, 1)
        return fields

    rec.section("recall", recall_section, guard=False)

    def measure(step_fn, iters):
        return measure_qps(step_fn, qb, args.batch, iters)

    # the headline, the decoded bf16 tier: five runs spread across the run
    # (two here, three after the other sections), reported as their median
    def headline(count):
        return lambda: {"runs": [
            measure(lambda q: idx.search_device(q, args.k), args.iters)
            for _ in range(count)]}

    runs = rec.section("headline_first", headline(2), guard=False)["runs"]
    log(f"QPS={runs[-1][0]:.1f}  batch latency={runs[-1][1]:.3f}ms "
        f"(marginal)")

    def kernel_section():
        from vaq_tpu_torch.ops.kernel_check import kernel_parity_fields
        fields = kernel_parity_fields(idx, queries)
        log(f"kernel parity: {fields}")
        return fields

    def secondary_section():
        from vaq_tpu_torch.binary import (BinaryIndex, hamming_topk_matmul,
                                          unpack_bits_01)
        qps8, ms8 = measure(
            lambda q: idx.search_device(q, args.k, backend="decoded8"),
            args.iters)
        log(f"decoded8 QPS={qps8:.1f} ({ms8:.3f}ms/batch)")
        bidx = BinaryIndex(bit_budget=256, device=dev).train(
            base[: min(args.n, 200000)]).encode(base)
        qpk = torch.as_tensor(unpack_bits_01(bidx.encode_queries(
            queries[: args.batch]), bidx.total_bits), device=dev)
        qps_h, ms_h = measure(
            lambda q: hamming_topk_matmul(bidx.db01, bidx.db_pop, qpk,
                                          args.k), args.iters)
        log(f"hamming QPS={qps_h:.1f} ({ms_h:.3f}ms/batch)")
        return {"decoded8_qps": round(qps8, 1),
                "hamming_qps": round(qps_h, 1)}

    def capacity_section():
        # the codes tier (K1/K2) on the headline index, then on a <=4-bit
        # FAST-config index (the reference's FAST family constraint,
        # VAQ.cpp:1263-1266): the codes tier there too, K1/K2 at C = 16,
        # not the FAST scan K3 (bench.py:614-628 reads it so)
        # each index's shape at the timed batch, with the launches there
        before = kernel_launches()
        codes_qps, codes_ms = measure(
            lambda q: idx.search_device(q, args.k, backend="codes"),
            max(2, args.iters // 2))
        rec.shapes["codes"] = {**codes_shape(idx, args.batch, args.k),
                               "launches": launches_since(before)}
        _, lab = idx.search(queries, args.k, backend="codes")
        codes_rec = metrics.avg_recall(lab, gt, args.k)
        log(f"codes(decode-dot) QPS={codes_qps:.1f} ({codes_ms:.3f}ms/batch) "
            f"recall@{args.k}={codes_rec:.4f}")

        fast_cfg_s = f"VAQ{args.d * 2}m{args.d // 2}min1max4var1,FAST"
        fast_cache = os.path.join(
            cache_dir, f"n{args.n}_d{args.d}_"
                       f"{fast_cfg_s.replace(',', '_')}_{src_tag}.npz")
        if os.path.exists(fast_cache) and not args.no_cache:
            fidx = vaq_tpu_torch.VAQIndex.load(fast_cache, device=dev)
        else:
            fidx = vaq_tpu_torch.VAQIndex(
                vaq_tpu_torch.parse_method_string(fast_cfg_s),
                device=dev).build(base)
            fidx.save(fast_cache)
        before = kernel_launches()
        fast4_qps, fast4_ms = measure(
            lambda q: fidx.search_device(q, args.k, backend="codes"),
            max(2, args.iters // 2))
        rec.shapes["fast4"] = {**codes_shape(fidx, args.batch, args.k),
                               "launches": launches_since(before)}
        _, lab = fidx.search(queries, args.k, backend="codes")
        fast4_rec = metrics.avg_recall(lab, gt, args.k)
        log(f"fast(codes tier, max4bit) QPS={fast4_qps:.1f} "
            f"({fast4_ms:.3f}ms/batch) recall@{args.k}={fast4_rec:.4f} "
            f"[{fast_cfg_s}]")
        return {"codes_qps": round(codes_qps, 1),
                "codes_recall_at_k": round(codes_rec, 4),
                "fast4_qps": round(fast4_qps, 1),
                "fast4_recall_at_k": round(fast4_rec, 4)}

    def ivf_section():
        from vaq_tpu_torch.ivf import build_ivf

        visits = [float(v) for v in str(args.ivf_visit).split(",")]
        # the IVF path reads no int8 tier: free it first (build_ivf makes
        # its own int8 scales from the centroids)
        idx.decoded8 = idx.decoded8_scales = idx.decoded8_norms = None
        t0 = time.perf_counter()
        state = build_ivf(idx, ti_cluster_num=args.ivf_clusters,
                          ti_segment_num=16)
        _sync(dev)
        log(f"ivf build ({args.ivf_clusters} clusters): "
            f"{time.perf_counter() - t0:.1f}s")
        # the timed batches and the recall pass over all --queries (one
        # batch of the same shape at the defaults)
        before = kernel_launches()
        results = ivf_sweep(idx, state, qb, queries, gt, visits, args.k,
                            args.batch, max(2, args.iters // 4))
        rec.shapes["ivf"] = {
            "visits": [ivf_shape(state, v, args.batch, args.k)
                       for v in visits],
            "launches": launches_since(before)}
        fields = {"ivf_qps": results[0]["qps"],
                  "ivf_recall_at_k": results[0]["recall_at_k"],
                  "ivf_visit": results[0]["visit"]}
        if len(results) > 1:
            fields["ivf_sweep"] = results
        return fields

    if not args.no_kernel_check:
        rec.section("kernel_parity", kernel_section)
    if not args.no_secondary:
        rec.section("secondary", secondary_section)
    if not args.no_capacity:
        rec.section("capacity", capacity_section)
    if not args.no_ivf:
        rec.section("ivf", ivf_section)
    if not args.no_serving:
        rec.section("serving",
                    lambda: serving_knee_fields(args, idx, queries))
        # one codes-tier serving point: the capacity tier under the same
        # server
        rec.section("serving_codes",
                    lambda: serving_knee_fields(args, idx, queries,
                                                backend="codes",
                                                prefix="codes_"))
    if not args.no_oracle and args.oracle_n:
        rec.section("oracle",
                    lambda: oracle_fields(args, base, queries, cache_dir,
                                          dev))

    rec.section("headline_last", headline(3), guard=False)
    out = rec.result()
    log(f"headline runs: median {out['value']:.0f} QPS, "
        f"min {out['value_runs'][0]:.0f}, max {out['value_runs'][-1]:.0f} "
        f"(spread {out['value_spread_pct']:.1f}%)")

    # the second scale (10M by default), after the 1M state is freed; the
    # quick recipe (--n below 1M) skips it
    if args.second_n and args.second_n != args.n and not args.no_10m \
            and args.n >= 1_000_000:
        idx = qb = None
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        rec.section("tenm",
                    lambda: second_scale_fields(args, cache_dir, dev,
                                                src_tag))

    out = rec.result()
    rec.write()
    log(f"full bench record written to {rec.path}")
    print(slim_line(out))
    return exit_status(out)


if __name__ == "__main__":
    sys.exit(main())
