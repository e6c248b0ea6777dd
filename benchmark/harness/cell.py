"""One run of one cell: make the rows, build the index, warm up, measure the
window, read the per-layer metrics, then judge the answers.

The order keeps each reading clean: the benchmark's own copies of the rows
leave the card before the window, so ``peak_gib`` is what the index and its
search hold; the process's peak (``memory_peak_bytes``) is read before the
reference runs; the reference runs after the program's state is freed, on
rows made again from the seed.
"""

from __future__ import annotations

import contextlib
import gc
import math
import statistics
import sys
import time

import numpy as np
import torch

from benchmark.harness import check, datagen, trace, variants

# the traced slice of a --trace 1 run (its window), seconds
TRACE_SECONDS = 3.0
# answers judged a run
SAMPLE = 2048
JAX_NAMES = ("jax", "jaxlib", "flax", "vaq_tpu")
# repeats of the host's calibration, whose median is recorded
CALIB_REPEATS = 5


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's
    or the JAX package's, compared whole."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in JAX_NAMES})


def host_calibration() -> dict:
    """Seconds that a fixed pure-Python loop and a fixed NumPy pass (a sort
    and a running sum of 2^20 doubles, one thread) take on this host, the
    median of ``CALIB_REPEATS`` each. The work is the same in every run and
    nothing compares it: it is recorded beside a run's readings, so that a
    later look at a spread of runs can tell the host's drift from the
    program's."""
    data = np.random.default_rng(0).standard_normal(1 << 20)
    py, nps = [], []
    for _ in range(CALIB_REPEATS):
        t = time.perf_counter()
        acc = 0
        for i in range(300_000):
            acc += i * i % 7
        py.append(time.perf_counter() - t)
        t = time.perf_counter()
        np.cumsum(np.sort(data))
        nps.append(time.perf_counter() - t)
    return {"python_s": statistics.median(py),
            "numpy_s": statistics.median(nps)}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _set_precision() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _profiled(dev: torch.device):
    """(a guard that profiles the window inside a ``bench.window`` range, a
    holder of the profiler once it has stopped)."""
    held = {}

    @contextlib.contextmanager
    def guard():
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(trace.WINDOW_RANGE):
                yield
                _sync(dev)
        held["prof"] = prof

    return guard, held


def run_cell(cell, seed: int, seconds: float, traced: bool, device="cuda",
             t_start: float | None = None, variant=None) -> dict:
    """The result line's fields (``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, ``breakdown``, ``checks``) and what is printed
    before it (``notes``)."""
    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    _set_precision()
    cfg, k = cell.config, int(cell.config["k"])
    traffic = variants.traffic_of(cell.traffic, cell.limits, variant)
    notes = {}

    base, queries = datagen.make_rows(cfg["n"], cfg["d"], cfg["n_queries"],
                                      seed, dev)
    rows_sum = datagen.checksum(base)
    train_ids = datagen.train_rows(cfg["n"], cfg["train_rows"], seed, dev)
    queries_h = queries.cpu().numpy()
    del queries
    t_rows = time.perf_counter()
    idx = cell.system.build(cell, base, train_ids, dev, variant)
    _sync(dev)
    notes["build_s"] = time.perf_counter() - t_rows
    variants.after_build(idx, variant)
    del base
    gc.collect()
    if dev.type == "cuda":
        # before the warm-up, so that the blocks the window needs stay cached
        torch.cuda.empty_cache()
    loop = cell.loop.make(idx, queries_h, traffic, k, seed)
    loop.warm()
    _sync(dev)
    setup_peak = 0
    if dev.type == "cuda":
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    guard, held = _profiled(dev) if traced else (contextlib.nullcontext, {})
    win = loop.window(min(seconds, TRACE_SECONDS) if traced else seconds,
                      guard)
    if dev.type == "cuda":
        window_peak = torch.cuda.max_memory_allocated(dev)
        memory_peak = max(setup_peak, window_peak)
    else:
        window_peak = memory_peak = 0
    gc.unfreeze()
    notes["window"] = win

    metrics, breakdown, dev_extra = {}, None, {}
    if traced:
        tr = trace.from_profiler(held.pop("prof"))
        ctx = {"trace": tr, "window": win, "loop": loop, "config": cfg,
               "traffic": traffic, "index": idx, "queries": queries_h,
               "k": k}
        for m in cell.per_layer:
            value = m.reader(ctx)
            if value is not None:
                metrics[m.name] = {"value": value, "unit": m.unit}
        dev_extra = {"busy_s": trace.busy_s(tr), "window_s": tr.window_s}
        breakdown = {"device_ops": trace.top_device_ops(tr),
                     "idle_gaps": trace.idle_gaps(tr)}
        del tr, ctx
    else:
        # a metric named "<quantity>.<cells>" is that quantity in its cells
        e2e = {**win, "peak_gib": window_peak / 2**30, "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m.name] = {"value": e2e[m.name.split(".")[0]],
                               "unit": m.unit}

    rng = np.random.default_rng([seed % (1 << 64), 3])
    answers = loop.sample(rng, SAMPLE)
    attempted = win.get("queries", win.get("requests"))
    loop.close()
    state = cell.system.state(idx)
    del idx, loop
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    base, queries = datagen.make_rows(cfg["n"], cfg["d"], cfg["n_queries"],
                                      seed, dev)
    nums, info = cell.system.numbers(
        state, answers, base, queries, train_ids, seed, k, cfg,
        cell.limits["control"] if variant == "control" else None)
    nums["rows_remade"] = 0 if datagen.checksum(base) == rows_sum else 1
    notes["reference_s"] = time.perf_counter() - t_ref
    notes.update(info)
    correct, table = check.verdict(nums, cell.limits)
    # outside set-up and the window, after the check
    notes["host_calib"] = host_calibration()

    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(memory_peak),
                   **dev_extra}
    line = {"correct": bool(correct), "attempted": int(attempted),
            "failed": int(nums["failed"]), "metrics": metrics,
            "device": device_info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = table
    return {"line": line, "notes": notes, "numbers": nums}


def jsonable(x):
    """``x`` with every float that is not finite written as a string, so
    that the line is strict JSON."""
    if isinstance(x, dict):
        return {k: jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [jsonable(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    return x


def report(out: dict) -> None:
    """What the run saw, on standard error, with the numbers compared and
    their limits as the last lines."""
    notes = out["notes"]
    win = notes["window"]
    log("window: " + ", ".join(f"{k} {v}" for k, v in win.items()))
    for key in ("build_s", "reference_s", "answers_checked", "recall_at_k",
                "adc_recall_ceiling", "bits", "recon_error", "clusters",
                "bad_state_by_kind", "host_calib"):
        if key in notes:
            log(f"{key} {notes[key]}")
    for name, m in out["line"]["metrics"].items():
        log(f"metric {name} {m['value']} {m['unit']}")
    log(f"correct {out['line']['correct']}")
    for name, c in out["line"]["checks"].items():
        log(f"check {name} {c['value']} limit {c['limit']}")
