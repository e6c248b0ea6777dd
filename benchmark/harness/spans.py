"""The program's own spans in a traced window: a stage's device time a
batch, and the device's idle time by the span the host was in.

The port marks its stages with ``profiling.span`` ranges named
``index.*``, ``decoded.*``, ``codes.*``, ``ivf.*`` and ``fast.*``. The
profiler puts each range on the host timeline (``Trace.host_ops``) and, for
the operations launched inside it, on the device timeline
(``Trace.device_ranges``), both on one clock; ``trace.in_range_s`` sums a
stage's device time. Every function here reads nothing where its ranges are
absent, as in a trace of a program without them.
"""

from __future__ import annotations

import heapq

from benchmark.harness import trace as trace_mod

PROGRAM_PREFIXES = ("index.", "decoded.", "codes.", "ivf.", "fast.")
HARNESS_BATCH = "bench.search_batch"


def _ranges(spans, name: str, lo: float, hi: float) -> list:
    """Merged (start, end) intervals of the instances of ``name`` that
    start inside [lo, hi)."""
    return trace_mod.union(sorted((a, b) for n, a, b in spans
                                  if n == name and lo <= a < hi))


def per_batch_ms(ctx, seconds: float):
    """``seconds`` of the window as ms a batch; None where no batch ran."""
    batches = ctx["window"].get("batches")
    if not batches:
        return None
    return 1e3 * seconds / batches


def idle_intervals(tr) -> list:
    """The window's (start, end) stretches with nothing running on the
    device: the complement of the union of its operations, as
    ``trace.idle_share`` counts it."""
    busy = trace_mod.union(trace_mod._clip(tr.device_ops, tr.t0, tr.t1))
    gaps, prev = [], tr.t0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if tr.t1 > prev:
        gaps.append((prev, tr.t1))
    return gaps


def intersect(xs: list, ys: list) -> list:
    """The intersection of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def innermost(spans) -> list:
    """Disjoint (start, end, name) pieces of the time the host ``spans``
    (name, start, end) cover, each named by the span open there that
    started last, of two that started together the one that ends first
    (the innermost of nested spans)."""
    events = sorted([(a, 1, i) for i, (_, a, _) in enumerate(spans)]
                    + [(b, 0, i) for i, (_, _, b) in enumerate(spans)])
    heap, closed, out = [], set(), []
    prev = None
    for t, opening, i in events:
        while heap and heap[0][2] in closed:
            heapq.heappop(heap)
        if heap and prev is not None and t > prev:
            out.append((prev, t, spans[heap[0][2]][0]))
        if opening:
            heapq.heappush(heap, (-spans[i][1], spans[i][2], i))
        else:
            closed.add(i)
        prev = t
    return out


def api_idle(tr):
    """(device-idle seconds inside a host ``index.search`` span, {name:
    idle seconds} by the innermost program span open or, outside
    ``index.search``, the harness's ``bench.search_batch`` / ``bench.window``
    range); None where the trace has no ``index.search`` span or no device
    operation."""
    calls = _ranges(tr.host_ops, "index.search", tr.t0, tr.t1)
    if not calls or not tr.device_ops:
        return None
    idle = idle_intervals(tr)
    inside = sum(b - a for a, b in intersect(idle, calls)) / 1e6
    named = [(n, max(a, tr.t0), min(b, tr.t1)) for n, a, b in tr.host_ops
             if b > tr.t0 and a < tr.t1 and
             (n.startswith(PROGRAM_PREFIXES) or n == HARNESS_BATCH)]
    named.append((trace_mod.WINDOW_RANGE, tr.t0, tr.t1))
    split = {}
    pieces = innermost(named)
    j = 0
    for a, b in idle:
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            lo, hi = max(a, pieces[k][0]), min(b, pieces[k][1])
            if hi > lo:
                split[pieces[k][2]] = split.get(pieces[k][2], 0.0) \
                    + (hi - lo) / 1e6
            k += 1
    return inside, split


def api_idle_ms(ctx, cell_name: str):
    """The reader of ``api.idle_ms.<cell>``: device-idle ms a batch inside
    ``index.search``; logs the idle ms a batch by span."""
    from benchmark.harness.cell import log
    got = api_idle(ctx["trace"])
    batches = ctx["window"].get("batches")
    if got is None or not batches:
        return None
    inside, split = got
    log(f"api.idle_ms.{cell_name} by span, ms a batch: " + ", ".join(
        f"{n} {1e3 * s / batches:.4f}"
        for n, s in sorted(split.items(), key=lambda kv: -kv[1])))
    return 1e3 * inside / batches
