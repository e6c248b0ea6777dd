"""The traced slice of a window, reduced from ``torch.profiler`` events kept
in memory (no trace file is written).

A :class:`Trace` holds three lists of ``(name, start_us, end_us)``: the
operations that ran on the device (kernels, copies, sets), the program's
``record_function`` ranges as the device timeline places them, and the
host's operations; and the window's bounds on the same clock.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Iterable, Optional

WINDOW_RANGE = "bench.window"
# host events of the profiler's own bookkeeping, which name no work
PROFILER_OWN = ("Activity Buffer Request",)


@dataclasses.dataclass
class Trace:
    device_ops: list
    device_ranges: list
    host_ops: list
    t0: float
    t1: float

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6


def from_profiler(prof) -> Trace:
    """Sort the profiler's events; the window is the host span of the
    harness's own ``bench.window`` range."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    dev_ops, dev_ranges, host = [], [], []
    t0 = t1 = None
    for ev in prof.events():
        span = (ev.name, float(ev.time_range.start), float(ev.time_range.end))
        if ev.device_type == cuda:
            if getattr(ev, "is_user_annotation", False):
                dev_ranges.append(span)
            else:
                dev_ops.append(span)
        else:
            if ev.name == WINDOW_RANGE:
                t0, t1 = span[1], span[2]
            host.append(span)
    if t0 is None:
        raise RuntimeError(f"the trace holds no {WINDOW_RANGE!r} range")
    return Trace(dev_ops, dev_ranges, host, t0, t1)


def _clip(spans: Iterable, lo: float, hi: float) -> list:
    out = []
    for _, a, b in spans:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            out.append((a, b))
    return sorted(out)


def union(intervals: list) -> list:
    """Merged (start, end) intervals of sorted ones."""
    merged = []
    for a, b in intervals:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def busy_s(tr: Trace) -> float:
    """Seconds of the window in which some operation ran on the device."""
    busy = union(_clip(tr.device_ops, tr.t0, tr.t1))
    return sum(b - a for a, b in busy) / 1e6


def idle_share(tr: Trace) -> float:
    """The share of the window with nothing running on the device."""
    return 1.0 - busy_s(tr) / tr.window_s


def idle_pct(ctx: dict):
    """A per-layer reader: the share of the traced window with nothing
    running on the device, in %; nothing where no operation ran."""
    tr = ctx["trace"]
    if not tr.device_ops:
        return None
    return 100.0 * idle_share(tr)


def in_range_s(tr: Trace, range_name: str) -> float:
    """Device seconds of the operations that start inside an instance of the
    program's range ``range_name`` on the device timeline (the attribution
    ``chip_smoke.py`` reads its ``ivf.*`` split by). The ranges' own spans
    hold the gaps between their operations, so they are not summed."""
    spans = sorted((a, b) for n, a, b in tr.device_ranges
                   if n == range_name and tr.t0 <= a < tr.t1)
    if not spans:
        return 0.0
    starts = [a for a, _ in spans]
    total = 0.0
    for _, a, b in tr.device_ops:
        i = bisect.bisect_right(starts, a) - 1
        if i >= 0 and a < spans[i][1]:
            total += b - a
    return total / 1e6


def range_count(tr: Trace, range_name: str) -> int:
    """How many instances of a range the device timeline holds in the
    window."""
    return sum(1 for n, a, _ in tr.device_ranges
               if n == range_name and tr.t0 <= a < tr.t1)


def op_time_s(tr: Trace, match) -> tuple[float, int]:
    """(device seconds, count) of the window's operations whose name
    ``match`` accepts."""
    total, count = 0.0, 0
    for n, a, b in tr.device_ops:
        if tr.t0 <= a < tr.t1 and match(n):
            total += b - a
            count += 1
    return total / 1e6, count


def top_device_ops(tr: Trace, top: int = 10) -> list:
    """[[name, seconds]] of the operations that took the most device time
    in the window, summed by name."""
    by = {}
    for n, a, b in _clip_named(tr.device_ops, tr.t0, tr.t1):
        by[n] = by.get(n, 0.0) + (b - a) / 1e6
    return [[n[:120], s] for n, s in
            sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def _clip_named(spans, lo, hi):
    for n, a, b in spans:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            yield n, a, b


def _innermost_host(host: list, t: float) -> Optional[str]:
    """The name of the shortest host operation open at ``t``."""
    best = None
    for n, a, b in host:
        if a <= t < b and n != WINDOW_RANGE and n not in PROFILER_OWN and \
                (best is None or b - a < best[1]):
            best = (n, b - a)
    return None if best is None else best[0]


def idle_gaps(tr: Trace, top: int = 10) -> list:
    """[[what the host was doing, seconds]] of the longest stretches of the
    window with nothing running on the device, each named by the innermost
    host operation open as it began."""
    busy = union(_clip(tr.device_ops, tr.t0, tr.t1))
    gaps, prev = [], tr.t0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if tr.t1 > prev:
        gaps.append((prev, tr.t1))
    gaps.sort(key=lambda g: g[0] - g[1])
    host = [h for h in tr.host_ops if h[1] < tr.t1 and h[2] > tr.t0]
    return [[(_innermost_host(host, a + 0.5) or "host, outside any op")[:120],
             (b - a) / 1e6] for a, b in gaps[:top]]
