"""Spans, counters, serving statistics and the profiler hook.

The counterpart of ``vaq_tpu/profiling.py``, less JAX's ``PhaseTimer``: a
timer that synchronises the card at every phase's end changes what it
times, where a ``torch.profiler`` trace times each stage on the card's own
clock. The search path marks its stages with :func:`span` and counts the
probe's entries with :func:`count`; both cost one read of the profiler's
flag while no profiler records. ``LatencyStats`` is copied from JAX's;
``device_trace`` wraps a region in a ``torch.profiler`` trace, which holds
the spans and the kernels on one timeline.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List

import torch
from torch.profiler import record_function

# the profiler's flag for the calling thread: a ``record_function`` range
# reaches a profiler only on the thread that started it
_profiler_enabled = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()
# count()'s totals, one 0-d int64 tensor a name
_totals: Dict[str, torch.Tensor] = {}
_totals_lock = threading.Lock()


def recording() -> bool:
    """Whether a ``torch.profiler`` (or autograd profiler) records the
    calling thread."""
    return _profiler_enabled()


def span(name: str):
    """A ``record_function(name)`` range while a profiler records the
    calling thread, else one shared no-op context: with no profiler the cost
    is the flag read, and no range is made."""
    return record_function(name) if _profiler_enabled() else _OFF


def count(name: str, n: torch.Tensor) -> None:
    """Add the 0-d tensor ``n`` to the total ``name`` on ``n``'s device,
    without waiting for it, while :func:`recording`; nothing otherwise."""
    if not _profiler_enabled():
        return
    with _totals_lock:
        if name not in _totals:
            _totals[name] = n.new_zeros((), dtype=torch.int64)
        _totals[name].add_(n)


def counters() -> Dict[str, int]:
    """The totals of :func:`count` as ints: one wait for the device, here
    only."""
    with _totals_lock:
        return {name: int(t) for name, t in _totals.items()}


def reset_counters() -> None:
    """Forget every total."""
    with _totals_lock:
        _totals.clear()

@dataclass
class LatencyStats:
    """Rolling query-latency statistics → QPS / p50 / p95 / p99.

    Samples may be end-to-end latencies of *overlapping* requests (the
    serving pipeline keeps several batches in flight), so throughput is
    computed from the wall-clock span of record() calls, never from the sum
    of latencies."""

    samples: List[float] = field(default_factory=list)
    queries: int = 0
    _first_t: float = 0.0
    _last_t: float = 0.0

    def reset(self) -> None:
        """Clear samples (e.g. between offered-load sweep points)."""
        self.samples.clear()
        self.queries = 0
        self._first_t = self._last_t = 0.0

    def record(self, seconds: float, n_queries: int = 1) -> None:
        now = time.perf_counter()
        if not self.samples:
            self._first_t = now
        self._last_t = now
        self.samples.append(seconds)
        self.queries += n_queries

    def summary(self) -> Dict[str, float]:
        if not self.samples:
            return {}
        s = sorted(self.samples)
        span = self._last_t - self._first_t

        def pct(p):
            return s[min(len(s) - 1, int(p * len(s)))] * 1000.0

        return {
            "qps": self.queries / span if span > 0 else float(self.queries),
            "p50_ms": pct(0.50),
            "p95_ms": pct(0.95),
            "p99_ms": pct(0.99),
            "batches": len(s),
            "queries": self.queries,
        }


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the region (host, and the card
    where there is one) into ``log_dir/trace.json`` (chrome://tracing,
    Perfetto): the program's spans and the kernels on one timeline, while
    :func:`count` adds to :func:`counters`. Yields the profiler, whose
    ``key_averages()`` sums the time by operator and by span."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
