"""``ClosedBatch``: the closed loop of query batches that the ``closed_batch``
kind of traffic (``loops/closed_batch.py``) drives, kept here so that other
kinds of traffic can build on it.

Back-to-back ``VAQIndex.search`` calls on successive ``query_batch``-query
batches of the query set, cycling through it, host arrays in and out. The
loop warms up the shapes it will use, then runs ``window(seconds)`` inside
``guard`` (the harness's profiler and its ``bench.window`` range); the
window ends when the last batch's answers are on the host, and the rate is
all the queries answered over all of its seconds. It keeps every answer, so
that a sample drawn from the seed can be judged.

A loop has ``warm()``, ``window(seconds, guard) -> dict`` (``queries`` or
``requests`` attempted, ``seconds``, and the window's end-to-end readings
such as ``qps``), ``sample(rng, size) -> dict`` and ``close()``.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
from torch.profiler import record_function

from benchmark.harness import stats

WARM_BATCHES = 3


class ClosedBatch:
    def __init__(self, idx, queries: np.ndarray, traffic: dict, k: int):
        self.idx = idx
        self.queries = queries
        self.nb = int(traffic["query_batch"])
        self.backend = traffic["backend"]
        self.k = k
        self.results = []

    def _batch(self, j: int) -> np.ndarray:
        rows = (np.arange(self.nb) + j * self.nb) % self.queries.shape[0]
        return self.queries[rows]

    def _search(self, j: int):
        return self.idx.search(self._batch(j), self.k, query_batch=self.nb,
                               backend=self.backend)

    def warm(self) -> None:
        for j in range(WARM_BATCHES):
            self._search(j)

    def window(self, seconds: float, guard=contextlib.nullcontext) -> dict:
        results = self.results
        j = 0
        with guard():
            t0 = time.perf_counter()
            deadline = t0 + seconds
            traced = guard is not contextlib.nullcontext
            while True:
                if traced:
                    with record_function("bench.search_batch"):
                        d, i = self._search(j)
                else:
                    d, i = self._search(j)
                results.append((d, i))
                j += 1
                if time.perf_counter() >= deadline:
                    break
            t1 = time.perf_counter()
        return {"batches": j, "queries": j * self.nb, "seconds": t1 - t0,
                "qps": stats.rate(j * self.nb, t1 - t0)}

    def sample(self, rng: np.random.Generator, size: int) -> dict:
        """``size`` answers drawn from all those of the window."""
        total = len(self.results) * self.nb
        pick = np.sort(rng.choice(total, size=min(size, total),
                                  replace=False))
        b, r = pick // self.nb, pick % self.nb
        ids = np.stack([self.results[x][1][y] for x, y in zip(b, r)])
        dists = np.stack([self.results[x][0][y] for x, y in zip(b, r)])
        return {"q_index": pick % self.queries.shape[0], "ids": ids,
                "dists": dists, "failed": 0}

    def close(self) -> None:
        pass
