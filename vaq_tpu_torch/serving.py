"""Continuous-batching search server.

The counterpart of ``vaq_tpu/serving.py``: a server that coalesces
concurrently-arriving queries into fixed-shape device batches (BASELINE.md:
"continuous query batching, merged top-k"):

* requests are queued and packed into a static ``max_batch`` batch (padded,
  so every batch has one shape); a request that does not fit leads the next
  batch;
* dispatch is decoupled from result fetching: the batching loop launches the
  search on the card and queues the device-to-host copy of its result into
  pinned host memory behind it, then hands a CUDA event to a small fetcher
  pool; at most ``pipeline_depth`` batches are in flight between launch and
  fetch;
* results are delivered per request via futures; latency statistics are end
  to end (submit → result available), not device time only.

The fetch is the part that differs from JAX's. A plain ``.cpu()`` in a
fetcher thread runs on the device's default stream, so it waits for every
batch launched after it and the pipeline falls back to depth 1 (the
serialisation that JAX's server measured at p50 168 ms in its first form).
Here the copy is queued by the loop thread itself, right after its batch,
``non_blocking`` into pinned memory, and a fetcher only waits on that
batch's event.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np
import torch

from vaq_tpu_torch.profiling import LatencyStats

# (submitted query rows, caller future, submit timestamp)
_Req = Tuple[np.ndarray, Future, float]


class SearchServer:
    """Continuous-batching wrapper around ``VAQIndex.search_device``.

    ``recall_target`` is accepted so that callers of the JAX server work
    unchanged; it has no effect, because the port's selections are exact
    (it has no ``approx_max_k``)."""

    def __init__(self, index, k: int, max_batch: int = 256,
                 max_wait_ms: float = 2.0, backend: str = "decoded",
                 recall_target: float = 0.99, pipeline_depth: int = 4):
        self.index = index
        self.k = k
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        self.backend = backend
        self.recall_target = recall_target
        self._queue: "queue.Queue" = queue.Queue()
        self._carry: Optional[_Req] = None  # overflow from the previous batch
        self._running = True
        self.batches_served = 0
        self.queries_served = 0
        self.stats = LatencyStats()
        # dispatch-side instrumentation: batch fill + fetch wall time explain
        # where a serving ceiling comes from (device, fetch, or an
        # under-filled batcher)
        self.sum_fill = 0          # real (unpadded) rows across batches
        self.sum_fetch_s = 0.0     # wall time inside _finish's wait + copy
        self._lock = threading.Lock()
        # at most pipeline_depth batches between "launched" and "fetched"
        self._slots = threading.Semaphore(pipeline_depth)
        self._fetchers = ThreadPoolExecutor(max_workers=pipeline_depth,
                                            thread_name_prefix="vaq-fetch")
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    def submit(self, query: np.ndarray) -> Future:
        """Enqueue one query (d,) or a small group (g, d); returns a Future
        resolving to (distances, labels) numpy arrays."""
        fut: Future = Future()
        q = np.atleast_2d(np.asarray(query, dtype=np.float32))
        if q.shape[0] > self.max_batch:
            fut.set_exception(ValueError(
                f"group of {q.shape[0]} queries exceeds max_batch="
                f"{self.max_batch}; split the request"))
            return fut
        self._queue.put((q, fut, time.perf_counter()))
        return fut

    def search(self, query: np.ndarray, timeout: float = 60.0):
        return self.submit(query).result(timeout)

    def close(self) -> None:
        self._running = False
        self._queue.put(None)
        self._thread.join(timeout=30.0)
        self._fetchers.shutdown(wait=True)

    # ------------------------------------------------------------------
    def _collect_batch(self) -> Optional[List[_Req]]:
        if self._carry is not None:
            first = self._carry
            self._carry = None
        else:
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                return []
            if first is None:
                return None
        items = [first]
        rows = first[0].shape[0]
        deadline = time.perf_counter() + self.max_wait_s
        while rows < self.max_batch:
            # drain any burst without paying a timed get per request
            try:
                nxt = self._queue.get_nowait()
            except queue.Empty:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
            if nxt is None:
                self._queue.put(None)  # re-signal shutdown
                break
            if rows + nxt[0].shape[0] > self.max_batch:
                self._carry = nxt      # doesn't fit — next batch leads with it
                break
            items.append(nxt)
            rows += nxt[0].shape[0]
        return items

    def _dispatch(self, items: List[_Req]
                  ) -> Tuple[torch.Tensor, Optional[torch.cuda.Event], int]:
        """Launch one padded batch; returns (its fused result on the host,
        the event after which that host copy is complete or None on the
        CPU, the real rows)."""
        qs = np.concatenate([q for q, _, _ in items], axis=0)
        nrows = qs.shape[0]
        if nrows < self.max_batch:
            qs = np.pad(qs, ((0, self.max_batch - nrows), (0, 0)))
        else:
            qs = qs[: self.max_batch]
        dev = self.index.device
        on_cuda = dev.type == "cuda"
        # the loop thread's current device is cuda:0 by default; launch on
        # the index's card, on that card's current (default) stream
        with torch.cuda.device(dev) if on_cuda else contextlib.nullcontext():
            d, i = self.index.search_device(
                torch.as_tensor(qs).to(dev), self.k, backend=self.backend)
            # distances as their int32 bits beside the labels: one copy per
            # batch (JAX fused them for its one transfer; int32, never f32,
            # since its TPU flushed denormal f32 bit patterns to zero)
            fused = torch.cat([d.to(torch.float32).view(torch.int32),
                               i.to(torch.int32)], dim=1)
            if not on_cuda:
                return fused, None, nrows
            host = torch.empty(fused.shape, dtype=torch.int32,
                               pin_memory=True)
            host.copy_(fused, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(dev))
        return host, done, nrows

    def _finish(self, items: List[_Req], host: torch.Tensor,
                done: Optional[torch.cuda.Event], nrows: int) -> None:
        """Fetcher-pool body: wait for the batch's host copy, resolve the
        callers' futures, record end-to-end latency per request."""
        try:
            t_f = time.perf_counter()
            if done is not None:
                done.synchronize()
            arr = host.numpy()                            # (B, 2k) int32
            t_fetch = time.perf_counter() - t_f
            d_np = np.ascontiguousarray(arr[:, : self.k]).view(np.float32)
            i_np = arr[:, self.k:]
        except Exception as e:
            for _, fut, _ in items:
                if not fut.done():
                    fut.set_exception(e)
            return
        finally:
            self._slots.release()
        now = time.perf_counter()
        row = 0
        with self._lock:
            for q, fut, t_submit in items:
                self.stats.record(now - t_submit, q.shape[0])
            self.batches_served += 1
            self.queries_served += nrows
            self.sum_fill += nrows
            self.sum_fetch_s += t_fetch
        for q, fut, _ in items:
            g = q.shape[0]
            fut.set_result((d_np[row: row + g], i_np[row: row + g]))
            row += g

    def _loop(self) -> None:
        while self._running:
            items = self._collect_batch()
            if items is None:
                break
            if not items:
                continue
            self._slots.acquire()
            try:
                host, done, nrows = self._dispatch(items)  # async launch
            except Exception as e:   # fail the batch, not the server
                self._slots.release()
                for _, fut, _ in items:
                    if not fut.done():
                        fut.set_exception(e)
                continue
            self._fetchers.submit(self._finish, items, host, done, nrows)
