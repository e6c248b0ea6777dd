"""``closed_batch``: back-to-back ``VAQIndex.search(batch, k,
query_batch=<query_batch>, backend=<backend>)`` calls on successive batches
of the query set (``harness/loops.py``'s ``ClosedBatch``); the mix's keys
``query_batch`` and ``backend`` are its parameters."""

from benchmark.harness.loops import ClosedBatch


def make(idx, queries, traffic: dict, k: int, seed: int) -> ClosedBatch:
    return ClosedBatch(idx, queries, traffic, k)
