"""``decode_window_scan_roofline``: K1 (``decode_window_scan``, the codes
tier's window scan) against its bound, in %.

The bound of one batch is its bf16 products, ``2 · nq · n · D`` operations
at the H100's 989 TFLOP/s (0.2651 ms at 1024 × 1M × 128); the time is K1's
device time in the traced window over the batches it ran. K1 also decodes
the codes, but its bytes (n · M) bound it far lower than its products."""

from benchmark.harness import peaks, trace


def bound_s(nq: int, n: int, dim: int) -> float:
    return peaks.bound_s(ops=2.0 * nq * n * dim, kind="bf16")


def read(ctx):
    batches = ctx["window"].get("batches")
    t, count = trace.op_time_s(ctx["trace"],
                               lambda name: "decode_window_scan" in name)
    if not batches or not count or t <= 0:
        return None
    idx = ctx["index"]
    b = bound_s(int(ctx["traffic"]["query_batch"]), idx.n_rows,
                idx.total_dim)
    return 100.0 * b * batches / t
