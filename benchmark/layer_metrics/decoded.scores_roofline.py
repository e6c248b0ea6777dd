"""``decoded.scores_roofline``: the bf16 decoded tier's scan, the program's
``decoded.scores`` spans (on the card D1 alone, whatever kernel implements
it), against its bound, in %.

The bound of one batch is ``peaks.scan_bound_s``, ``2 · nq · n · D`` bf16
operations at 989 TFLOP/s, the one frozen count of every scan; the time is
the device time of the operations launched inside ``decoded.scores`` in the
traced window over the batches it ran."""

from benchmark.harness import peaks, trace


def read(ctx):
    tr = ctx["trace"]
    batches = ctx["window"].get("batches")
    t = trace.in_range_s(tr, "decoded.scores")  # 0.0 where no range is
    if not t or not batches:
        return None
    idx = ctx["index"]
    b = peaks.scan_bound_s(int(ctx["traffic"]["query_batch"]), idx.n_rows,
                           idx.total_dim)
    return 100.0 * b * batches / t
