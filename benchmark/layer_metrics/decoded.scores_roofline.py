"""``decoded.scores_roofline``: the bf16 decoded tier's scan, the program's
``decoded.scores`` spans (on the card D1 alone, whatever kernel implements
it), against its bound, in %.

The bound of one batch is ``decode_window_scan_roofline``'s own
(``bound_s``: ``2 · nq · n · D`` bf16 operations at 989 TFLOP/s), loaded
from that file, so that the count stays one frozen function whatever scans
the rows; the time is the device time of the operations launched inside
``decoded.scores`` in the traced window over the batches it ran."""

from benchmark.harness import spec, trace


def read(ctx):
    tr = ctx["trace"]
    batches = ctx["window"].get("batches")
    t = trace.in_range_s(tr, "decoded.scores")  # 0.0 where no range is
    if not t or not batches:
        return None
    k1 = spec.load_module("layer_metrics", "decode_window_scan_roofline")
    idx = ctx["index"]
    b = k1.bound_s(int(ctx["traffic"]["query_batch"]), idx.n_rows,
                   idx.total_dim)
    return 100.0 * b * batches / t
