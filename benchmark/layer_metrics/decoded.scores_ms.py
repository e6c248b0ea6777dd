"""``decoded.scores_ms``: device ms a query batch of the operations launched
inside the program's ``decoded.scores`` spans (each row block's bf16 → f32
upcast, ``q @ blk.T`` and ``‖x‖² − 2q·x``, inside ``decoded.scan``)."""

from benchmark.harness import spans, trace


def read(ctx):
    tr = ctx["trace"]
    if not trace.range_count(tr, "decoded.scores"):
        return None
    return spans.per_batch_ms(ctx, trace.in_range_s(tr, "decoded.scores"))
