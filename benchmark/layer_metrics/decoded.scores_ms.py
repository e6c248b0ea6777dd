"""``decoded.scores_ms``: device ms a query batch of the operations launched
inside the program's ``decoded.scores`` spans. On the card the bf16 tier's
span holds kernel D1 alone (the rows' products and each split's top-kk
selection in one launch); on the plain path (the int8 tier, the CPU) each
row block's product and ``‖x‖² − 2q·x``."""

from benchmark.harness import spans, trace


def read(ctx):
    tr = ctx["trace"]
    if not trace.range_count(tr, "decoded.scores"):
        return None
    return spans.per_batch_ms(ctx, trace.in_range_s(tr, "decoded.scores"))
