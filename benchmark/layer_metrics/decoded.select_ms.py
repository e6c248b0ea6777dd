"""``decoded.select_ms``: device ms a query batch of the operations launched
inside the program's ``decoded.scan`` span and outside its
``decoded.scores`` children (the span's self time on the device). On the
card's bf16 tier that is one sort of the keys D1's splits kept, which
merges them, and the exact rescore of the winners; on the plain path also
the blocked selection over the row blocks. The children nest in the scan
on one stream, so the self time is the scan's device time less theirs."""

from benchmark.harness import spans, trace


def read(ctx):
    tr = ctx["trace"]
    if not trace.range_count(tr, "decoded.scan"):
        return None
    return spans.per_batch_ms(ctx, trace.in_range_s(tr, "decoded.scan")
                              - trace.in_range_s(tr, "decoded.scores"))
