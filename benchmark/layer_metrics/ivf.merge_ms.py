"""``ivf.merge_ms``: device ms a batch of the operations launched inside the
program's ``ivf.merge`` range (the per-query merge of the group minima and
its top-m windows)."""

from benchmark.harness import trace


def read(ctx):
    tr = ctx["trace"]
    count = trace.range_count(tr, "ivf.merge")
    if not count:
        return None
    return 1e3 * trace.in_range_s(tr, "ivf.merge") / count
