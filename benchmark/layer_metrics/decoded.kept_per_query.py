"""``decoded.kept_per_query``: the keys D1's heaps took a query, the
program's counter ``decoded.kept`` (``profiling.counters()``, counted only
while a profiler records: the traced window) over the window's ``batches ×
query_batch`` queries. It is the epilogue's work, which grows with the rows
a split scans and with ties."""


def read(ctx):
    from vaq_tpu_torch import profiling
    counters = getattr(profiling, "counters", None)
    batches = ctx["window"].get("batches")
    if counters is None or not batches:
        return None
    kept = counters().get("decoded.kept")
    if not kept:
        return None
    return kept / (batches * int(ctx["traffic"]["query_batch"]))
