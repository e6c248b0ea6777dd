"""``ivf.dropped_pct``: the share of the probe's active (query, cluster)
entries that the static qcap drops, in %: 100 × ``ivf.entries_dropped`` /
``ivf.entries`` of the program's ``profiling.counters()``, which count only
while a profiler records (the traced window; the warm-up runs without
one)."""


def read(ctx):
    from vaq_tpu_torch import profiling
    counters = getattr(profiling, "counters", None)
    if counters is None:
        return None
    c = counters()
    if not c.get("ivf.entries"):
        return None
    return 100.0 * c.get("ivf.entries_dropped", 0) / c["ivf.entries"]
