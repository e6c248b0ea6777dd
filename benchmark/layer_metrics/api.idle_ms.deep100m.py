"""``api.idle_ms.deep100m``: device-idle ms a query batch of
``deep100m-heap.batch`` whose instants lie inside a host ``index.search``
span (the port's ``VAQIndex.search``): the idle time of the window less
the harness's own. Logs the idle ms a batch by the innermost program span open
at each idle instant (``harness/spans.py``)."""

from benchmark.harness import spans


def read(ctx):
    return spans.api_idle_ms(ctx, "deep100m")
