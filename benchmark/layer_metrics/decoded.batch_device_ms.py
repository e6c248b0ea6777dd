"""``decoded.batch_device_ms``: device-busy ms a query batch, the union of
the device operations' intervals in the traced window over the batches it
ran."""

from benchmark.harness import trace


def read(ctx):
    batches = ctx["window"].get("batches")
    if not batches:
        return None
    busy = trace.busy_s(ctx["trace"])
    return 1e3 * busy / batches if busy > 0 else None
