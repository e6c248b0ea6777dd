"""``device.idle_pct.codes``: the share of the traced window of
``sift1m-heap.batch-codes`` in which no operation ran on the device, in %."""

from benchmark.harness.trace import idle_pct as read  # noqa: F401
