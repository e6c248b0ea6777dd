"""``device.idle_pct.deep100m``: the share of the traced window of
``deep100m-heap.batch`` in which no operation ran on the device, in %: the
host's turn-round between D1's batches, the cell's second bottleneck."""

from benchmark.harness.trace import idle_pct as read  # noqa: F401
