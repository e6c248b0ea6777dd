"""``device.idle_pct.decoded``: the share of the traced window of
``sift1m-heap.batch`` in which no operation ran on the device, in %."""

from benchmark.harness.trace import idle_pct as read  # noqa: F401
