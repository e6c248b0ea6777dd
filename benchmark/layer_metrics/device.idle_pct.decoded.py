"""``device.idle_pct.decoded``: the share of the traced window of
``sift1m-heap.batch`` in which no operation ran on the device, in %. The
same reading in ``deep100m-heap.batch`` is ``device.idle_pct.deep100m``."""

from benchmark.harness.trace import idle_pct as read  # noqa: F401
