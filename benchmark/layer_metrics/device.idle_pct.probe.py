"""``device.idle_pct.probe``: the share of the traced window of
``deep10m-ti.batch`` in which no operation ran on the device, in %."""

from benchmark.harness.trace import idle_pct as read  # noqa: F401
