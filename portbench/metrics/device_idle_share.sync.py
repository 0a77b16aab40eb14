"""The device's idle share over the profiled gradient-sync calls, %
(``harness/trace.py``: one minus the union of the device operations'
intervals over the host-clock window)."""

from portbench.harness.trace import idle_share_pct as read  # noqa: F401
