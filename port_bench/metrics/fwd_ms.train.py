"""Device ms a step of the two phases' forwards and losses (program spans)."""

from port_bench.lib.spans import fwd_ms as read  # noqa: F401
