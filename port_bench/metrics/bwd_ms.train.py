"""Device ms a step of the two phases' backwards (the program's spans, profiled window)."""

from port_bench.lib.spans import bwd_ms as read  # noqa: F401
