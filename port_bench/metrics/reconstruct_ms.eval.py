"""Device ms a pass of the report's reconstructions (the program's span, profiled window)."""

from port_bench.lib.spans import reconstruct_ms as read  # noqa: F401
