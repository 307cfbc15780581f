"""Host ms a step issuing the two-phase step (the program's span, profiled window)."""

from port_bench.lib.spans import step_host_ms as read  # noqa: F401
