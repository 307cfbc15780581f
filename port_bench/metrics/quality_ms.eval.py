"""Device ms a pass of the report's quality metrics (the program's span, profiled window)."""

from port_bench.lib.spans import quality_ms as read  # noqa: F401
