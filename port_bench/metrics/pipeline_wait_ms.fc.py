"""Host ms a step waiting for the pipeline's batch (the program's span, profiled window)."""

from port_bench.lib.spans import pipeline_wait_ms as read  # noqa: F401
