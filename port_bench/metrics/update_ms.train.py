"""Device ms a step of the gradient averages and Adam steps (program spans)."""

from port_bench.lib.spans import update_ms as read  # noqa: F401
