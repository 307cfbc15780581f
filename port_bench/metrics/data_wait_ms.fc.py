"""ms a step waiting for the pipeline's batch (timed window)."""

from port_bench.lib.readers import data_wait_ms as read  # noqa: F401
