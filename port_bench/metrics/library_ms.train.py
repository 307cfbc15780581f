"""ms a step of library (non-sivae::) kernels (profiled window)."""

from port_bench.lib.readers import library_ms as read  # noqa: F401
