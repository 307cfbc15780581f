"""ms a dataset volume of library (non-sivae::) kernels (profiled pass)."""

from port_bench.lib.readers import library_ms_per_volume as read  # noqa: F401
