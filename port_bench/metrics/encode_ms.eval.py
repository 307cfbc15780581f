"""Device ms a pass of encode_dataset (the program's span, profiled window)."""

from port_bench.lib.spans import encode_ms as read  # noqa: F401
