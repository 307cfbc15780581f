"""Kernel launches a step (profiled window)."""

from port_bench.lib.readers import launches as read  # noqa: F401
