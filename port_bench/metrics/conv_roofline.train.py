"""The port's conv kernels' percent of their roofline (profiled window)."""

from port_bench.lib.readers import conv_roofline as read  # noqa: F401
