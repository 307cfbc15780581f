"""Percent of the profiled window the card is idle."""

from port_bench.lib.readers import idle_share as read  # noqa: F401
