"""The step's percent of the card's bfloat16 peak (timed window)."""

from port_bench.lib.readers import mfu as read  # noqa: F401
