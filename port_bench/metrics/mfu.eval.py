"""The pass's percent of the card's peak for fp32 operands, the TF32 rate (timed window)."""

from port_bench.lib.readers import mfu as read  # noqa: F401
