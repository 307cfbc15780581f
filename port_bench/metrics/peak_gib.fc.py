"""GiB: the peak allocation in the timed window."""

from port_bench.lib.readers import peak_gib as read  # noqa: F401
