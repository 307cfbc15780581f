"""eval_vol_s: dataset volumes a second through whole eval passes."""

from port_bench.lib.readers import volumes_per_s as read  # noqa: F401
