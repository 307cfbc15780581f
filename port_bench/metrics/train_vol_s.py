"""train_vol_s: z1200_train's volumes (global-batch rows) a second through the two-phase step."""

from port_bench.lib.readers import volumes_per_s as read  # noqa: F401
