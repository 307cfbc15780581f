"""Device ms a batch of the pipeline's copy, augmentation, preprocessing (program span)."""

from port_bench.lib.spans import prepare_ms as read  # noqa: F401
