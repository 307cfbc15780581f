"""Data parallelism: one process per card (`sivae_tpu/parallel/`)."""

from sivae_torch.parallel.distributed import (  # noqa: F401
    init_distributed,
    is_main_process,
    local_batch_slice,
    rank,
    shutdown,
    world_size,
)
from sivae_torch.parallel.mesh import replicate_state  # noqa: F401
