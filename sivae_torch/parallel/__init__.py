"""Data parallelism, one process per card, and depth sharding over a
data x spatial grid of processes (`sivae_tpu/parallel/`)."""

from sivae_torch.parallel.distributed import (  # noqa: F401
    grid,
    init_distributed,
    is_main_process,
    local_batch_slice,
    rank,
    shutdown,
    spatial_ranks,
    world_size,
)
from sivae_torch.parallel.mesh import (  # noqa: F401
    gather_depth,
    make_mesh,
    replicate_state,
    shard_batch,
    volume_slab,
)
