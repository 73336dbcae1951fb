from admmnet_tpu_torch.parallel.distributed import (
    DistributedInfo,
    all_reduce_sum,
    host_local_batch,
    init_distributed,
)
from admmnet_tpu_torch.parallel.mesh import (
    Mesh,
    bind_batch_mean,
    data_mesh,
    gather_batch,
    replicate,
    shard_batch,
    sharded_solver,
)
from admmnet_tpu_torch.parallel.spawn import spawn_ranks

__all__ = [
    "DistributedInfo",
    "Mesh",
    "all_reduce_sum",
    "bind_batch_mean",
    "data_mesh",
    "gather_batch",
    "host_local_batch",
    "init_distributed",
    "replicate",
    "shard_batch",
    "sharded_solver",
    "spawn_ranks",
]
