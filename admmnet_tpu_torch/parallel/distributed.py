"""Multi-process runtime bootstrap on ``torch.distributed``.

Counterpart of ``admmnet_tpu/parallel/distributed.py``.  One process per
device (a "rank"); ``init_distributed()`` joins the fleet from arguments or
from the environment and is a no-op in a single process, so library code
and CLIs can call it unconditionally.  Both launch conventions work:

    COORDINATOR=host0:29500 NPROC=4 PROC_ID=$i python my_script.py
    torchrun --nproc_per_node 4 my_script.py

(torchrun sets ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and
``LOCAL_RANK``).  The backend defaults to NCCL when CUDA is available and
to gloo otherwise; an explicit ``backend`` is taken as given.  Either way
the choice is printed, and nothing falls back to another backend.

``host_local_batch`` is the JAX package's arithmetic: the contiguous
(start, count) slice of a global batch that one process feeds.

``all_reduce_sum`` is a sum over the ranks of a group that autograd
differentiates (its backward is the same sum of the cotangents); the
ZLayer's batch mean and the trainer's metrics go through it.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class DistributedInfo:
    process_index: int
    process_count: int
    local_device_count: int
    global_device_count: int

    @property
    def is_main(self) -> bool:
        return self.process_index == 0


def _int_env(*names: str) -> Optional[int]:
    for name in names:
        v = os.environ.get(name)
        if v is not None:
            return int(v)
    return None


def _coordinator_from_env() -> Optional[str]:
    if os.environ.get("COORDINATOR"):
        return os.environ["COORDINATOR"]
    if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        return f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    return None


def local_device_count() -> int:
    """CUDA devices this host has, or 1 on a host without CUDA."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def local_rank() -> int:
    """This process's index on its host: ``LOCAL_RANK`` when the launcher
    sets it, else the process index (one host)."""
    lr = _int_env("LOCAL_RANK")
    if lr is not None:
        return lr
    return dist.get_rank() if dist.is_initialized() else 0


def current_info() -> DistributedInfo:
    if dist.is_initialized():
        world = dist.get_world_size()
        return DistributedInfo(dist.get_rank(), world, local_device_count(), world)
    n = local_device_count()
    return DistributedInfo(0, 1, n, n)


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> DistributedInfo:
    """Join the process group (idempotent).

    Arguments default from the environment: ``COORDINATOR`` (host:port) /
    ``NPROC`` / ``PROC_ID``, else torchrun's ``MASTER_ADDR:MASTER_PORT`` /
    ``WORLD_SIZE`` / ``RANK``.  With none of them set this is a single
    process and nothing is initialized.  ``backend``: "nccl" or "gloo";
    default NCCL when CUDA is available, else gloo.
    """
    coordinator_address = coordinator_address or _coordinator_from_env()
    num_processes = num_processes or _int_env("NPROC", "WORLD_SIZE")
    if process_id is None:
        process_id = _int_env("PROC_ID", "RANK")
    if not dist.is_initialized() and (coordinator_address is not None
                                      or num_processes is not None):
        missing = [name for name, v in (("coordinator address", coordinator_address),
                                        ("number of processes", num_processes),
                                        ("process id", process_id)) if v is None]
        if missing:
            raise ValueError(f"init_distributed: {', '.join(missing)} not given "
                             "(arguments, COORDINATOR/NPROC/PROC_ID or torchrun's env)")
        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        print(f"init_distributed: rank {process_id} of {num_processes}, backend {backend}, "
              f"tcp://{coordinator_address}", file=sys.stderr, flush=True)
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    return current_info()


def host_local_batch(global_batch: int, info: Optional[DistributedInfo] = None):
    """(start, count) slice of a global batch this process should feed:
    contiguous shards, the first ``global_batch % processes`` one longer."""
    if info is None:
        info = current_info()
    per = global_batch // info.process_count
    extra = global_batch % info.process_count
    start = info.process_index * per + min(info.process_index, extra)
    count = per + (1 if info.process_index < extra else 0)
    return start, count


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``group``, differentiable: the
    gradient of a rank's input is the sum of every rank's cotangent."""
    return _AllReduceSum.apply(x, group)
