"""Data parallelism over the instance axis: meshes, shards and the sharded
solve.  Counterpart of ``admmnet_tpu/parallel/mesh.py``.

The instance (scenario) axis is the one parallel axis: thousands of
independent MN = 100 recovery problems split over the ``data`` axis, and
nothing crosses devices except where the semantics ask for it (the
ZLayer's batch mean, the gradients, the metrics).  A ``Mesh`` is the list
of devices this process drives plus the process group of the fleet (or
none).  Under ``torch.distributed`` each rank drives one device,
``cuda:LOCAL_RANK`` on a GPU host; the global batch is split by
``host_local_batch`` over the ranks, then over the process's devices.  In
one process, ``data_mesh(n, device="cpu")`` is ``n`` CPU shards (the CPU
stand-in for the JAX package's virtual devices), and ``data_mesh(n)`` on
CUDA is the first ``n`` GPUs of the host.

JAX returns one global array laid out over the mesh.  Here the shards stay
with their devices: ``shard_batch`` gives this process's shards, one per
device, and ``gather_batch`` assembles the global batch from every
process's shards.  The ``model`` axis has size 1, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Tuple

import torch
import torch.distributed as dist

from admmnet_tpu_torch.parallel.distributed import (
    DistributedInfo,
    current_info,
    host_local_batch,
    local_rank,
)


@dataclass(frozen=True)
class Mesh:
    devices: Tuple[torch.device, ...]  # the devices this process drives
    group: Any  # the fleet's process group, None in a single process
    info: DistributedInfo

    @property
    def size(self) -> int:
        """Devices on the data axis, over all processes."""
        return self.info.process_count * len(self.devices)

    @property
    def is_main(self) -> bool:
        return self.info.is_main

    def local_slices(self, global_batch: int) -> List[Tuple[int, int]]:
        """(start, count) in the global batch of each of this process's
        shards: the process's ``host_local_batch`` slice, split the same
        way over its devices."""
        start, count = host_local_batch(global_batch, self.info)
        n = len(self.devices)
        out = []
        for i in range(n):
            s, c = host_local_batch(count, DistributedInfo(i, n, n, n))
            out.append((start + s, c))
        return out


def data_mesh(n_devices: Optional[int] = None, model_axis: int = 1,
              device=None) -> Mesh:
    """A (data) x (model = 1) mesh of ``n_devices`` devices.

    Under ``torch.distributed``: one device per rank, ``n_devices`` (default:
    the world size) must equal the world size, and ``device`` defaults to
    ``cuda:LOCAL_RANK`` (the CPU on a host without CUDA).  In one process:
    ``device`` "cuda" (the default) takes the first ``n_devices`` GPUs,
    "cuda:i" that one GPU, "cpu" makes ``n_devices`` CPU shards.
    """
    if model_axis != 1:
        raise ValueError(f"model_axis={model_axis}: the model axis has size 1 "
                         "(no tensor parallelism at MN = 100)")
    if dist.is_initialized():
        info = current_info()
        n = n_devices or info.process_count
        if n != info.process_count:
            raise ValueError(f"requested {n} devices, have {info.process_count} "
                             "(one rank per device)")
        if device is None:
            if torch.cuda.is_available():
                lr, have = local_rank(), torch.cuda.device_count()
                if lr >= have:
                    raise ValueError(f"local rank {lr} has no CUDA device (have {have}); "
                                     "launch one rank per device or pass device=")
                device = torch.device("cuda", lr)
            else:
                device = torch.device("cpu")
        device = torch.device(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)  # NCCL's collectives run on the current device
        return Mesh((device,), dist.group.WORLD, info)

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if dev.index is not None:
            have = 1 if dev.index < have else 0
        n = n_devices or max(have, 1)
        if n > have:
            raise ValueError(f"requested {n} devices, have {have}")
        devices = ((dev,) if dev.index is not None
                   else tuple(torch.device("cuda", i) for i in range(n)))
    else:
        n = n_devices or 1
        devices = (dev,) * n
    return Mesh(devices, None, DistributedInfo(0, 1, len(devices), len(devices)))


def _tree_map(fn: Callable, *trees):
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*(_tree_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(t, (list, tuple)):
        return type(t)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _to_device(x, device):
    t = torch.as_tensor(x)
    if t.is_complex():
        t = t.to(torch.complex64)
    return t.to(device)


def shard_batch(tree, mesh: Mesh) -> list:
    """This process's shards of a global batch: one tree per device of the
    mesh, each leaf's leading axis sliced (complex leaves as complex64)."""
    n = len(next(iter(_leaves(tree))))
    return [_tree_map(lambda x: _to_device(x[s:s + c], dev), tree)
            for (s, c), dev in zip(mesh.local_slices(n), mesh.devices)]


def replicate(tree, mesh: Mesh) -> list:
    """A copy of ``tree`` on every device of the mesh (one tree per
    device); under a process group every rank receives rank 0's values."""

    def put(x, dev):
        t = _to_device(x, dev)
        if mesh.group is not None:
            t = t.contiguous()
            dist.broadcast(t, 0, group=mesh.group)
        return t

    return [_tree_map(lambda x: put(x, dev), tree) for dev in mesh.devices]


def _leaves(tree):
    out = []
    _tree_map(lambda x: out.append(x), tree)
    return out


def _all_gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Rows of ``t`` from every rank, in rank order (the shards may differ
    in length by one, as ``host_local_batch`` cuts them)."""
    n_local = torch.tensor([t.shape[0]], dtype=torch.int64, device=t.device)
    counts = [torch.zeros_like(n_local) for _ in range(mesh.info.process_count)]
    dist.all_gather(counts, n_local, group=mesh.group)
    counts = [int(c) for c in counts]
    width = max(counts)
    pad = torch.zeros((width - t.shape[0], *t.shape[1:]), dtype=t.dtype, device=t.device)
    padded = torch.cat([t, pad]).contiguous()
    parts = [torch.empty_like(padded) for _ in counts]
    dist.all_gather(parts, padded, group=mesh.group)
    return torch.cat([p[:c] for p, c in zip(parts, counts)])


def gather_batch(shards: list, mesh: Mesh):
    """The global batch from every process's shards (``shard_batch``'s
    inverse): leaves concatenated in instance order, on the mesh's first
    device."""
    dev = mesh.devices[0]

    def cat(*xs):
        t = torch.cat([torch.as_tensor(x).to(dev) for x in xs])
        if mesh.group is None:
            return t
        if t.is_complex():
            return torch.view_as_complex(_all_gather_rows(torch.view_as_real(t), mesh))
        if t.dtype == torch.bool:
            return _all_gather_rows(t.to(torch.uint8), mesh).bool()
        return _all_gather_rows(t, mesh)

    return _tree_map(cat, *shards)


def sharded_solver(mesh: Mesh, num_iters: int, lambda_val: float = 1.0, opts=None):
    """Batched fixed-iteration classical solve with the instance axis split
    over the mesh.  Returns a callable (y, b, sigma) -> this process's phi
    shards (one tensor per device of the mesh), taking the global batch as
    host arrays; ``gather_batch(shards, mesh)`` gives the global phi.  On
    CUDA each shard launches the kernels of ``admm_solve_fixed`` (K2 for
    ``fused_*``, K1 for ``polar*``)."""
    from admmnet_tpu_torch.core.config import ADMMOptions
    from admmnet_tpu_torch.solver import admm_solve_fixed

    opts = opts or ADMMOptions()

    def call(y, b, sigma) -> List[torch.Tensor]:
        shards = shard_batch({"y": y, "b": b, "sigma": sigma}, mesh)
        return [admm_solve_fixed(s["y"], s["b"], s["sigma"], num_iters, lambda_val, opts)
                for s in shards]

    return call


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait for every rank of the mesh's fleet (nothing in one process)."""
    if mesh is None or mesh.group is None:
        return
    dev = mesh.devices[0]
    if dist.get_backend(mesh.group) == "nccl":
        dist.barrier(group=mesh.group, device_ids=[dev.index])
    else:
        dist.barrier(group=mesh.group)


def bind_batch_mean(model: torch.nn.Module, mesh: Optional[Mesh]) -> None:
    """Make every ZLayer of ``model`` take its batch mean over the mesh's
    process group (the global batch), or, with ``mesh`` None or a fleet of
    one process, over the local batch as before."""
    from admmnet_tpu_torch.models.layers import ZLayer

    group = mesh.group if mesh is not None and mesh.info.process_count > 1 else None
    for m in model.modules():
        if isinstance(m, ZLayer):
            m.batch_group = group
