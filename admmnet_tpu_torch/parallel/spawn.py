"""Start a fleet of ranks on this host and collect what each returns.

``spawn_ranks(fn, world, backend, device)`` starts ``world`` processes (the
``spawn`` start method, as CUDA requires), each joined to the fleet through
``init_distributed`` from ``COORDINATOR`` / ``NPROC`` / ``PROC_ID`` on a free
localhost port, and calls ``fn(mesh, *args)`` on the rank's ``data_mesh``.
The return values (picklable: numpy arrays, numbers) come back to the
caller in rank order.  A rank that raises or dies fails the whole fleet:
the others are killed and the traceback is re-raised here.

``device``: "cpu" (every rank on the CPU), "cuda" (rank r on ``cuda:r``),
or one device such as "cuda:0", which puts every rank on that device (the
one-card check of a fleet; NCCL refuses two ranks on one device, so pass
``backend="gloo"`` there).  Kernels must be built before the ranks start;
they then load the built library.
"""

from __future__ import annotations

import os
import queue
import socket
import time
import traceback
from typing import Callable, Optional, Sequence

import torch
import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, port, backend, device, args, results):
    import torch.distributed as dist

    from admmnet_tpu_torch.parallel.distributed import init_distributed
    from admmnet_tpu_torch.parallel.mesh import data_mesh

    os.environ.update(COORDINATOR=f"localhost:{port}", NPROC=str(world), PROC_ID=str(rank))
    torch.set_num_threads(1)
    try:
        init_distributed(backend=backend)
        mesh = data_mesh(device=None if device == "cuda" else device)
        results.put((rank, True, fn(mesh, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn: Callable, world: int, backend: Optional[str] = None, device: str = "cpu",
                args: Sequence = (), timeout: float = 600.0) -> list:
    """``[fn(mesh, *args) on rank r for r in range(world)]``, run on a fleet
    of ``world`` processes (see the module docstring)."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, port, backend, device, tuple(args), results))
             for r in range(world)]
    for p in procs:
        p.start()
    out, ok = {}, False
    deadline = time.time() + timeout
    try:
        while len(out) < world:
            try:
                rank, good, payload = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)
                        and r not in out]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} died (exit code "
                                       f"{procs[dead[0]].exitcode}) before reporting")
                if time.time() > deadline:
                    raise TimeoutError(f"fleet of {world} ranks did not finish in {timeout} s")
                continue
            if not good:
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            out[rank] = payload
        ok = True
    finally:
        for p in procs:
            if ok:
                p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world)]
