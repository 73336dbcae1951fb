"""Scaling-efficiency harness: instance throughput against device count;
counterpart of ``admmnet_tpu/bench/scaling.py``.

The north-star protocol (BASELINE.md): ADMM iterations/s per device at 1 and
more devices, >= 95% per-device scaling efficiency on batched instances.
The solve is embarrassingly parallel over instances (nothing crosses
devices), so scaling is bounded by dispatch and host overheads; this
harness measures it over ``parallel.data_mesh`` on whatever the caller
names: the host's GPUs, or ``n`` CPU shards (``device="cpu"``, which checks
the sharded path and the shape of the curve, not GPU numbers).

The inputs are placed on their devices before timing (``shard_batch``),
and each timed call is the sharded solve plus a scalar reduction per
shard.  On CUDA a call is timed by CUDA events on every device (the
slowest device's time); on the CPU by the host clock.  In a fleet of
ranks the slowest rank's time counts.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from admmnet_tpu_torch.core.config import ADMMOptions


def _timed(fn, devices) -> float:
    """Seconds of one call of ``fn`` on ``devices``."""
    cuda = [d for d in dict.fromkeys(devices) if d.type == "cuda"]
    if not cuda:
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    events = []
    for d in cuda:
        with torch.cuda.device(d):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            events.append((start, end))
    fn()
    for d, (_, end) in zip(cuda, events):
        with torch.cuda.device(d):
            end.record()
    for _, end in events:
        end.synchronize()
    return max(s.elapsed_time(e) for s, e in events) / 1e3


def measure_throughput(n_devices: int, batch_per_device: int = 512, iters: int = 20,
                       opts: Optional[ADMMOptions] = None, repeats: int = 2, seed: int = 0,
                       total_batch: Optional[int] = None, device=None) -> float:
    """Instance-iterations/s of the batched solve over an n-device mesh
    (``data_mesh(n_devices, device=device)``).

    ``total_batch`` switches from weak scaling (B = batch_per_device * n)
    to strong scaling (a fixed B split over the n devices)."""
    from admmnet_tpu_torch.data.anchor import make_anchor_batch
    from admmnet_tpu_torch.parallel import data_mesh, shard_batch
    from admmnet_tpu_torch.solver import admm_solve_fixed

    opts = opts or ADMMOptions(g_update="polar")
    B = total_batch if total_batch is not None else batch_per_device * n_devices
    if B % n_devices:
        raise ValueError(f"total_batch {B} not divisible by {n_devices} devices")
    mesh = data_mesh(n_devices, device=device)
    y, b, sigma = make_anchor_batch(B, mode="redemod", seed=seed)
    shards = shard_batch({"y": y, "b": b, "sigma": sigma}, mesh)

    def run():
        for s in shards:
            torch.sum(torch.abs(admm_solve_fixed(s["y"], s["b"], s["sigma"], iters, 1.0, opts)))

    _timed(run, mesh.devices)  # warm: builds and loads the kernels
    best = np.inf
    for _ in range(repeats):
        t = _timed(run, mesh.devices)
        if mesh.group is not None:
            slowest = torch.tensor([t], dtype=torch.float64, device=mesh.devices[0])
            dist.all_reduce(slowest, op=dist.ReduceOp.MAX, group=mesh.group)
            t = float(slowest)
        best = min(best, t)
    return B * iters / best


def scaling_report(device_counts: Sequence[int], batch_per_device: int = 512, iters: int = 20,
                   opts: Optional[ADMMOptions] = None, total_batch: Optional[int] = None,
                   device=None) -> List[dict]:
    """Throughput and per-device efficiency across device counts.

    Weak scaling (default): efficiency = throughput / (n * base_per_device);
    strong scaling (``total_batch``): efficiency = throughput / base, i.e.
    fixed work should keep total throughput flat."""
    rows = []
    base = None
    for n in device_counts:
        tput = measure_throughput(n, batch_per_device, iters, opts, total_batch=total_batch,
                                  device=device)
        if base is None:
            base = tput / (1 if total_batch is not None else device_counts[0])
        eff = tput / base if total_batch is not None else tput / (n * base)
        rows.append({"devices": n, "throughput_iters_per_s": tput, "per_device": tput / n,
                     "efficiency": eff})
    return rows
