"""Operations and bytes of one call of the classical deployment, counted
from the algorithm at the logical sizes (lifted side n + 1 = 101), whatever
the program pads to or however it computes.

Frozen from the port's chip smoke test (``solve_flops``, ``solve_bytes``):
a fused solve does 9 real (n+1)^3 products per schedule step (two
Hermitian squares of 3 real products, one Karatsuba product of 3) and 3
closing ones per instance-iteration, 2 operations a multiply-add; it reads
its rows (y / b, w: 3 n floats and A) once and writes phi.  The peak search
does two complex products on its coarse grid and two per refine round and
peak, 8 real operations a complex multiply-add."""

from __future__ import annotations

import numpy as np


def solve_flops(instances: int, iters: int, nsteps: int, n: int) -> float:
    return instances * iters * (9 * nsteps + 3) * 2.0 * (n + 1) ** 3


def solve_bytes(instances: int, n: int) -> float:
    return instances * ((3 * n + 1) * 4 + n * 8)


def coarse_sizes(pk: dict):
    taus = np.arange(pk["delay_min"], pk["delay_max"], pk["delay_step"], dtype=np.float32)
    if taus.size and abs((taus[-1] - pk["delay_min"]) % 1.0) < 1e-9:
        taus = taus[:-1]
    fs = np.arange(pk["doppler_min"], pk["doppler_max"], pk["doppler_step"], dtype=np.float32)
    return taus.size, fs.size


def peaks_flops(instances: int, Nb: int, Nd: int, pk: dict) -> float:
    nx, ny = coarse_sizes(pk)
    K, P = pk["max_peaks"], pk["refine_points"]
    coarse = ny * Nb * Nd + ny * Nd * nx
    refine = pk["refine_iters"] * K * (P * Nb * Nd + P * Nd * P)
    return instances * 8.0 * (coarse + refine)


def peaks_bytes(instances: int, n: int, K: int) -> float:
    """phi read once (complex64); tau, f, height (float32) and valid written."""
    return instances * (n * 8 + K * 13)


def per_call(config: dict, traffic: dict) -> dict:
    """{stage: (operations, bytes)} of one call of ``traffic["batch"]`` scenes."""
    spec, s, pk = config["spec"], config["solver"], config["peaks"]
    B, n = traffic["batch"], spec["Nb"] * spec["Nd"]
    solve = (solve_flops(B, s["iters"], len(s["schedule"]), n), solve_bytes(B, n))
    peaks = (peaks_flops(B, spec["Nb"], spec["Nd"], pk), peaks_bytes(B, n, pk["max_peaks"]))
    return {"solve": solve, "peaks": peaks,
            "call": (solve[0] + peaks[0], solve[1] + peaks[1])}
