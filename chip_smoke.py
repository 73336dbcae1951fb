#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``admmnet_tpu_torch``) on one GPU.

Drives the three paths of the port through its public entry points on the
card, after building the CUDA kernels from ``admmnet_tpu_torch/kernels/csrc``
and holding each kernel against its plain PyTorch version:

- the classical detection pipeline (phases 3-9): anchor / random-SNR scenes
  -> batched ADMM solve -> peak list -> detection score, and the fused
  modes' fallback to the per-step loop above a lifted side of 128 (phase 8);
- the learned pipeline (phases 10-13): the committed net-3 checkpoint
  (chebyshev GLayer on the Clenshaw kernel, spectrum head) on the 512
  random-SNR scenes, held against the JAX package's golden output;
- training (phases 14-17): the Clenshaw training forward K5 and reversible
  backward K6 (tensor-core products, as K4's and K2/K3's; phase 2 counts
  the HMMA instructions of every instantiation) against their plain
  versions, three recipe steps of net-3
  against the JAX package's golden steps, then ``generate_dataset`` and
  ``train_cli`` with the net-3 recipe (10k fixed-SNR-20 scenes, 15 epochs)
  on the card through the native minibatch loader, scored against the
  committed net-3 checkpoint;
- the other whole-solve routes (phases 18-23): the lists layout K3 and
  K2's unfolded carry against their plain versions and end to end as the
  escape hatch ``ADMMOptions(fused_layout="lists", ...)`` (anchor and
  random-scene gates), the first-generation fused solve K7 against its
  plain version, the per-step polar solve and the eigh golden, K1's bf16
  iterate storage, the ``bench_time`` CLI, and their timings (K1 and K7 on
  the whole-product body of ``polar_cta.cuh``; phase 2 counts their HMMA
  instructions too); then K2's
  subtraction profile by its ``ablate`` variants (phase 25);
- data parallelism (phase 26): the deploy solve sharded over a world-2
  gloo fleet with both ranks on this card, and the flagship net-10 trained
  on it with DistributedDataParallel, against the same solve and run in
  one process; the same training on a world-1 NCCL fleet, bit for bit the
  run without a mesh; ``bench_scaling --devices 1``; ``dryrun_multichip(2)``
  on this card.  The ranks load the kernels built in phase 2.

Every phase prints one line with its numbers and the tolerance it is held
to; any failure raises (non-zero exit) before the last line.  The last line is the JSON status line

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

the line before it the card's name and power limit, and the one before
that a JSON summary of the kernels.  Run from the
repository root with ``python3 chip_smoke.py``; it needs one CUDA device
and exits non-zero without one.  ``python3 chip_smoke.py --time-cheb``
runs only phases 12 and 17's timing of K4 and K5 (``time_cheb``) and
``--time-k6`` only phase 17's timing of K6 (``time_k6``),
``--time-polar`` only K1's and K7's timing (``time_polar``) and
``--codegen`` only phase 2's registers, spills and HMMA counts
(``codegen``), to pair two trees; ``python3 chip_smoke.py --profile-k2``
only phase 25, the subtraction profile of K2 by its ``ablate`` variants
(``k2_profile``); ``--parallel`` only phase 26 (``parallel_only``).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
GOLDEN_EIGH = ROOT / "results" / "r05" / "phi_eigh_2048.npz"
RANDOM_SCENES = ROOT / "tests" / "golden" / "random512_key42.npz"
GOLDEN_NET3 = ROOT / "tests" / "golden" / "net3_random512_jax.npz"
NET3 = ROOT / "runs" / "train_net3_r05"
NET3_RECORDED_F1 = 0.8646  # results/r05/net_depth_r05.json, the TPU kernel's run
GOLDEN_TRAIN = ROOT / "tests" / "golden" / "net3_train_golden.msgpack"
NET3_RECORDED_TEST_F1 = 0.878  # results/r05/net_depth_r05.json, matched test F1 (JAX)

ITERS = 100  # full solve budget
B_SOLVE = 2048  # anchor instances, K2 vs its plain version
B_EXACT = 512  # fused_exact instances
B_POLAR_SOLVE = 256  # per-step polar / eigh solves vs the golden
B_K1 = 512  # matrices, K1 vs its plain version
B_TIME_K2 = 8192  # timing shapes
B_TIME_K1 = 2048
B_K4 = 512  # matrices, K4 vs its plain version (the learned path's batch)
B_TIME_NET = (2048, 8192)  # K4 timing batches; the net forward at the last
B_CLI = 128  # scenes of the eval_net CLI check
CHEB_DEGREE = 48
B_K56 = 64  # matrices, K5/K6 vs their plain versions
B_K6_128 = 16  # matrices of side 120, K6 at P = 128 vs its plain version
B_TIME_TRAIN = (256, 2048)  # K5/K6 timing batches; 256 is the training batch
CHEB_REPS = 10  # timed calls per batch of K4, K5 and K6 (the median is reported)
GOLDEN_BATCH, GOLDEN_STEPS, GOLDEN_STEPS_PER_EPOCH = 64, 3, 27
TRAIN_ARGS = ("--num-layers", "3", "--g-mode", "chebyshev", "--cheb-impl", "pallas",
              "--head", "spectrum", "--assignment", "perm", "--spectral-weight", "0.5",
              "--batch-size", "256", "--lr", "1e-3", "--epochs", "15", "--patience", "100",
              "--seed", "0")  # runs/train_net3_r05/config.json
F1_BAND = 0.005  # random-scene gate: F1 >= eigh control - band
# The escape hatch of the classical solve: the lists layout (K3), and the
# same knobs on the lean layout (K2's unfolded carry), at bench.py's pinned
# control point (sched2, a 4/3 cold root, final_hi off).
HATCH = dict(g_update="fused_fast", fused_fold_diag=False, fused_warm_root=False,
             fused_proj_iters=4, fused_inner_iters=3)
HATCH_DIFF_ITERS = 15
# K2/K3 at the plane side P = 128: the anchor's three targets on a 7 x 17
# grid (n = 119, lifted side 120), anchor_like_batch
B_P128 = 256
P128_GRID = (7, 17)
# runs/profile_lean.py's subtraction profile of K2's unfolded lean kernel
# (--profile-k2): the full kernel at two iteration counts splits the fixed
# per-call cost from the per-iteration slope, then each ablate variant at
# the high count; sched2, a 4/3 cold root, final_hi off, best of the calls
B_PROFILE = 8192
PROFILE_ITERS = (100, 25)
PROFILE_REPS = 3
B_ABLATE_CHECK = 512  # instances of each variant held against its plain version
# The parallel phase (26): the deploy solve sharded over a world-2 gloo
# fleet (both ranks on this card), the flagship net-10 (MN = 100) trained
# data-parallel on it and on a world-1 NCCL fleet, against the same runs
# in one process
B_PAR_SOLVE = 8192
PAR_STEPS = 20  # steps of the DDP runs: 20 epochs of one global batch each
PAR_BATCH = 256  # global batch (128 a rank at world 2)
PAR_LOSS_RTOL = 5e-4  # tests/test_mesh_training.py's mesh-vs-single tolerance
PAR_ZLAYER_TOL = 1e-5  # the ZLayer under 2 ranks vs the whole batch (fp32 sums reordered)
# DDP's first gradient vs one process's: fp32 sums in another order through
# 10 unrolled layers (the phase prints a reordering of the batch in one
# process beside it); a rank left with its half batch's gradient, without
# the all-reduce, lands percents away
PAR_GRAD_RTOL = 1e-3
PAR_SOLVE_RTOL = 1e-6  # the sharded solve when it is not bitwise
PAR_TIMEOUT = 600  # seconds a fleet may take before it is killed
# The card's published peaks (H100 SXM at 700 W, NVIDIA's datasheet):
# fp32 outside the tensor cores, dense bf16 on the tensor cores (products
# of bf16-valued operands accumulated in fp32), and device memory bandwidth.
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12  # dense TF32 on the tensor cores
PEAK_BYTES = 3.35e12
# K4/K5's body (csrc/cheb_filter.cu), named in the kernels summary
CHEB_FWD_BODY = ("one thread-block cluster of P / 16 CTAs per matrix, bands in shared "
                 "memory, 3xTF32 mma.sync products (tc_product.cuh)")
# K1's and K7's body (csrc/polar_cta.cuh), named in the kernels summary
POLAR_BODY = ("one CTA per matrix or instance (a cluster of two at P = 128), the planes in "
              "shared memory, each whole product a 3xTF32 mma.sync product of the CTA "
              "(polar_cta.cuh); bf16_store's low steps in fp32 FMAs")
POLAR_REPS = 10  # timed calls of K1 per mode (--time-polar; the median is reported)
K7_REPS = 3  # timed calls of K7 per projection depth (--time-polar)

# Tolerances, with their reasons:
# - K1 vs eigh: the schedules' own accuracy (tests/test_polar.py).
K1_EIGH_TOL = {"accurate": 2e-4, "fast": 5e-4, "fast+polish": 5e-4}
# - K1 vs its plain version: both fp32; the sums run in another order,
#   which the quintic's large first-step coefficients amplify ~10x
#   (measured 5e-6 on an H100).
K1_PLAIN_TOL = 1e-4
# - K2 vs its plain version, median / max per-instance relative error of phi
#   after 100 iterations: fp32 sums in another order, carried through 100
#   iterations and the H-projection's bisection decisions (measured on an
#   H100: fused_fast 2.3e-6 / 3.6e-6, fused_exact 4.8e-5 / 2.3e-4).
K2_PLAIN_TOL = {"median": 1e-4, "max": 2e-3}
# - phi NMSE (scale-invariant, float64) vs the committed eigh golden.
EXACT_NMSE_TOL = 1e-5
POLAR_NMSE_TOL = 1e-5
EIGH_NMSE_TOL = 1e-5
FAST_NMSE_TOL = 0.2  # detection-grade contract; reference band ~0.06
K7_NMSE_TOL = 1e-5  # the phi-faithful gate that polar and fused_exact pass
# - K3 and K2's unfolded carry vs their plain versions, median / max
#   per-instance relative error of phi after 100 iterations: ~10x the
#   measured 2.58e-6 / 3.81e-6 (K3) and 2.68e-6 / 4.04e-6 (unfolded K2) on
#   an H100.
HATCH_PLAIN_TOL = {"median": 3e-5, "max": 5e-5}
# - K3 / K2's unfolded carry vs each other and vs the folded K2, 15
#   iterations, max per-instance relative error: the JAX package's bands
#   (tests/test_fused_fast.py: lean vs lists 5e-5, folded vs unfolded 1e-3).
LISTS_VS_LEAN_TOL = 5e-5
FOLD_VS_UNFOLDED_TOL = 1e-3
# - K7 vs its plain version, median / max per-instance relative error of phi
#   after 100 iterations: fp32 sums in another order, amplified by the
#   quintic's large first-step coefficients (~10x the measured median 8.28e-5
#   / max 1.92e-4 at B = 512 on an H100); vs the port's per-step polar solve
#   at 15 iterations, tests/test_fused_kernel.py's bound.
K7_PLAIN_TOL = {"median": 8e-4, "max": 2e-3}
K7_POLAR_TOL = 5e-4
# - K1 with bf16 iterate storage: vs eigh, tests/test_polar.py's bound.
#   Vs its plain version, per-matrix relative error: where the fp32 sums of
#   a product run in another order, one bf16 rounding can flip (2^-8
#   relative) and the later low steps carry it, so a few matrices sit
#   ~3e-3 away (max; measured on an H100 at B = 512: 4.25e-3 with 494
#   matrices bitwise equal at hi_steps 0, 2.92e-3 with none bitwise at 1,
#   where the fp32 polish step reorders every sum); the median matrix
#   agrees to fp32 noise (measured 0 / 9.7e-8), far below one flip.
#   A kernel that skips or misplaces the rounding sits ~3e-3-5e-3 from the
#   plain version on every matrix, so the median gate fails it, and the
#   gate against the fp32 store requires the rounding to show (measured
#   median 4.30e-3 / 3.06e-3 at hi_steps 0 / 1).
K1_BF16_EIGH_TOL = 8e-3
K1_BF16_PLAIN_TOL = {"median": 1e-5, "max": 1e-2}
K1_BF16_VS_FP32_MIN = 1e-3  # median per-matrix distance from the fp32 store
# - K4 vs its plain version, max per-matrix relative error: both fp32, the
#   sums in another order through 48 dependent Clenshaw steps; ~10x the
#   measured 5.6e-6 (spiked matrices; 5.7e-7 random) on an H100.
K4_PLAIN_TOL = 5e-5
# - net-3 trunk phi vs the JAX golden (fp32 on the CPU), per-scene relative
#   error: fp32 sums in another order through three layers; ~10x the
#   measured median 1.9e-6 / max 4.2e-6 on an H100.
NET3_PHI_TOL = {"median": 2e-5, "max": 5e-5}
# - eval_net on the card vs on the CPU: the same detections up to one
#   flipped match (1 / 384 targets = 0.0026), RMSEs over the same pairs.
CLI_DET_TOL = 0.005
CLI_RMSE_TOL = 1e-3
# - K5's carries and K6's (Mbar, cbar) vs their plain versions on the same
#   inputs, and K6's Hermitian-projected Mbar vs torch autograd through the
#   plain forward, max per-matrix relative error: fp32 sums in another
#   order through 47 forward steps and 46 rebuilt ones.
#   ~10x the measured on an H100 with K6's fp32 SIMT products: carries
#   1.2e-5; K6 Mbar 1.1e-6, cbar 4.3e-6; vs autograd 8.8e-7 / 4.7e-6.  K6's
#   3xTF32 tensor-core products (~2^-22 per product) are held to the same
#   limits.
K5_PLAIN_TOL = 1e-4
K6_PLAIN_TOL = {"Mbar": 2e-5, "cbar": 5e-5}
K6_AUTOGRAD_TOL = 5e-5
# - three net-3 recipe steps vs the JAX golden (fp32 on the CPU): relative
#   error of each step's loss, and of the parameters' change over the steps
#   (||p - p_jax|| / ||p_jax - p_init||) over all leaves, which Adam's
#   normalization amplifies where a gradient is near zero; ~14x and ~8x
#   the measured 7.3e-8 and 9.0e-3 on an H100.
GOLDEN_LOSS_TOL = 1e-6
GOLDEN_PARAM_TOL = 0.07
# - the training run: the port's net-3 trained on the card from scratch vs
#   the committed net-3 checkpoint, matched test F1 on the same split; and
#   the test loss, the quantity training minimizes, must close at least
#   this share of the gap between the seed-0 init's test loss and the
#   committed checkpoint's (measured on an H100: 0.85 of it, and matched
#   F1 0 for the init against 0.8856 for both trained nets).
TRAIN_F1_BAND = 0.01
TRAIN_LOSS_GAP_CLOSED = 0.5


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def rel_err(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-instance relative Frobenius error of a against b."""
    a = a.reshape(a.shape[0], -1)
    b = b.reshape(b.shape[0], -1)
    return torch.linalg.norm(a - b, dim=-1) / torch.linalg.norm(b, dim=-1)


def cuda_ms(fn, reps: int = 1) -> float:
    """Mean ms per call by CUDA events, after one warm call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def random_hermitian(rng, B, m, dev):
    X = rng.normal(size=(B, m, m)) + 1j * rng.normal(size=(B, m, m))
    M = np.ascontiguousarray((X + np.conj(np.swapaxes(X, -1, -2))) / 2, np.complex64)
    return torch.from_numpy(M).to(dev)


def to_dev(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


def bound(flops: float, nbytes: float, bf16_flops: float = 0.0):
    """(least ms the card could take, what bounds it) for work of ``flops``
    fp32 operations and ``bf16_flops`` operations on bf16-valued operands
    (accumulated in fp32) that must move ``nbytes`` bytes."""
    t_ops = flops / PEAK_FP32 + bf16_flops / PEAK_BF16
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def cheb_flops(B: int, m: int = 101, degree: int = CHEB_DEGREE) -> float:
    """Useful fp32 operations of K4: degree - 1 Karatsuba products (3 real
    m^3 products of 2 m^3 operations each) per matrix; the recurrence's
    first product is with b_1 = 0."""
    return B * (degree - 1) * 3 * 2.0 * m**3


def cheb_bytes(B: int, m: int = 101, degree: int = CHEB_DEGREE) -> float:
    """K4 reads M (complex64) and the coefficients once and writes G once."""
    return B * (2 * m * m * 8 + degree * 4)


def cheb_bwd_flops(B: int, m: int = 101, degree: int = CHEB_DEGREE) -> float:
    """Useful fp32 operations of K6: 3 degree - 5 Karatsuba products per
    matrix."""
    return B * (3 * degree - 5) * 3 * 2.0 * m**3


def cheb_bwd_bytes(B: int, m: int = 101, degree: int = CHEB_DEGREE) -> float:
    """K6 reads M, Y (complex64), the four carry planes and the
    coefficients once and writes Abar and cbar once."""
    return B * (3 * m * m * 8 + 4 * m * m * 4 + 2 * degree * 4)


def cheb_inputs(rng, B: int, dev, m: int = 101, degree: int = CHEB_DEGREE):
    """Random Hermitian matrices, the second half with a dominant eigenvalue
    (A's spectral radius near 1, as the GLayer's lifted matrices have), the
    last one zero, with coefficients and a random cotangent."""
    M = random_hermitian(rng, B, m, dev)
    v = torch.from_numpy(rng.normal(size=(B // 2, m)) + 1j * rng.normal(size=(B // 2, m)))
    v = (v / torch.linalg.norm(v, dim=-1, keepdim=True)).to(torch.complex64).to(dev)
    M[B // 2:] += 300.0 * v[:, :, None] * v.conj()[:, None, :]
    M[-1] = 0
    c = torch.from_numpy((rng.normal(size=(B, degree)) * 0.3).astype(np.float32)).to(dev)
    Y = torch.from_numpy((rng.normal(size=(B, m, m)) + 1j * rng.normal(size=(B, m, m))
                          ).astype(np.complex64)).to(dev)
    return M, c, Y


def k4_inputs(B: int, dev):
    """Phase 12's K4 timing inputs at batch B (seed 3): random Hermitian
    matrices and coefficients."""
    rng = np.random.default_rng(3)
    M = random_hermitian(rng, B, 101, dev)
    c = torch.from_numpy((rng.normal(size=(B, CHEB_DEGREE)) * 0.3).astype(np.float32)).to(dev)
    return M, c


def cheb_bounds(B: int, carries: bool):
    """(3xTF32 bound ms, what bounds it, fp32 SIMT bound ms) of K4, or of
    K5 (which also writes the four carry planes) at batch B."""
    nbytes = cheb_bytes(B) + (B * 4 * 101 * 101 * 4 if carries else 0)
    b, by = tf32x3_bound(cheb_flops(B), nbytes)
    return b, by, bound(cheb_flops(B), nbytes)[0]


def fp64_distances(kc, M, c, carries):
    """Max per-matrix relative distance of K5's carries (padded planes) and
    of the fp32 plain version's from the fp64 plain evaluation, the last
    (zero) matrix left out: how far from fp32-faithful the 3xTF32 products
    leave the recurrence, beside fp32's own distance."""
    m = M.shape[-1]
    _, p32 = kc.cheb_filter_matrices_plain_with_residuals(M, c, CHEB_DEGREE)
    _, p64 = kc.cheb_filter_matrices_plain_with_residuals(M.to(torch.complex128), c.double(),
                                                          CHEB_DEGREE)
    dk = max(float(rel_err(k[:-1, :m, :m].double(), q[:-1]).max()) for k, q in zip(carries, p64))
    dp = max(float(rel_err(p[:-1].double(), q[:-1]).max()) for p, q in zip(p32, p64))
    return dk, dp


def k6_inputs(kc, B: int, dev):
    """Phase 17's K6 timing inputs at batch B (seed 5): M, c, Y and K5's
    carries."""
    M, c, Y = cheb_inputs(np.random.default_rng(5), B, dev)
    return M, c, Y, kc.cheb_fwd_planes(M, c, CHEB_DEGREE)[2]


def k4_call_ms(M, c) -> list:
    """ms of each of CHEB_REPS back-to-back K4 calls through the GLayer's
    entry point (call_ms)."""
    from admmnet_tpu_torch.kernels.cheb_filter import cheb_filter_matrices

    return call_ms(lambda: cheb_filter_matrices(M, c, CHEB_DEGREE), CHEB_REPS)


def k5_call_ms(kc, M, c) -> list:
    """ms of each of CHEB_REPS back-to-back K5 calls (call_ms)."""
    return call_ms(lambda: kc.cheb_fwd_planes(M, c, CHEB_DEGREE), CHEB_REPS)


def k6_call_ms(kc, M, c, Y, carries) -> list:
    """ms of each of CHEB_REPS back-to-back K6 calls (call_ms)."""
    return call_ms(lambda: kc.cheb_bwd(M, c, carries, Y, CHEB_DEGREE), CHEB_REPS)


def anchor_like_batch(B: int, Nb: int, Nd: int, seed: int):
    """(y, b, sigma) numpy rows of the anchor's three targets on an Nb x Nd
    grid (n = Nb Nd), as make_anchor_batch builds them at 10 x 10: fresh
    QPSK symbols, demodulation errors at 7 dB, observation noise at 20 dB,
    sigma = ||e / b|| + 1."""
    from admmnet_tpu_torch.data.anchor import ANCHOR_C, ANCHOR_F, ANCHOR_TAU, _psi

    rng = np.random.default_rng(seed)
    n = Nb * Nd
    sym = np.exp(1j * (np.pi / 2 * rng.integers(0, 4, size=(B, n)) + np.pi / 4))
    noise = np.sqrt(10 ** -0.7 / 2) * (rng.standard_normal((B, n))
                                       + 1j * rng.standard_normal((B, n)))
    quad = np.floor(np.mod(np.angle(sym + noise), 2 * np.pi) * 2 / np.pi).astype(int) % 4
    b = np.exp(1j * (np.pi / 2 * quad + np.pi / 4))
    e = sym - b
    clean = sym * _psi(ANCHOR_TAU, ANCHOR_F, ANCHOR_C, Nb, Nd)[None]
    w_var = np.linalg.norm(clean, axis=-1, keepdims=True) ** 2 / (100.0 * n)
    y = clean + np.sqrt(w_var / 2) * (rng.standard_normal((B, n))
                                      + 1j * rng.standard_normal((B, n)))
    sigma = np.linalg.norm(e / b, axis=-1) + 1.0
    return y.astype(np.complex64), b.astype(np.complex64), sigma.astype(np.float32)


def call_ms(fn, reps: int) -> list:
    """ms of each of ``reps`` back-to-back calls, by CUDA events between
    them, after one warm call."""
    fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    events[0].record()
    for e in events[1:]:
        fn()
        e.record()
    events[-1].synchronize()
    return [a.elapsed_time(b) for a, b in zip(events, events[1:])]


def device_profile(fn):
    """(device busy us, window us, [(kernel name, device us)] largest
    first) of one call of ``fn`` under torch.profiler, or None when the
    profiler shows no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    kernels = [(e.key, e.device_time_total) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    busy = sum(t for _, t in kernels)
    if busy == 0:
        return None
    return busy, window_us, sorted(kernels, key=lambda kt: -kt[1])


def k2_profile(dev, tag: str) -> dict:
    """runs/profile_lean.py's subtraction profile of K2's unfolded lean
    kernel on the card, and each ablate variant held against its plain
    version (the same arithmetic, so the unfolded carry's limits).  The
    norm, zupd and finals variants change the values that flow on, so their
    marginals can read negative (RESULTS.md 3.6): they are reported as
    read, not subtracted into a total."""
    from admmnet_tpu_torch.data.anchor import make_anchor_batch
    from admmnet_tpu_torch.kernels import fused_admm_fast as kf
    from admmnet_tpu_torch.ops.projections import POLAR_BF16_SCHED2

    kw = dict(hi_steps=0, outer_iters=4, inner_iters=3, schedule=POLAR_BF16_SCHED2,
              final_hi=False, layout="lean", fold_diag=False)
    y, b, s = to_dev(dev, *make_anchor_batch(B_ABLATE_CHECK, "redemod", seed=0))
    for ablate in kf.ABLATE[1:]:
        pk = kf.admm_solve_fused_fast(y, b, s, ITERS, 1.0, 1.0, ablate=ablate, **kw)
        pp = kf.admm_solve_fused_fast_plain(y, b, s, ITERS, 1.0, 1.0, ablate=ablate, **kw)
        torch.cuda.synchronize()
        check(bool(torch.all(torch.isfinite(torch.view_as_real(pk)))),
              f"K2 ablate={ablate}: non-finite phi")
        e = rel_err(pk, pp)
        med, mx = float(e.median()), float(e.max())
        log(f"[25 K2 ablate={ablate}] B={B_ABLATE_CHECK} x {ITERS} iters: kernel vs plain "
            f"per-instance rel err median {med:.3e} (tol {HATCH_PLAIN_TOL['median']:g}), max "
            f"{mx:.3e} (tol {HATCH_PLAIN_TOL['max']:g})")
        check(med < HATCH_PLAIN_TOL["median"] and mx < HATCH_PLAIN_TOL["max"],
              f"K2 ablate={ablate} disagrees with its plain version")

    y, b, s = to_dev(dev, *make_anchor_batch(B_PROFILE, "redemod", seed=0))

    def best(iters: int, ablate: str) -> float:
        calls = call_ms(lambda: kf.admm_solve_fused_fast(y, b, s, iters, 1.0, 1.0,
                                                          ablate=ablate, **kw), PROFILE_REPS)
        log(f"[25 profile K2] ablate={ablate} iters={iters}: best {min(calls):.3f} ms of "
            f"{' '.join(f'{t:.3f}' for t in calls)} {tag}")
        return min(calls)

    hi, lo = PROFILE_ITERS
    t_hi, t_lo = best(hi, "none"), best(lo, "none")
    slope = (t_hi - t_lo) / (hi - lo)
    fixed = t_hi - hi * slope
    out = {"ms_per_iter": slope, "fixed_ms": fixed, "ms": t_hi}
    log(f"[25 profile K2] B={B_PROFILE}, sched2, 4/3 cold root, final_hi off: full "
        f"{slope:.4f} ms/iter, fixed per call {fixed:.3f} ms {tag}")
    for ablate in kf.ABLATE[1:]:
        marginal = slope - (best(hi, ablate) - fixed) / hi
        out[ablate] = marginal
        log(f"[25 profile K2] -> {ablate}: marginal {marginal:.4f} ms/iter "
            f"({marginal / slope:.1%} of the full slope) {tag}")
    log("[25 profile K2] " + json.dumps({k: round(v, 5) for k, v in out.items()}))
    return out


def anchor_scores(phi: torch.Tensor, pcfg) -> dict:
    """``match_peaks`` stats of the top-3 peaks of anchor solves against the
    anchor's three targets."""
    from admmnet_tpu_torch.data.anchor import ANCHOR_F, ANCHOR_TAU
    from admmnet_tpu_torch.peaks import find_peaks, match_peaks

    pk = find_peaks(phi, 10, 10, pcfg)
    B = phi.shape[0]
    return match_peaks(pk.tau.cpu().numpy()[:, :3], pk.f.cpu().numpy()[:, :3],
                       np.broadcast_to(ANCHOR_TAU, (B, 3)), np.broadcast_to(ANCHOR_F, (B, 3)),
                       0.05, 0.05)


def random_scores(phi: torch.Tensor, raw: dict, pcfg) -> dict:
    """``match_peaks`` stats of the top-3 peaks of solves of the random
    scenes against their targets."""
    from admmnet_tpu_torch.peaks import find_peaks, match_peaks

    pk = find_peaks(phi, 10, 10, pcfg)
    return match_peaks(pk.tau.cpu().numpy()[:, :3], pk.f.cpu().numpy()[:, :3], raw["tau"],
                       raw["f"], 0.05, 0.05)


def solve_flops(n_inst_iters: int, nsteps: int, n: int = 100) -> float:
    """Useful fp32 operations of a fused solve: 9 real products per schedule
    step and 3 closing ones per instance-iteration, at the logical side
    n + 1."""
    return n_inst_iters * (9 * nsteps + 3) * 2.0 * (n + 1) ** 3


def cheb_fwd_smem_bytes(P: int) -> int:
    """cheb_filter.cu's dynamic shared memory a CTA: 6 band planes of
    16 (P + 4) floats, the staging double buffer of 4 x 16 (P + 8) and 16
    floats of partials and slot."""
    return 4 * (6 * 16 * (P + 4) + 4 * 16 * (P + 8) + 16)


def tc_solve_smem_bytes(P: int) -> int:
    """fused_solve_tc.cuh's dynamic shared memory a CTA: 8 band planes of
    16 (P + 4) floats, the staging double buffer of 4 x 16 (P + 8), 10 rows
    of 128 and 80 slot floats."""
    return 4 * (8 * 16 * (P + 4) + 4 * 16 * (P + 8) + 10 * 128 + 80)


def log_ptxas(tag: str) -> None:
    """Phase 2's ptxas report of this process's build: registers and spills
    of every instantiation, demangled."""
    from admmnet_tpu_torch.kernels import _build

    for name, text in _build.build_logs.items():
        entry = ""
        for ln in text.splitlines():
            if "Compiling entry function" in ln:
                entry = demangle(ln.split("'")[1])
            elif "registers" in ln or "spill" in ln:
                log(f"{tag}   {name} {entry}: ptxas {ln.strip()}")


# kernel name fragment -> the TPU kernels it serves (phase 2's SASS count)
SASS_KEYS = {"cheb_filter_kernel": "K4/K5", "cheb_bwd_kernel": "K6", "fused_tc_kernel": "K2/K3",
             "polar_cta_kernel": "K1", "fused_cta_kernel": "K7"}


def sass_counts() -> dict:
    """{mangled name: (key, HMMA, LDL, STL)} of the built library's kernels
    named in SASS_KEYS, from ``cuobjdump -sass``."""
    import re
    import shutil

    from admmnet_tpu_torch.kernels import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(_build.library_path())], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    found = {}
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        name = block.split("\n", 1)[0].strip()
        key = next((v for k, v in SASS_KEYS.items() if k in name), None)
        if key is not None:
            found[name] = (key, block.count("HMMA"), block.count("LDL"), block.count("STL"))
    return found


def polar_cta_smem_bytes(P: int, k7: bool) -> int:
    """polar_cta.cuh's dynamic shared memory a CTA: four planes of P / NC
    rows of P + 8 floats (NC = 1 at P = 112, 2 at P = 128), at NC = 2 a
    stage of the peer's rows of two planes, and 64 slot floats; K7 adds 12
    rows of 128 floats."""
    nc = 1 if P == 112 else 2
    rows = P // nc
    return 4 * ((4 + 2 * (nc - 1)) * rows * (P + 8) + 64 + (12 * 128 if k7 else 0))


def polar_bounds(B: int, nsteps: int, m: int = 101):
    """(3xTF32 bound ms, what bounds it, fp32 SIMT bound ms) of K1 with
    nsteps schedule steps at batch B: 9 real m^3 products a step and 3
    closing ones, against one read of M and one write of P."""
    flops = B * (9 * nsteps + 3) * 2.0 * m**3
    nbytes = B * 2 * m * m * 8
    b, by = tf32x3_bound(flops, nbytes)
    return b, by, bound(flops, nbytes)[0]


def demangle(name: str) -> str:
    """A C++ symbol's readable name (c++filt where the machine has it)."""
    import shutil

    tool = shutil.which("c++filt")
    if tool is None:
        return name
    out = subprocess.run([tool, name], capture_output=True, text=True, timeout=60)
    return out.stdout.strip() or name


def tf32x3_bound(flops: float, nbytes: float):
    """(bound ms, what bounds it) of fp32-faithful products run in 3xTF32
    on the tensor cores: three TF32 products per useful one."""
    t_ops, t_bytes = 3 * flops / PEAK_TF32, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def solve_bytes(B: int, n: int = 100) -> float:
    """A fused solve reads its (B, n) rows (y/b, w) and A once and writes phi."""
    return B * ((3 * n + 1) * 4 + n * 8)


def herm(X: torch.Tensor) -> torch.Tensor:
    return 0.5 * (X + X.conj().transpose(-1, -2))


def param_change_error(after: dict, golden_after: dict, init: dict) -> float:
    """||p - p_gold|| / ||p_gold - p_init|| over every leaf of state_dicts."""
    num = sum(float(torch.sum((after[k].cpu() - golden_after[k]) ** 2)) for k in init)
    den = sum(float(torch.sum((golden_after[k] - init[k]) ** 2)) for k in init)
    return (num / den) ** 0.5


def golden_steps(dev):
    """Three net-3 recipe steps on ``dev`` from the JAX golden's init, on the
    golden's batches: (losses, golden losses, parameter change error)."""
    from admmnet_tpu_torch.core.convert import options_from_jax, params_from_jax
    from admmnet_tpu_torch.models import ADMMNet
    from admmnet_tpu_torch.train.checkpoint import msgpack_decode
    from admmnet_tpu_torch.train.schedules import sgdr_schedule
    from admmnet_tpu_torch.train.trainer import batch_to_device, build_steps, make_optimizer

    run = json.loads((NET3 / "config.json").read_text())
    cfg = options_from_jax(run["model"])
    tcfg = options_from_jax(run["train"])
    gold = msgpack_decode(GOLDEN_TRAIN.read_bytes())
    init = params_from_jax(gold["init"]["params"], cfg)
    after_gold = params_from_jax(gold["after"]["params"], cfg)
    model = ADMMNet(cfg)
    model.load_state_dict(init)
    model.to(dev)
    opt = make_optimizer(model, tcfg)
    sched = sgdr_schedule(tcfg.lr, GOLDEN_STEPS_PER_EPOCH, tcfg.epochs, tcfg.sgdr_t0,
                          tcfg.sgdr_t_mult, tcfg.lr_min)
    step, _ = build_steps(model, opt, "e2e", sched, tcfg.grad_clip, tcfg.assignment,
                          tcfg.spectral_weight)
    with np.load(RANDOM_SCENES) as d:
        raw = {k: d[k] for k in d.files}
    raw["L_true"] = np.full(len(raw["y"]), cfg.spec.L_max, np.int32)
    losses = []
    for i in range(GOLDEN_STEPS):
        batch = {k: v[i * GOLDEN_BATCH:(i + 1) * GOLDEN_BATCH] for k, v in raw.items()}
        losses.append(float(step(batch_to_device(batch, dev), i)))
    err = param_change_error(model.state_dict(), after_gold, init)
    return np.array(losses), np.asarray(gold["losses"], np.float64), err


def run_cli(main, argv) -> dict:
    """The last stdout line of a CLI's ``main(argv)``, parsed as JSON."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def net10_configs():
    """The flagship net-10 (MN = 100) with the net-3 recipe's other settings:
    chebyshev GLayer on the Clenshaw kernels, spectrum head, set-matched
    loss, spectral weight 0.5; PAR_STEPS epochs of one global batch."""
    from admmnet_tpu_torch.core.config import ModelConfig, ProblemSpec, TrainConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return (ModelConfig(spec=ProblemSpec(Nb=10, Nd=10, L_max=3), num_layers=10,
                        g_mode="chebyshev", cheb_impl="pallas", head="spectrum"),
            TrainConfig(batch_size=PAR_BATCH, epochs=PAR_STEPS, lr=1e-3, assignment="perm",
                        spectral_weight=0.5, patience=100, seed=0))


def cheb_counts() -> dict:
    from admmnet_tpu_torch.kernels import cheb_filter as kc

    return {"K4": kc.launches.count, "K5": kc.fwd_launches.count, "K6": kc.bwd_launches.count}


def net10_run(mesh, train, val, workdir, device=None) -> dict:
    """``net10_configs``' training of ``train`` (each epoch's step followed
    by a validation pass on ``val``, then a test pass on ``val``) through
    ``train_admmnet``, on ``mesh`` (a rank of a fleet) or on ``device`` in
    one process.  Returns the per-step losses, the validation losses, the
    test metrics, the parameters, the wall ms of each epoch after the first
    (step + validation, between the trainer's epoch logs) and the K4/K5/K6
    launches of the run."""
    from admmnet_tpu_torch.train.trainer import train_admmnet

    mcfg, tcfg = net10_configs()
    before = cheb_counts()
    stamps = []

    def log_fn(msg):
        if msg.startswith("epoch"):
            stamps.append(time.perf_counter())

    r = train_admmnet(mcfg, tcfg, train, val, test_data=val, workdir=workdir, log_fn=log_fn,
                      device=device, mesh=mesh)
    return {"train_loss": r.history["train_loss"], "val_loss": r.history["val_loss"],
            "test": r.test_metrics, "params": {k: v.numpy() for k, v in r.params.items()},
            "epoch_ms": list(np.diff(stamps) * 1e3),
            **{k: v - before[k] for k, v in cheb_counts().items()}}


def first_gradient(mesh, train, device=None) -> dict:
    """The gradient of the first training step of ``net10_configs`` from its
    seed-0 init, as the trainer takes it (``build_steps``: through
    DistributedDataParallel on a mesh, the ZLayers' mean over the fleet,
    clipped; the schedule at 0 so the step changes nothing), on this rank's
    slice of the global batch ``train``; flattened in parameter order."""
    from admmnet_tpu_torch.models import ADMMNet
    from admmnet_tpu_torch.parallel import bind_batch_mean
    from admmnet_tpu_torch.train.trainer import (batch_to_device, build_steps, init_model,
                                                 make_optimizer)

    mcfg, tcfg = net10_configs()
    dev = mesh.devices[0] if mesh is not None else device
    model = init_model(ADMMNet, mcfg, tcfg.seed, dev)
    bind_batch_mean(model, mesh)
    ddp = None
    if mesh is not None:
        ddp = torch.nn.parallel.DistributedDataParallel(
            model, device_ids=[dev.index], process_group=mesh.group,
            find_unused_parameters=True)
        (s, c), = mesh.local_slices(PAR_BATCH)
        train = {k: v[s:s + c] for k, v in train.items()}
    step, _ = build_steps(model, make_optimizer(model, tcfg), "e2e", lambda _: 0.0,
                          tcfg.grad_clip, tcfg.assignment, tcfg.spectral_weight, ddp=ddp,
                          group=None if mesh is None else mesh.group)
    step(batch_to_device(train, dev), 0)
    return torch.cat([p.grad.reshape(-1) for p in model.parameters()]).cpu().numpy()


def zlayer_halves(mesh, case, device=None) -> dict:
    """net-10's first ZLayer (seed-0 init) on this rank's half of ``case``
    (the whole batch without a mesh), its batch mean over the fleet:
    output, gradients of sum(w * output) in the inputs, and in the
    parameters."""
    from admmnet_tpu_torch.models import ADMMNet
    from admmnet_tpu_torch.parallel import bind_batch_mean
    from admmnet_tpu_torch.train.trainer import init_model

    mcfg, tcfg = net10_configs()
    dev = mesh.devices[0] if mesh is not None else device
    z = init_model(ADMMNet, mcfg, tcfg.seed, dev).trunk.z_0
    bind_batch_mean(z, mesh)
    s, c = mesh.local_slices(len(case["G"]))[0] if mesh is not None else (0, len(case["G"]))
    args = [torch.from_numpy(case[k][s:s + c]).to(dev).requires_grad_(True)
            for k in ("phi", "h", "G", "Z")]
    out = z(*args, 2)
    w = torch.from_numpy(case["w"][s:s + c]).to(dev)
    torch.sum(w.real * out.real + w.imag * out.imag).backward()
    return {"out": out.detach().cpu().numpy(),
            "inputs": [a.grad.cpu().numpy() for a in args],
            "params": np.concatenate([p.grad.reshape(-1).cpu().numpy()
                                      for p in z.parameters() if p.grad is not None])}


def zlayer_case(B: int = 16, n: int = 100, seed: int = 0) -> dict:
    """ZLayer inputs whose scenes differ in scale by up to 10x, so a mean
    over half of the batch differs from the mean over all of it."""
    rng = np.random.default_rng(seed)

    def cplx(*shape):
        return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)

    scale = np.geomspace(0.1, 1.0, B).astype(np.float32)[:, None, None]
    X = cplx(B, n + 1, n + 1)
    herm = ((X + np.conj(np.swapaxes(X, -1, -2))) * scale).astype(np.complex64)
    return {"phi": 0.3 * cplx(B, n), "h": (0.05 * rng.normal(size=(B, n))).astype(np.float32),
            "G": herm, "Z": (0.5 * herm).astype(np.complex64), "w": cplx(B, n + 1, n + 1)}


def deploy_solve(mesh=None, dev=None):
    """The deploy point (fused_fast, DETECTION_BUDGET_ITERS iterations, then
    PRODUCTION_PEAKS) on B_PAR_SOLVE anchor scenes: sharded over ``mesh``
    and gathered, or on ``dev`` in one process.  Returns phi and the peak
    lists as numpy (on a rank other than 0: None) and the K2 launches."""
    from admmnet_tpu_torch.core.config import DETECTION_BUDGET_ITERS, PRODUCTION_PEAKS, ADMMOptions
    from admmnet_tpu_torch.data.anchor import make_anchor_batch
    from admmnet_tpu_torch.kernels import fused_admm_fast
    from admmnet_tpu_torch.parallel import gather_batch, sharded_solver
    from admmnet_tpu_torch.peaks import find_peaks
    from admmnet_tpu_torch.solver import admm_solve_fixed

    opts = ADMMOptions(g_update="fused_fast")
    y, b, s = make_anchor_batch(B_PAR_SOLVE, mode="redemod", seed=0)
    fused_admm_fast.launches.reset()
    if mesh is None:
        phi = admm_solve_fixed(*to_dev(dev, y, b, s), DETECTION_BUDGET_ITERS, 1.0, opts)
        peaks = find_peaks(phi, 10, 10, PRODUCTION_PEAKS)
    else:
        shards = sharded_solver(mesh, DETECTION_BUDGET_ITERS, opts=opts)(y, b, s)
        peaks = gather_batch([find_peaks(p, 10, 10, PRODUCTION_PEAKS) for p in shards], mesh)
        phi = gather_batch(shards, mesh)
    launches = fused_admm_fast.launches.count
    if mesh is not None and not mesh.is_main:
        return None, None, launches
    return (phi.cpu().numpy(), {k: v.cpu().numpy() for k, v in peaks._asdict().items()},
            launches)


def parallel_rank(mesh, train, val, workdir, case) -> dict:
    """Phase 26 (a) and (b) on one rank of the world-2 gloo fleet."""
    start = cheb_counts()
    phi, peaks, k2 = deploy_solve(mesh)
    z = zlayer_halves(mesh, case)
    grad = first_gradient(mesh, train)
    out = net10_run(mesh, train, val, workdir)
    del out["params"]
    return {**out, "phi": phi, "peaks": peaks, "K2": k2, "zlayer": z, "grad": grad,
            "total": {k: v - start[k] for k, v in cheb_counts().items()}}


def bitwise_or_rel(a: np.ndarray, b: np.ndarray):
    """(equal bit for bit, largest difference relative to b's largest
    magnitude)."""
    if np.array_equal(a, b):
        return True, 0.0
    finite = np.isfinite(b)
    diff = np.abs(np.where(a == b, 0.0, a.astype(np.float64) - b))
    return False, float(np.max(diff) / max(float(np.max(np.abs(b[finite]))), 1e-30))


class Smoke:
    def __init__(self):
        from admmnet_tpu_torch.core.config import ADMMOptions

        self.dev = torch.device("cuda", 0)
        self.card = card()
        self.prod = ADMMOptions(g_update="fused_fast")
        self.exact = ADMMOptions(g_update="fused_exact")
        self.kernels = {}

    # 1 -------------------------------------------------------------------
    def device(self):
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the port's smoke test needs one GPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        log(f"[1 device] nvidia-smi: {self.card}; torch: "
            f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
            f"torch {torch.__version__} cuda {torch.version.cuda}; "
            f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
            f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # 2 -------------------------------------------------------------------
    def build(self):
        from admmnet_tpu_torch.kernels import _build

        t0 = time.time()
        _build.lib()
        secs = time.time() - t0
        log(f"[2 build] K1 polar.cu (body polar_cta.cuh) + K2/K3 fused_admm_fast.cu (P = 128:"
            f" fused_admm_fast_p128.cu; ablate: fused_admm_fast_ablate{{,_p128}}.cu; body"
            f" fused_solve_tc.cuh)"
            f" + K7 fused_admm.cu + K4/K5 cheb_filter.cu + K6 cheb_bwd.cu (products"
            f" tc_product.cuh), one nvcc each in "
            f"parallel: {secs:.1f} s (nvcc "
            f"{_build.build_seconds}) -> "
            f"{_build.library_path().name}")
        if _build.compile_seconds:
            log("[2 build] nvcc wall seconds per source: " + ", ".join(
                f"{name} {secs:.1f}" for name, secs in sorted(_build.compile_seconds.items())))
        log_ptxas("[2 build]")
        for P in (112, 128):
            log(f"[2 build] K2/K3 dynamic shared memory a CTA at P = {P}: "
                f"{tc_solve_smem_bytes(P)} B (fused_solve_tc.cuh's count); K4/K5 "
                f"{cheb_fwd_smem_bytes(P)} B (cheb_filter.cu's count); K1 "
                f"{polar_cta_smem_bytes(P, False)} B, K7 {polar_cta_smem_bytes(P, True)} B "
                f"(polar_cta.cuh's count)")

    def tc_sass(self):
        """The products of K1, K2/K3, K4/K5, K6 and K7 reach the tensor cores:
        HMMA instructions in the SASS of every instantiation."""
        found = sass_counts()
        for name, (key, hmma, ldl, stl) in sorted(found.items()):
            log(f"[2 {key} SASS] {demangle(name)}: {hmma} HMMA, {ldl} LDL / {stl} STL "
                f"(local memory)")
        hmma = {v: [h for k, h, _, _ in found.values() if k == v] for v in SASS_KEYS.values()}
        # K4/K5 and K6 at P = 112, 128; K2/K3: 5 instantiations and 7 ablate
        # variants at each of P = 112, 128; K1 with and without bf16_store
        # and K7 at each of P = 112, 128
        check([len(hmma[k]) for k in ("K4/K5", "K6", "K2/K3", "K1", "K7")] == [2, 2, 24, 4, 2]
              and min(sum(hmma.values(), [])) > 0,
              "a tensor-core kernel's SASS has no HMMA instruction")

    # 3 -------------------------------------------------------------------
    def k1_vs_plain(self):
        from admmnet_tpu_torch.kernels.polar import (
            psd_project_polar_kernel,
            psd_project_polar_plain,
        )
        from admmnet_tpu_torch.ops.projections import psd_project_eigh

        rng = np.random.default_rng(0)
        M = random_hermitian(rng, B_K1, 101, self.dev)
        M[-1] = 0  # an all-zero matrix must come back exactly zero
        Pe = psd_project_eigh(M[:-1])
        worst_abs = 0.0
        for label, mode, hs in (("accurate", "accurate", None), ("fast", "fast", None),
                                ("fast+polish", "fast", 1)):
            Pk = psd_project_polar_kernel(M, mode=mode, hi_steps=hs)
            Pp = psd_project_polar_plain(M, mode=mode, hi_steps=hs)
            torch.cuda.synchronize()
            check(bool(torch.all(Pk[-1] == 0)), f"K1 {label}: zero matrix not zero")
            e_plain = float(rel_err(Pk, Pp)[:-1].max())
            e_eigh = float(rel_err(Pk[:-1], Pe).max())
            e_plain_eigh = float(rel_err(Pp[:-1], Pe).max())
            worst_abs = max(worst_abs, float((Pk - Pp).abs().max()))
            log(f"[3 K1 {label}] B={B_K1} m=101: kernel vs plain max rel "
                f"{e_plain:.3e} (tol {K1_PLAIN_TOL:g}); kernel vs eigh {e_eigh:.3e}, "
                f"plain vs eigh {e_plain_eigh:.3e} (tol {K1_EIGH_TOL[label]:g})")
            check(e_plain < K1_PLAIN_TOL, f"K1 {label} disagrees with its plain version")
            check(e_eigh < K1_EIGH_TOL[label], f"K1 {label} too far from eigh")
        # the P = 128 plane path (113 <= m <= 128)
        M2 = random_hermitian(rng, 64, 120, self.dev)
        Pk = psd_project_polar_kernel(M2, mode="accurate")
        e128 = float(rel_err(Pk, psd_project_eigh(M2)).max())
        e128p = float(rel_err(Pk, psd_project_polar_plain(M2)).max())
        log(f"[3 K1 P=128] B=64 m=120 accurate: kernel vs eigh {e128:.3e} "
            f"(tol {K1_EIGH_TOL['accurate']:g}), vs plain {e128p:.3e} (tol {K1_PLAIN_TOL:g})")
        check(e128 < K1_EIGH_TOL["accurate"] and e128p < K1_PLAIN_TOL, "K1 P=128 path")
        self.kernels["K1"] = {"max_abs_err": worst_abs}

    # 4 -------------------------------------------------------------------
    def k2_vs_plain(self):
        from admmnet_tpu_torch.data.anchor import make_anchor_batch
        from admmnet_tpu_torch.kernels.fused_admm_fast import (
            admm_solve_fused_fast,
            admm_solve_fused_fast_plain,
        )
        from admmnet_tpu_torch.solver.admm import fused_kernel_options

        y, b, s = make_anchor_batch(B_SOLVE, "redemod", seed=0)
        self.anchor = to_dev(self.dev, y, b, s)
        self.anchor128 = to_dev(self.dev, *anchor_like_batch(B_P128, *P128_GRID, seed=0))
        worst_abs = 0.0
        for label, opts, B, rows in (("fused_fast", self.prod, B_SOLVE, self.anchor),
                                     ("fused_exact", self.exact, B_EXACT, self.anchor),
                                     ("fused_fast", self.prod, B_P128, self.anchor128),
                                     ("fused_exact", self.exact, B_P128, self.anchor128)):
            kw = fused_kernel_options(opts)
            yy, bb, ss = (x[:B] for x in rows)
            n = yy.shape[1]
            pk = admm_solve_fused_fast(yy, bb, ss, ITERS, opts.rho, 1.0, **kw)
            pp = admm_solve_fused_fast_plain(yy, bb, ss, ITERS, opts.rho, 1.0, **kw)
            torch.cuda.synchronize()
            check(bool(torch.all(torch.isfinite(torch.view_as_real(pk)))),
                  f"K2 {label} n={n}: non-finite phi")
            e = rel_err(pk, pp)
            med, mx = float(e.median()), float(e.max())
            worst_abs = max(worst_abs, float((pk - pp).abs().max()))
            log(f"[4 K2 {label}] B={B} n={n} x {ITERS} iters: kernel vs plain per-instance "
                f"rel err median {med:.3e} (tol {K2_PLAIN_TOL['median']:g}), "
                f"max {mx:.3e} (tol {K2_PLAIN_TOL['max']:g})")
            check(med < K2_PLAIN_TOL["median"] and mx < K2_PLAIN_TOL["max"],
                  f"K2 {label} n={n} disagrees with its plain version")
        self.kernels["K2"] = {"max_abs_err": worst_abs}

    # 5 -------------------------------------------------------------------
    def golden_gates(self):
        from admmnet_tpu_torch.core.config import ADMMOptions
        from admmnet_tpu_torch.peaks import scale_invariant_nmse
        from admmnet_tpu_torch.solver import admm_solve_fixed

        with np.load(GOLDEN_EIGH) as d:
            golden = d["phi"]
        y, b, s = self.anchor
        runs = (
            ("fused_exact", self.exact, B_EXACT, EXACT_NMSE_TOL),
            ("polar (K1 per step)", ADMMOptions(g_update="polar"), B_POLAR_SOLVE,
             POLAR_NMSE_TOL),
            ("eigh", ADMMOptions(g_update="eigh"), B_POLAR_SOLVE, EIGH_NMSE_TOL),
            ("fused_fast", self.prod, B_SOLVE, FAST_NMSE_TOL),
        )
        for label, opts, B, tol in runs:
            t0 = time.time()
            phi = admm_solve_fixed(y[:B], b[:B], s[:B], ITERS, 1.0, opts)
            phi = phi.cpu().numpy()
            secs = time.time() - t0
            check(bool(np.all(np.isfinite(phi.view(np.float32)))), f"{label}: non-finite phi")
            nmse = scale_invariant_nmse(phi, golden[:B])
            log(f"[5 golden {label}] B={B} x {ITERS}: phi NMSE vs phi_eigh_2048 "
                f"{nmse:.3e} (tol {tol:g}) [{secs:.1f} s]")
            check(nmse <= tol, f"{label}: phi NMSE {nmse:.3e} > {tol:g}")
            if label == "fused_fast":
                self.phi_fast = phi

    # 6 -------------------------------------------------------------------
    def main_path(self):
        from admmnet_tpu_torch.cli import main_classical
        from admmnet_tpu_torch.core.config import (
            DETECTION_BUDGET_ITERS,
            PRODUCTION_PEAKS,
            PeakSearchConfig,
        )
        from admmnet_tpu_torch.solver import admm_solve_fixed

        cli = run_cli(main_classical.main, ["--deploy", "--json", "--device", "cuda"])
        log(f"[6 cli --deploy] fixed anchor: F1 {cli['f1']} (need 1.0), peaks "
            f"{[[round(v, 4) for v in r[:2]] for r in cli['peaks']]}")
        check(cli["f1"] == 1.0 and cli["converged"] is None, "CLI --deploy")

        y, b, s = (x[:512] for x in self.anchor)
        for label, iters, pcfg in (("deploy", DETECTION_BUDGET_ITERS, PRODUCTION_PEAKS),
                                   ("full", ITERS, PeakSearchConfig(max_peaks=8))):
            st = anchor_scores(admm_solve_fixed(y, b, s, iters, 1.0, self.prod), pcfg)
            log(f"[6 anchor {label}] 512 scenes x {iters} iters fused_fast: F1 "
                f"{st['f1']:.4f} (need 1.0), tau RMSE {st['tau_rmse']:.5f}, "
                f"f RMSE {st['f_rmse']:.5f}")
            check(st["f1"] == 1.0, f"anchor F1 at {iters} iterations")

    # 7 -------------------------------------------------------------------
    def random_gate(self):
        from admmnet_tpu_torch.core.config import (
            DETECTION_BUDGET_ITERS,
            PRODUCTION_PEAKS,
            ADMMOptions,
            PeakSearchConfig,
        )
        from admmnet_tpu_torch.solver import admm_solve_fixed

        with np.load(RANDOM_SCENES) as d:
            raw = {k: d[k] for k in d.files}
        y, b, s = to_dev(self.dev, raw["y"], raw["b"], raw["sigma"])
        self.random = (raw, (y, b, s))
        f1 = {}
        for label, opts, iters, pcfg in (
            ("prod", self.prod, ITERS, PeakSearchConfig(max_peaks=8)),
            ("eigh", ADMMOptions(g_update="eigh"), ITERS, PeakSearchConfig(max_peaks=8)),
            ("deploy", self.prod, DETECTION_BUDGET_ITERS, PRODUCTION_PEAKS),
        ):
            t0 = time.time()
            st = random_scores(admm_solve_fixed(y, b, s, iters, 1.0, opts), raw, pcfg)
            f1[label] = st["f1"]
            log(f"[7 random {label}] {len(raw['y'])} scenes x {iters} iters: F1 "
                f"{st['f1']:.4f}, tau RMSE {st['tau_rmse']:.5f} [{time.time() - t0:.1f} s]")
        self.f1_eigh = f1["eigh"]
        for label in ("prod", "deploy"):
            ok = f1[label] >= f1["eigh"] - F1_BAND
            log(f"[7 random gate {label}] F1 {f1[label]:.4f} >= eigh control "
                f"{f1['eigh']:.4f} - {F1_BAND}: {ok}")
            check(ok, f"random-scene gate ({label})")

    # 8 -------------------------------------------------------------------
    def fused_fallback(self):
        """Above a lifted side of 128 the fused modes warn and run the loop
        with polar_fast / polar, as the JAX package does: no K2 launch."""
        import warnings

        from admmnet_tpu_torch.core.config import ADMMOptions
        from admmnet_tpu_torch.kernels import fused_admm_fast
        from admmnet_tpu_torch.solver import admm_solve_fixed

        rng = np.random.default_rng(0)
        n = 144
        y = (rng.normal(size=(4, n)) + 1j * rng.normal(size=(4, n))).astype(np.complex64)
        b = np.exp(2j * np.pi * rng.uniform(size=(4, n))).astype(np.complex64)
        s = rng.uniform(0.05, 0.2, size=4).astype(np.float32)
        y, b, s = to_dev(self.dev, y, b, s)
        for g, fallback in (("fused_fast", "polar_fast"), ("fused_exact", "polar")):
            before = fused_admm_fast.launches.count
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                phi = admm_solve_fixed(y, b, s, 5, 1.0, ADMMOptions(g_update=g))
            said = [str(w.message) for w in caught]
            ref = admm_solve_fixed(y, b, s, 5, 1.0, ADMMOptions(g_update=fallback))
            same = torch.equal(phi, ref)
            log(f"[8 fallback {g}] n={n} (lifted 145 > 128), 4 instances x 5 iters: warned "
                f"{said}; K2 launches {fused_admm_fast.launches.count - before}; phi equals the "
                f"{fallback} loop's bitwise: {same}")
            check(any(f"g_update={fallback!r}: lifted size 145 > 128" in w for w in said)
                  and fused_admm_fast.launches.count == before and same,
                  f"{g} above the kernel's side did not fall back to {fallback}")

    # 9 -------------------------------------------------------------------
    def timings(self):
        from admmnet_tpu_torch.core.config import DETECTION_BUDGET_ITERS, PRODUCTION_PEAKS
        from admmnet_tpu_torch.data.anchor import make_anchor_batch
        from admmnet_tpu_torch.kernels.fused_admm_fast import (
            admm_solve_fused_fast,
            admm_solve_fused_fast_plain,
        )
        from admmnet_tpu_torch.kernels.polar import (
            psd_project_polar_kernel,
            psd_project_polar_plain,
        )
        from admmnet_tpu_torch.peaks import find_peaks
        from admmnet_tpu_torch.solver import admm_solve_fixed
        from admmnet_tpu_torch.solver.admm import fused_kernel_options

        tag = f"[{self.card}]"
        y, b, s = to_dev(self.dev, *make_anchor_batch(B_TIME_K2, "redemod", seed=0))
        kw = fused_kernel_options(self.prod)
        k2 = cuda_ms(lambda: admm_solve_fused_fast(y, b, s, ITERS, 1.0, 1.0, **kw))
        k2p = cuda_ms(lambda: admm_solve_fused_fast_plain(y, b, s, ITERS, 1.0, 1.0, **kw))
        n_ii = B_TIME_K2 * ITERS
        flops = solve_flops(n_ii, len(kw["schedule"]))
        k2_bound, k2_by = tf32x3_bound(flops, solve_bytes(B_TIME_K2))
        k2_fp32, _ = bound(flops, solve_bytes(B_TIME_K2))
        log(f"[9 time K2 fused_fast] B={B_TIME_K2} x {ITERS}: kernel {k2:.1f} ms "
            f"({n_ii / k2 * 1e3:.0f} inst-iter/s), plain {k2p:.1f} ms "
            f"({n_ii / k2p * 1e3:.0f} inst-iter/s); 3xTF32 tensor-core bound {k2_bound:.1f} ms "
            f"({k2_by}; {k2_bound / k2:.1%} of it), fp32 SIMT bound {k2_fp32:.1f} ms "
            f"({k2_fp32 / k2:.1%} of it) {tag}")
        self.kernels["K2"].update(ms=k2, plain_ms=k2p, bound_ms=k2_bound, bound_by=k2_by,
                                  library_ms=None)

        M = random_hermitian(np.random.default_rng(1), B_TIME_K1, 101, self.dev)
        for mode in ("accurate", "fast"):
            k1 = cuda_ms(lambda: psd_project_polar_kernel(M, mode=mode), reps=3)
            k1p = cuda_ms(lambda: psd_project_polar_plain(M, mode=mode), reps=3)
            k1_bound, k1_by, k1_fp32 = polar_bounds(B_TIME_K1, 7 if mode == "accurate" else 6)
            log(f"[9 time K1 {mode}] B={B_TIME_K1} m=101: kernel {k1:.2f} ms, "
                f"plain {k1p:.2f} ms per call; 3xTF32 tensor-core bound {k1_bound:.2f} ms "
                f"({k1_by}; {k1_bound / k1:.1%} of it), fp32 SIMT bound {k1_fp32:.2f} ms "
                f"({k1_fp32 / k1:.1%} of it) {tag}")
            if mode == "accurate":
                self.kernels["K1"].update(ms=k1, plain_ms=k1p, bound_ms=k1_bound,
                                          bound_by=k1_by, library_ms=None, body=POLAR_BODY,
                                          fp32_bound_ms=k1_fp32)

        def deploy():
            pk = find_peaks(admm_solve_fixed(y, b, s, DETECTION_BUDGET_ITERS, 1.0, self.prod),
                            10, 10, PRODUCTION_PEAKS)
            return pk.tau

        dms = cuda_ms(deploy, reps=2)
        log(f"[9 time deploy] B={B_TIME_K2}, {DETECTION_BUDGET_ITERS} iters + "
            f"PRODUCTION_PEAKS: {dms / B_TIME_K2:.5f} ms/scene "
            f"({B_TIME_K2 / dms * 1e3:.0f} scenes/s) {tag}")
        prof = device_profile(deploy)
        if prof is None:
            log("[9 profile deploy] torch.profiler shows no device time; the CUDA-event "
                "time above stands alone")
            return
        busy, window_us, kernels = prof
        k2_us = sum(t for name, t in kernels if "fused_tc_kernel" in name)
        top = "; ".join(f"{name[:48]} {t / busy:.1%}" for name, t in kernels[:5])
        log(f"[9 profile deploy] B={B_TIME_K2}: device busy {busy / 1e3:.2f} ms of a "
            f"{window_us / 1e3:.2f} ms window ({busy / window_us:.1%}); K2 {k2_us / busy:.1%} "
            f"of device time, the rest (the peak search's products, max-pool and top-k, and "
            f"the solve's input rows) {1 - k2_us / busy:.1%} in {len(kernels) - 1} kernel "
            f"names; by device time: {top} {tag}")

    # 10 ------------------------------------------------------------------
    def k4_vs_plain(self):
        from admmnet_tpu_torch.kernels.cheb_filter import (
            cheb_filter_matrices,
            cheb_filter_matrices_plain,
            cheb_filter_planes,
        )

        rng = np.random.default_rng(2)
        m, D = 101, CHEB_DEGREE
        M = random_hermitian(rng, B_K4, m, self.dev)
        # second half: a dominant eigenvalue, so that A = M/||M||_F has a
        # spectral radius near 1, as the GLayer's lifted matrices do
        v = torch.from_numpy(rng.normal(size=(B_K4 // 2, m)) + 1j * rng.normal(size=(B_K4 // 2, m)))
        v = (v / torch.linalg.norm(v, dim=-1, keepdim=True)).to(torch.complex64).to(self.dev)
        M[B_K4 // 2:] += 300.0 * v[:, :, None] * v.conj()[:, None, :]
        M[-1] = 0  # a zero matrix
        c = torch.from_numpy((rng.normal(size=(B_K4, D)) * 0.3).astype(np.float32)).to(self.dev)
        Gk = cheb_filter_matrices(M, c, D)
        Gp = cheb_filter_matrices_plain(M, c, D)
        Gr, Gi = cheb_filter_planes(M, c, D)
        torch.cuda.synchronize()
        check(bool(torch.all(torch.isfinite(torch.view_as_real(Gk)))), "K4: non-finite output")
        e = rel_err(Gk[:-1], Gp[:-1])
        half = B_K4 // 2
        e_gue, e_spike = float(e[:half].max()), float(e[half:].max())
        z = Gk[-1]
        zero_ok = bool(torch.equal(z, Gp[-1])) and bool(torch.all(z - torch.diag(z.diagonal()) == 0))
        pad_ok = all(bool(torch.all(X[:, m:, :] == 0)) and bool(torch.all(X[:, :, m:] == 0))
                     for X in (Gr, Gi))
        self.kernels["K4"] = {"max_abs_err": float((Gk - Gp).abs().max())}
        log(f"[10 K4 vs plain] B={B_K4} m={m} degree {D}: max per-matrix rel err "
            f"{max(e_gue, e_spike):.3e} (random {e_gue:.3e}, spiked {e_spike:.3e}; tol "
            f"{K4_PLAIN_TOL:g}), median {float(e.median()):.3e}; zero matrix diagonal, "
            f"bitwise the plain version's: {zero_ok}; padding exactly 0: {pad_ok}")
        check(max(e_gue, e_spike) < K4_PLAIN_TOL, "K4 disagrees with its plain version")
        check(zero_ok and pad_ok, "K4 zero matrix / padding")

    # 11 ------------------------------------------------------------------
    def learned_path(self):
        """The learned main path: checkpoint -> net-3 on the card -> score."""
        from admmnet_tpu_torch.cli.eval_net import evaluate_e2e
        from admmnet_tpu_torch.core.convert import options_from_jax, params_from_jax
        from admmnet_tpu_torch.models import ADMMNet
        from admmnet_tpu_torch.peaks import match_peaks
        from admmnet_tpu_torch.train.checkpoint import restore_checkpoint

        with np.load(RANDOM_SCENES) as d:
            raw = {k: d[k] for k in d.files}
        with np.load(GOLDEN_NET3) as d:
            gold = {k: d[k] for k in d.files}
        order = np.argsort(-gold["conf"], axis=-1)
        rows = np.arange(len(order))[:, None]
        gst = match_peaks(gold["tau"][rows, order], gold["f"][rows, order], raw["tau"],
                          raw["f"], 0.05, 0.05, pred_valid=gold["conf"][rows, order] > 0.5)
        state, _ = restore_checkpoint(NET3)
        cfg = options_from_jax(json.loads((NET3 / "config.json").read_text())["model"])
        model = ADMMNet(cfg)
        model.load_state_dict(params_from_jax(state["params"]["params"], cfg))
        self.net3 = model.to(self.dev).eval()
        self.net3_cfg = cfg
        y, b, s = to_dev(self.dev, raw["y"], raw["b"], raw["sigma"])
        t0 = time.time()
        st, pred = evaluate_e2e(self.net3, y, b, s, raw["tau"], raw["f"])
        secs = time.time() - t0
        e = np.linalg.norm(pred["phi"] - gold["phi"], axis=-1) / np.linalg.norm(gold["phi"], axis=-1)
        med, mx = float(np.median(e)), float(e.max())
        log(f"[11 learned net-3] {len(raw['y'])} random scenes, one batch, {cfg.num_layers} "
            f"layers, chebyshev GLayer (K4) degree {cfg.cheb_degree}, spectrum head: phi vs "
            f"JAX golden per-scene rel err median {med:.3e} (tol {NET3_PHI_TOL['median']:g}), "
            f"max {mx:.3e} (tol {NET3_PHI_TOL['max']:g}) [{secs:.1f} s]")
        log(f"[11 learned net-3] F1 {st['f1']:.4f} (golden {gst['f1']:.4f}, need >= "
            f"golden - {F1_BAND}; recorded on the TPU kernel {NET3_RECORDED_F1}), "
            f"tau RMSE {st['tau_rmse']:.5f}, f RMSE {st['f_rmse']:.5f}")
        check(all(np.isfinite(pred[k]).all() for k in pred), "net-3: non-finite output")
        check(med < NET3_PHI_TOL["median"] and mx < NET3_PHI_TOL["max"], "net-3 phi vs golden")
        check(st["f1"] >= gst["f1"] - F1_BAND, "net-3 F1 below the golden's")
        self.raw = raw

    def learned_clis(self):
        """eval_net --e2e and main_net on the card, each against its own
        result on the CPU for the same input."""
        from admmnet_tpu_torch.cli import eval_net, main_net

        raw = self.raw
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            split = Path(tmp) / "test"
            split.mkdir()
            arrays = {"y_real": raw["y"].real, "y_imag": raw["y"].imag,
                      "b_real": raw["b"].real, "b_imag": raw["b"].imag, "tau": raw["tau"],
                      "f": raw["f"], "C_real": np.zeros_like(raw["tau"]),
                      "C_imag": np.zeros_like(raw["tau"]),
                      "L_true": np.full(len(raw["tau"]), 3, np.int32),
                      "sigma": raw["sigma"], "ser": np.zeros_like(raw["sigma"])}
            for k, v in arrays.items():
                np.save(split / f"{k}.npy", np.ascontiguousarray(v))
            (Path(tmp) / "dataset_config.json").write_text(json.dumps(
                {"Nb": 10, "Nd": 10, "L_max": 3, "test_samples": len(raw["tau"])}))
            argv = ["--data", tmp, "--ckpt", str(NET3), "--e2e", "--num-layers", "3",
                    "--g-mode", "chebyshev", "--cheb-impl", "pallas", "--head", "spectrum",
                    "--limit", str(B_CLI), "--json", "--device"]
            gpu = run_cli(eval_net.main, argv + ["cuda"])
            cpu = run_cli(eval_net.main, argv + ["cpu"])
        dg, dc = gpu["detection"], cpu["detection"]
        det = max(abs(dg[k] - dc[k]) for k in ("f1", "precision", "recall"))
        rmse = max(abs(dg[k] - dc[k]) for k in ("tau_rmse", "f_rmse"))
        log(f"[11 cli eval_net --e2e] {gpu['samples']} scenes on {gpu['device']}: F1 "
            f"{dg['f1']:.4f}; on cpu: F1 {dc['f1']:.4f}; max |diff| F1/precision/recall "
            f"{det:.2e} (tol {CLI_DET_TOL}), RMSE {rmse:.2e} (tol {CLI_RMSE_TOL:g})")
        check(gpu["device"] == "cuda" and det <= CLI_DET_TOL and rmse <= CLI_RMSE_TOL,
              "eval_net on the card vs the CPU")

        argv = ["--ckpt", str(ROOT / "runs" / "phi10"), "--json", "--device"]
        gpu, cpu = run_cli(main_net.main, argv + ["cuda"]), run_cli(main_net.main, argv + ["cpu"])
        gap = max((abs(a - c) for pg, pc in zip(sorted(gpu["peaks"]), sorted(cpu["peaks"]))
                   for a, c in zip(pg[:2], pc[:2])), default=0.0)
        log(f"[11 cli main_net] phi10 on the anchor, cuda: F1 {gpu['f1']}, peaks "
            f"{[[round(v, 4) for v in r[:2]] for r in gpu['peaks']]}; cpu: F1 {cpu['f1']}; "
            f"max peak position gap {gap:.2e} (tol 1e-3)")
        check(gpu["f1"] == cpu["f1"] and len(gpu["peaks"]) == len(cpu["peaks"]) and gap < 1e-3,
              "main_net on the card vs the CPU")

    # 12 ------------------------------------------------------------------
    def learned_timings(self):
        from admmnet_tpu_torch.kernels.cheb_filter import cheb_filter_matrices_plain

        tag = f"[{self.card}]"
        for B in B_TIME_NET:
            M, c = k4_inputs(B, self.dev)
            calls = k4_call_ms(M, c)
            k4 = float(np.median(calls))
            k4p = cuda_ms(lambda: cheb_filter_matrices_plain(M, c, CHEB_DEGREE), reps=3)
            k4_bound, k4_by, k4_fp32 = cheb_bounds(B, carries=False)
            log(f"[12 time K4] one GLayer call, B={B} m=101 degree {CHEB_DEGREE}: kernel "
                f"{k4:.2f} ms, the median of {CHEB_REPS} calls {min(calls):.2f}-{max(calls):.2f} "
                f"({cheb_flops(B) / k4 / 1e9:.2f} TFLOP/s useful), plain {k4p:.2f} ms; 3xTF32 "
                f"tensor-core bound {k4_bound:.2f} ms ({k4_by}; {k4_bound / k4:.1%} of it), fp32 "
                f"SIMT bound {k4_fp32:.2f} ms ({k4_fp32 / k4:.1%} of it) {tag}")
            del M, c
        self.kernels["K4"].update(ms=k4, plain_ms=k4p, bound_ms=k4_bound, bound_by=k4_by,
                                  library_ms=None, body=CHEB_FWD_BODY, fp32_bound_ms=k4_fp32)

        B = B_TIME_NET[-1]
        reps = -(-B // len(self.raw["y"]))
        y, b, s = to_dev(self.dev, *(np.concatenate([self.raw[k]] * reps)[:B]
                                     for k in ("y", "b", "sigma")))

        def forward():
            with torch.inference_mode():
                return self.net3(y, b, s)[0]

        nms = cuda_ms(forward, reps=3)
        log(f"[12 time net-3] forward + spectrum head, B={B}: {nms:.1f} ms, "
            f"{nms / B:.5f} ms/scene ({B / nms * 1e3:.0f} scenes/s) {tag}")
        self.net_forward = forward

    # 13 ------------------------------------------------------------------
    def profile(self):
        """torch.profiler over one net-3 forward at the timing batch."""
        prof = device_profile(self.net_forward)
        if prof is None:
            log("[13 profile net-3] torch.profiler shows no device time; the CUDA-event "
                "times of phase 12 stand alone")
            return
        busy, window_us, kernels = prof
        top = "; ".join(f"{name[:48]} {t / busy:.1%}" for name, t in kernels[:5])
        log(f"[13 profile net-3] B={B_TIME_NET[-1]}: device busy {busy / 1e3:.1f} ms of a "
            f"{window_us / 1e3:.1f} ms window ({busy / window_us:.1%}); by device time: {top} "
            f"[{self.card}]")

    # 14 ------------------------------------------------------------------
    def k56_vs_plain(self):
        from admmnet_tpu_torch.kernels import cheb_filter as kc

        D, m = CHEB_DEGREE, 101
        M, c, Y = cheb_inputs(np.random.default_rng(4), B_K56, self.dev)
        G4r, G4i = kc.cheb_filter_planes(M, c, D)
        Gr, Gi, carries = kc.cheb_fwd_planes(M, c, D)
        out_p, carries_p = kc.cheb_filter_matrices_plain_with_residuals(M, c, D)
        torch.cuda.synchronize()
        bitwise = torch.equal(Gr, G4r) and torch.equal(Gi, G4i)
        cropped = [x[:, :m, :m] for x in carries]
        e5 = max(float(rel_err(k[:-1], p[:-1]).max()) for k, p in zip(cropped, carries_p))
        pad_ok = all(bool(torch.all(x[:, m:, :] == 0)) and bool(torch.all(x[:, :, m:] == 0))
                     for x in carries)
        out_k = torch.complex(Gr[:, :m, :m], Gi[:, :m, :m])
        self.kernels["K5"] = {"max_abs_err": max(
            float((out_k - out_p).abs().max()),
            *(float((k - p).abs().max()) for k, p in zip(cropped, carries_p)))}
        log(f"[14 K5 vs plain] B={B_K56} m={m} degree {D}, random and spiked: output bitwise "
            f"K4's: {bitwise}; carries vs plain max per-matrix rel err {e5:.3e} (tol "
            f"{K5_PLAIN_TOL:g}); carry padding exactly 0: {pad_ok}")
        check(bitwise, "K5's output differs from K4's")
        check(e5 < K5_PLAIN_TOL and pad_ok, "K5's carries disagree with the plain version")
        # small matrices with a dominant eigenvalue make the carries
        # ill-conditioned (tests/test_torch_cuda.py::test_cheb_fwd_kernel_edges)
        M16, c16, _ = cheb_inputs(np.random.default_rng(7), 8, self.dev, m=16)
        d101 = fp64_distances(kc, M, c, carries)
        d16 = fp64_distances(kc, M16, c16, kc.cheb_fwd_planes(M16, c16, D)[2])
        log(f"[14 K5 vs fp64] carries' max per-matrix distance from the fp64 evaluation, "
            f"kernel / fp32 plain version: m={m} {d101[0]:.3e} / {d101[1]:.3e} "
            f"({d101[0] / d101[1]:.2f}x); m=16 (B=8, half with a dominant eigenvalue) "
            f"{d16[0]:.3e} / {d16[1]:.3e} ({d16[0] / d16[1]:.2f}x)")

        # K6 at the GLayer's side (P = 112: clusters of 7 CTAs, two an SM) and
        # at a lifted side of 120 (P = 128: clusters of 8 CTAs, one an SM)
        M120, c120, Y120 = cheb_inputs(np.random.default_rng(6), B_K6_128, self.dev, m=120)
        cases = [(M, c, Y, carries), (M120, c120, Y120, kc.cheb_fwd_planes(M120, c120, D)[2])]
        errs = []
        for Mk, ck, Yk, ck_carries in cases:
            mk, P = Mk.shape[-1], ck_carries[0].shape[-1]
            ABr, ABi, cbar = kc.cheb_bwd_planes(Mk, ck, ck_carries, Yk, D)
            Abar = torch.complex(ABr[:, :mk, :mk], ABi[:, :mk, :mk])
            Ap, cp = kc.cheb_bwd_plain(Mk, ck, [x[:, :mk, :mk] for x in ck_carries], Yk, D)
            Mb, Mbp = kc.normalization_backward(Mk, Abar), kc.normalization_backward(Mk, Ap)
            torch.cuda.synchronize()
            eM = float(rel_err(Mb[:-1], Mbp[:-1]).max())
            ec = float(rel_err(cbar, cp).max())
            finite = bool(torch.all(torch.isfinite(torch.view_as_real(Mb)))) and bool(
                torch.all(torch.isfinite(cbar)))
            pad_ok = all(bool(torch.all(x[:, mk:, :] == 0)) and bool(torch.all(x[:, :, mk:] == 0))
                         for x in (ABr, ABi))
            errs += [float((Abar - Ap).abs().max()), float((cbar - cp).abs().max())]
            log(f"[14 K6 vs plain] B={Mk.shape[0]} m={mk} (P={P}), 3xTF32 tensor-core products: "
                f"Mbar max per-matrix rel err {eM:.3e} (tol {K6_PLAIN_TOL['Mbar']:g}), cbar "
                f"{ec:.3e} (tol {K6_PLAIN_TOL['cbar']:g}); finite: {finite}; Abar padding "
                f"exactly 0: {pad_ok}")
            check(finite and pad_ok and eM < K6_PLAIN_TOL["Mbar"] and ec < K6_PLAIN_TOL["cbar"],
                  f"K6 at P={P} disagrees with its plain version")
        self.kernels["K6"] = {"max_abs_err": max(errs)}
        del cases, M120, c120, Y120

        # through autograd: cheb_filter_matrices (K5 + K6) vs the plain forward
        grads = []
        W = Y[:-1]
        for fn in (kc.cheb_filter_matrices, kc.cheb_filter_matrices_plain):
            Mg, cg = M[:-1].clone().requires_grad_(True), c[:-1].clone().requires_grad_(True)
            (fn(Mg, cg, D) * W.conj()).real.sum().backward()
            grads.append((herm(Mg.grad), cg.grad))
        eM = float(rel_err(grads[0][0], grads[1][0]).max())
        ec = float(rel_err(grads[0][1], grads[1][1]).max())
        log(f"[14 K6 vs autograd] Hermitian part of Mbar vs torch autograd through the plain "
            f"forward: max per-matrix rel err {eM:.3e}, cbar {ec:.3e} (tol {K6_AUTOGRAD_TOL:g})")
        check(eM < K6_AUTOGRAD_TOL and ec < K6_AUTOGRAD_TOL, "K6 disagrees with plain autograd")

    # 15 ------------------------------------------------------------------
    def golden_train_steps(self):
        t0 = time.time()
        losses, gold, err = golden_steps(self.dev)
        e_loss = float(np.max(np.abs(losses - gold) / np.abs(gold)))
        log(f"[15 golden steps] net-3, {GOLDEN_STEPS} recipe steps of {GOLDEN_BATCH} scenes "
            f"from the JAX seed-0 init: losses {np.round(losses, 7).tolist()} vs JAX "
            f"{np.round(gold, 7).tolist()}, max rel err {e_loss:.3e} (tol {GOLDEN_LOSS_TOL:g}); "
            f"parameter change error {err:.3e} (tol {GOLDEN_PARAM_TOL:g}) [{time.time() - t0:.1f} s]")
        check(np.all(np.isfinite(losses)), "golden steps: non-finite loss")
        check(e_loss < GOLDEN_LOSS_TOL and err < GOLDEN_PARAM_TOL, "golden steps vs JAX")

    # 16 ------------------------------------------------------------------
    def training_run(self):
        """generate_dataset + train_cli with the net-3 recipe on the card."""
        from admmnet_tpu_torch.cli import generate_dataset, train_cli
        from admmnet_tpu_torch.core.convert import options_from_jax, params_from_jax
        from admmnet_tpu_torch.data.generator import DatasetGenerator
        from admmnet_tpu_torch.models import ADMMNet
        from admmnet_tpu_torch.train.checkpoint import restore_checkpoint
        from admmnet_tpu_torch.train.schedules import sgdr_schedule
        from admmnet_tpu_torch.train.trainer import (
            build_steps,
            evaluate_split,
            init_model,
            make_optimizer,
        )

        (ROOT / "build").mkdir(exist_ok=True)
        self.tmp = tempfile.TemporaryDirectory(dir=ROOT / "build")
        data, work = Path(self.tmp.name) / "fix20_10k", Path(self.tmp.name) / "net3"
        t0 = time.time()
        with contextlib.redirect_stdout(io.StringIO()):
            generate_dataset.main(["--out", str(data), "--fixed-snr", "20", "--total", "10000",
                                   "--seed", "13", "--device", "cuda"])
        t_gen = time.time() - t0
        # count the batches the native loader hands the trainer
        from admmnet_tpu_torch.data import loader

        drawn = []
        native_iter = loader.PrefetchLoader.__iter__

        def counting_iter(self):
            for batch in native_iter(self):
                drawn.append(len(batch["y"]))
                yield batch

        t0 = time.time()
        buf = io.StringIO()
        loader.PrefetchLoader.__iter__ = counting_iter
        try:
            with contextlib.redirect_stdout(buf):
                train_cli.main(["--data", str(data), "--workdir", str(work), *TRAIN_ARGS,
                                "--device", "cuda"])
        finally:
            loader.PrefetchLoader.__iter__ = native_iter
        t_train = time.time() - t0
        from admmnet_tpu_torch.kernels import cheb_filter as kc

        self.train_launches = {"K4": kc.launches.count, "K5": kc.fwd_launches.count,
                               "K6": kc.bwd_launches.count}
        for ln in buf.getvalue().splitlines():
            if ln.startswith("epoch"):
                log(f"[16 train_cli]   {ln}")
        hist = json.loads((work / "training_history.json").read_text())
        res = json.loads((work / "test_result.json").read_text())
        gen = DatasetGenerator(data_dir=data)
        self.train_split = gen.load_split("train")
        self.val_split = gen.load_split("val")
        test = gen.load_split("test")
        n_steps = len(hist["train_loss"]) * -(-len(self.train_split["y"]) // 256)
        self.train_steps = n_steps

        # the checkpoint restores with the port's reader
        state, meta = restore_checkpoint(work)
        cfg = options_from_jax(json.loads((work / "config.json").read_text())["model"])
        restored = ADMMNet(cfg)
        restored.load_state_dict(params_from_jax(state["params"]["params"], cfg))
        # the committed net-3 checkpoint and the recipe's seed-0 init (what
        # train_cli starts from) on the same test split, same protocol
        run = json.loads((NET3 / "config.json").read_text())
        tcfg = options_from_jax(run["train"])

        def score(model):
            _, eval_step = build_steps(model, make_optimizer(model, tcfg), "e2e",
                                       sgdr_schedule(1e-3, 1, 1), assignment="perm",
                                       spectral_weight=0.5)
            return evaluate_split(eval_step, test, 256, self.dev, "e2e")

        ref = ADMMNet(options_from_jax(run["model"]))
        ref.load_state_dict(params_from_jax(restore_checkpoint(NET3)[0]["params"]["params"],
                                            ref.cfg))
        ref_res = score(ref.to(self.dev))
        init_res = score(init_model(ADMMNet, cfg, 0, self.dev))
        gap = init_res["test_loss"] - ref_res["test_loss"]
        closed = (init_res["test_loss"] - res["test_loss"]) / gap if gap > 0 else float("nan")
        fell = hist["val_loss"][-1] < hist["val_loss"][0]
        log(f"[16 generate_dataset] 10000 fixed-SNR-20 scenes, seed 13, on the card: "
            f"{t_gen:.1f} s")
        log(f"[16 train_cli] net-3 recipe, {len(hist['train_loss'])} epochs, {n_steps} steps "
            f"of 256 on the card: {t_train:.1f} s; val loss {hist['val_loss'][0]:.6f} -> "
            f"{hist['val_loss'][-1]:.6f} (must fall: {fell}); best epoch {meta['epoch'] + 1}, "
            f"checkpoint restored with the port's reader")
        log(f"[16 train_cli] test ({len(test['y'])} scenes): matched F1 "
            f"{res['matched_f1']:.4f}, matched tau/f RMSE {res['matched_tau_rmse']:.5f} / "
            f"{res['matched_f_rmse']:.5f}; committed runs/train_net3_r05 on the same split: "
            f"matched F1 {ref_res['matched_f1']:.4f} (need >= it - {TRAIN_F1_BAND}); the JAX "
            f"run recorded {NET3_RECORDED_TEST_F1} on its own split")
        log(f"[16 train_cli] test loss: trained {res['test_loss']:.6f}, seed-0 init "
            f"{init_res['test_loss']:.6f} (matched F1 {init_res['matched_f1']:.4f}), committed "
            f"{ref_res['test_loss']:.6f}; share of the init-to-committed gap closed {closed:.4f} "
            f"(need >= {TRAIN_LOSS_GAP_CLOSED})")
        epochs = len(hist["train_loss"])
        log(f"[16 loader] train_cli drew {len(drawn)} batches ({sum(drawn)} rows) from the "
            f"port's native minibatch loader ({loader.library_path().name}); the {n_steps} "
            f"training steps need {n_steps} batches ({epochs} x {len(self.train_split['y'])} "
            f"rows)")
        check(len(drawn) >= n_steps and sum(drawn) >= epochs * len(self.train_split["y"]),
              "training: the epochs were not drawn from the native loader")
        check(all(np.isfinite(hist["train_loss"])) and fell, "training: val loss did not fall")
        check(res["matched_f1"] >= ref_res["matched_f1"] - TRAIN_F1_BAND,
              "training: matched test F1 below the committed checkpoint's")
        check(closed >= TRAIN_LOSS_GAP_CLOSED,
              "training: test loss closed too little of the gap from init to the committed net")

    # 17 ------------------------------------------------------------------
    def training_timings(self):
        from admmnet_tpu_torch.core.convert import options_from_jax
        from admmnet_tpu_torch.kernels import cheb_filter as kc
        from admmnet_tpu_torch.models import ADMMNet
        from admmnet_tpu_torch.train.schedules import sgdr_schedule
        from admmnet_tpu_torch.train.trainer import (
            batch_to_device,
            build_steps,
            init_model,
            make_optimizer,
        )

        tag = f"[{self.card}]"
        D = CHEB_DEGREE
        for B in B_TIME_TRAIN:
            M, c, Y, carries = k6_inputs(kc, B, self.dev)
            cropped = [x[:, :101, :101].contiguous() for x in carries]
            calls5 = k5_call_ms(kc, M, c)
            k5 = float(np.median(calls5))
            k5p = cuda_ms(lambda: kc.cheb_filter_matrices_plain_with_residuals(M, c, D), reps=3)
            calls = k6_call_ms(kc, M, c, Y, carries)
            k6 = float(np.median(calls))
            k6p = cuda_ms(lambda: kc.cheb_bwd_plain(M, c, cropped, Y, D), reps=3)
            b5, by5, b5s = cheb_bounds(B, carries=True)
            # K6's products run on the tensor cores in 3xTF32: three TF32
            # products per useful one; the fp32 SIMT bound is kept beside it
            b6, by6 = bound(0.0, cheb_bwd_bytes(B))
            b6 = max(b6, 3 * cheb_bwd_flops(B) / PEAK_TF32 * 1e3)
            by6 = "operations" if b6 > cheb_bwd_bytes(B) / PEAK_BYTES * 1e3 else "bytes"
            b6s, _ = bound(cheb_bwd_flops(B), cheb_bwd_bytes(B))
            log(f"[17 time K5] B={B} m=101 degree {D}: kernel {k5:.3f} ms, the median of "
                f"{CHEB_REPS} calls {min(calls5):.3f}-{max(calls5):.3f}, plain {k5p:.2f} ms; "
                f"3xTF32 tensor-core bound {b5:.3f} ms ({by5}; {b5 / k5:.1%} of it), fp32 SIMT "
                f"bound {b5s:.2f} ms ({b5s / k5:.1%} of it) {tag}")
            log(f"[17 time K6] B={B}: kernel {k6:.3f} ms, the median of {CHEB_REPS} calls "
                f"{min(calls):.3f}-{max(calls):.3f} ({cheb_bwd_flops(B) / k6 / 1e9:.2f} "
                f"TFLOP/s useful), plain {k6p:.2f} ms; 3xTF32 tensor-core bound {b6:.3f} ms "
                f"({by6}; {b6 / k6:.1%} of it), fp32 SIMT bound {b6s:.2f} ms ({b6s / k6:.1%} "
                f"of it) {tag}")
            if B == 256:
                self.kernels["K5"].update(ms=k5, plain_ms=k5p, bound_ms=b5, bound_by=by5,
                                          library_ms=None, body=CHEB_FWD_BODY,
                                          fp32_bound_ms=b5s)
                self.kernels["K6"].update(ms=k6, plain_ms=k6p, bound_ms=b6, bound_by=by6,
                                          library_ms=None)
            del M, c, Y, carries, cropped

        run = json.loads((NET3 / "config.json").read_text())
        tcfg = options_from_jax(run["train"])
        model = init_model(ADMMNet, options_from_jax(run["model"]), 1, self.dev)
        opt = make_optimizer(model, tcfg)
        step, _ = build_steps(model, opt, "e2e", sgdr_schedule(1e-3, 27, 15),
                              tcfg.grad_clip, tcfg.assignment, tcfg.spectral_weight)
        batch = batch_to_device({k: v[:256] for k, v in self.train_split.items()}, self.dev)
        sms = cuda_ms(lambda: step(batch, 0), reps=5)
        log(f"[17 time train step] net-3 recipe, B=256: {sms:.1f} ms per step "
            f"({256 / sms * 1e3:.0f} scenes/s) {tag}")

        prof = device_profile(lambda: step(batch, 0))
        if prof is None:
            log("[17 profile train step] torch.profiler shows no device time")
            return
        busy, window_us, kernels = prof
        top = "; ".join(f"{name[:40]} {t / busy:.1%}" for name, t in kernels[:6])
        log(f"[17 profile train step] B=256: device busy {busy / 1e3:.1f} ms of a "
            f"{window_us / 1e3:.1f} ms window ({busy / window_us:.1%}), {len(kernels)} kernel "
            f"names; by device time: {top} {tag}")

    # 18 ------------------------------------------------------------------
    def unfolded_vs_plain(self):
        """K3 (lists) and K2's unfolded carry vs their plain versions."""
        from admmnet_tpu_torch.core.config import ADMMOptions
        from admmnet_tpu_torch.kernels.fused_admm_fast import (
            admm_solve_fused_fast,
            admm_solve_fused_fast_plain,
        )
        from admmnet_tpu_torch.solver.admm import fused_kernel_options

        self.kernels["K3"] = {"max_abs_err": 0.0}
        for rows in ((x[:B_SOLVE] for x in self.anchor), self.anchor128):
            y, b, s = rows
            B, n = y.shape
            for key, layout in (("K3", "lists"), ("K2", "lean")):
                kw = fused_kernel_options(ADMMOptions(fused_layout=layout, **HATCH))
                pk = admm_solve_fused_fast(y, b, s, ITERS, 1.0, 1.0, **kw)
                pp = admm_solve_fused_fast_plain(y, b, s, ITERS, 1.0, 1.0, **kw)
                torch.cuda.synchronize()
                check(bool(torch.all(torch.isfinite(torch.view_as_real(pk)))),
                      f"{key} {layout} n={n}: non-finite phi")
                e = rel_err(pk, pp)
                med, mx = float(e.median()), float(e.max())
                worst = float((pk - pp).abs().max())
                self.kernels[key]["max_abs_err"] = max(self.kernels[key]["max_abs_err"], worst)
                log(f"[18 {key} {layout}, unfolded] B={B} n={n} x {ITERS} iters, sched2, 4/3 "
                    f"cold root, final_hi off: kernel vs plain per-instance rel err median "
                    f"{med:.3e} (tol {HATCH_PLAIN_TOL['median']:g}), max {mx:.3e} (tol "
                    f"{HATCH_PLAIN_TOL['max']:g})")
                check(med < HATCH_PLAIN_TOL["median"] and mx < HATCH_PLAIN_TOL["max"],
                      f"{key} ({layout}, unfolded) n={n} disagrees with its plain version")

    # 19 ------------------------------------------------------------------
    def escape_hatch(self):
        """The escape hatch end to end through admm_solve_fixed: lists (K3)
        and the same knobs on the lean layout (K2 unfolded)."""
        from admmnet_tpu_torch.core.config import (
            DETECTION_BUDGET_ITERS,
            PRODUCTION_PEAKS,
            ADMMOptions,
            PeakSearchConfig,
        )
        from admmnet_tpu_torch.kernels import fused_admm_fast
        from admmnet_tpu_torch.peaks import scale_invariant_nmse
        from admmnet_tpu_torch.solver import admm_solve_fixed

        with np.load(GOLDEN_EIGH) as d:
            golden = d["phi"]
        raw, (yr, br, sr) = self.random
        y, b, s = self.anchor
        fused_admm_fast.launches.reset()
        fused_admm_fast.lists_launches.reset()
        for layout in ("lists", "lean"):
            opts = ADMMOptions(fused_layout=layout, **HATCH)
            tag = f"[19 hatch {layout}]"
            for iters, pcfg in ((DETECTION_BUDGET_ITERS, PRODUCTION_PEAKS),
                                (ITERS, PeakSearchConfig(max_peaks=8))):
                st = anchor_scores(admm_solve_fixed(y[:512], b[:512], s[:512], iters, 1.0, opts),
                                   pcfg)
                log(f"{tag} anchor 512 scenes x {iters} iters: F1 {st['f1']:.4f} (need 1.0), "
                    f"tau RMSE {st['tau_rmse']:.5f}")
                check(st["f1"] == 1.0, f"escape hatch ({layout}): anchor F1 at {iters} iterations")
            st = random_scores(admm_solve_fixed(yr, br, sr, ITERS, 1.0, opts), raw,
                               PeakSearchConfig(max_peaks=8))
            ok = st["f1"] >= self.f1_eigh - F1_BAND
            log(f"{tag} random {len(raw['y'])} scenes x {ITERS} iters: F1 {st['f1']:.4f} >= "
                f"eigh control {self.f1_eigh:.4f} - {F1_BAND}: {ok}")
            check(ok, f"escape hatch ({layout}): random-scene gate")
            phi = admm_solve_fixed(y, b, s, ITERS, 1.0, opts).cpu().numpy()
            nmse = scale_invariant_nmse(phi, golden[:len(phi)])
            log(f"{tag} B={len(phi)} x {ITERS}: phi NMSE vs phi_eigh_2048 {nmse:.3e} "
                f"(reported; the gates of this route are the detection gates above)")
            check(bool(np.isfinite(nmse)), f"escape hatch ({layout}): non-finite phi")
        self.hatch_launches = {"K3": fused_admm_fast.lists_launches.count,
                               "K2 unfolded": fused_admm_fast.launches.count}

        # the layouts against each other, JAX's bands
        it = HATCH_DIFF_ITERS
        phis = {name: admm_solve_fixed(y, b, s, it, 1.0, ADMMOptions(**kw))
                for name, kw in (("lists", dict(HATCH, fused_layout="lists")),
                                 ("lean", HATCH),
                                 ("folded", dict(HATCH, fused_fold_diag=True)))}
        e_ll = float(rel_err(phis["lists"], phis["lean"]).max())
        e_fold = float(rel_err(phis["folded"], phis["lean"]).max())
        e_lf = float(rel_err(phis["lists"], phis["folded"]).max())
        log(f"[19 hatch layouts] B={B_SOLVE} x {it} iters, max per-instance rel err: K3 vs "
            f"unfolded K2 {e_ll:.3e} (tol {LISTS_VS_LEAN_TOL:g}); folded vs unfolded K2 "
            f"{e_fold:.3e}, K3 vs folded K2 {e_lf:.3e} (tol {FOLD_VS_UNFOLDED_TOL:g})")
        check(e_ll < LISTS_VS_LEAN_TOL, "K3 vs the unfolded K2")
        check(e_fold < FOLD_VS_UNFOLDED_TOL and e_lf < FOLD_VS_UNFOLDED_TOL,
              "the folded K2 vs the unfolded layouts")

    # 20 ------------------------------------------------------------------
    def k7_path(self):
        """K7 on the anchor: the solve scored against the eigh golden, then
        held against its plain version and the per-step polar solve."""
        from admmnet_tpu_torch.core.config import ADMMOptions
        from admmnet_tpu_torch.kernels import fused_admm as k7
        from admmnet_tpu_torch.peaks import scale_invariant_nmse
        from admmnet_tpu_torch.solver import admm_solve_fixed

        with np.load(GOLDEN_EIGH) as d:
            golden = d["phi"]
        y, b, s = (x[:B_EXACT] for x in self.anchor)
        k7.launches.reset()
        t0 = time.time()
        pk = k7.admm_solve_fused(y, b, s, ITERS)
        p15 = k7.admm_solve_fused(y, b, s, HATCH_DIFF_ITERS)
        phi = pk.cpu().numpy()
        secs = time.time() - t0
        self.k7_launches = k7.launches.count
        check(bool(np.all(np.isfinite(phi.view(np.float32)))), "K7: non-finite phi")
        nmse = scale_invariant_nmse(phi, golden[:B_EXACT])
        log(f"[20 K7] B={B_EXACT} x {ITERS}: phi NMSE vs phi_eigh_2048 {nmse:.3e} "
            f"(tol {K7_NMSE_TOL:g}) [{secs:.1f} s]")
        check(nmse <= K7_NMSE_TOL, f"K7: phi NMSE {nmse:.3e} > {K7_NMSE_TOL:g}")
        x15 = admm_solve_fixed(y, b, s, HATCH_DIFF_ITERS, 1.0, ADMMOptions(g_update="polar"))
        e_pol = float(rel_err(p15, x15).max())
        log(f"[20 K7 vs polar] B={B_EXACT} x {HATCH_DIFF_ITERS} iters: max per-instance rel "
            f"err vs admm_solve_fixed(g_update='polar') {e_pol:.3e} (tol {K7_POLAR_TOL:g})")
        check(e_pol < K7_POLAR_TOL, "K7 vs the per-step polar solve")
        # the plain version: ~1e5 small launches, so run once and time that run
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        pp = k7.admm_solve_fused_plain(y, b, s, ITERS)
        end.record()
        end.synchronize()
        self.k7_plain_ms = start.elapsed_time(end)
        e = rel_err(pk, pp)
        med, mx = float(e.median()), float(e.max())
        self.kernels["K7"] = {"max_abs_err": float((pk - pp).abs().max())}
        log(f"[20 K7 vs plain] B={B_EXACT} x {ITERS} iters: per-instance rel err median "
            f"{med:.3e} (tol {K7_PLAIN_TOL['median']:g}), max {mx:.3e} (tol "
            f"{K7_PLAIN_TOL['max']:g})")
        check(med < K7_PLAIN_TOL["median"] and mx < K7_PLAIN_TOL["max"],
              "K7 disagrees with its plain version")

    # 21 ------------------------------------------------------------------
    def k1_bf16(self):
        """K1's bf16 iterate storage: vs eigh and its plain version, and one
        polar_fast solve of the anchor with polar_bf16_store."""
        from admmnet_tpu_torch.core.config import ADMMOptions, PeakSearchConfig
        from admmnet_tpu_torch.kernels import polar
        from admmnet_tpu_torch.kernels.polar import (
            psd_project_polar_kernel,
            psd_project_polar_plain,
        )
        from admmnet_tpu_torch.ops.projections import psd_project_eigh
        from admmnet_tpu_torch.solver import admm_solve_fixed

        M = random_hermitian(np.random.default_rng(6), B_K1, 101, self.dev)
        Pe = psd_project_eigh(M)
        for hs in (0, 1):
            Pk = psd_project_polar_kernel(M, mode="fast", hi_steps=hs, bf16_store=True)
            Pp = psd_project_polar_plain(M, "fast", hs, bf16_store=True)
            P32 = psd_project_polar_kernel(M, mode="fast", hi_steps=hs)
            torch.cuda.synchronize()
            e_plain = rel_err(Pk, Pp)
            med, mx = float(e_plain.median()), float(e_plain.max())
            e_eigh = float(rel_err(Pk, Pe).max())
            d32 = float(rel_err(Pk, P32).median())
            log(f"[21 K1 bf16_store hi_steps={hs}] B={B_K1} m=101: kernel vs eigh {e_eigh:.3e} "
                f"(tol {K1_BF16_EIGH_TOL:g}); vs plain per-matrix rel err median {med:.3e} "
                f"(tol {K1_BF16_PLAIN_TOL['median']:g}), max {mx:.3e} (tol "
                f"{K1_BF16_PLAIN_TOL['max']:g}), bitwise equal {int((e_plain == 0).sum())}/"
                f"{B_K1}; vs the fp32 store median {d32:.3e} (must be > "
                f"{K1_BF16_VS_FP32_MIN:g})")
            check(e_eigh < K1_BF16_EIGH_TOL, "K1 bf16_store too far from eigh")
            check(med < K1_BF16_PLAIN_TOL["median"] and mx < K1_BF16_PLAIN_TOL["max"],
                  "K1 bf16_store disagrees with its plain version")
            check(d32 > K1_BF16_VS_FP32_MIN, "K1 bf16_store: no bf16 rounding shows")
        y, b, s = (x[:512] for x in self.anchor)
        opts = ADMMOptions(g_update="polar_fast", polar_bf16_store=True)
        polar.launches.reset()
        phi = admm_solve_fixed(y, b, s, ITERS, 1.0, opts)
        self.k1_bf16_launches = polar.launches.count
        st = anchor_scores(phi, PeakSearchConfig(max_peaks=8))
        log(f"[21 polar_fast + polar_bf16_store] anchor 512 scenes x {ITERS} iters through "
            f"admm_solve_fixed: F1 {st['f1']:.4f}, tau RMSE {st['tau_rmse']:.5f}")

    # 22 ------------------------------------------------------------------
    def bench_time_cli(self):
        from admmnet_tpu_torch.cli import bench_time

        for argv in (["--what", "admm", "--g-update", "fused_fast", "--runs", "1000"],
                     ["--what", "admm", "--g-update", "fused_fast", "--sequential",
                      "--runs", "20"],
                     ["--what", "e2e", "--ckpt", str(NET3), "--layers", "3", "--g-mode",
                      "chebyshev", "--cheb-impl", "pallas"]):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                bench_time.main(argv + ["--device", "cuda"])
            lines = buf.getvalue().splitlines()
            check(any("per solve" in ln for ln in lines), f"bench_time {argv}: no timing line")
            log(f"[22 bench_time] {' '.join(argv)} [{self.card}]:")
            for ln in lines:
                log(f"[22 bench_time]   {ln}")

    # 23 ------------------------------------------------------------------
    def variant_timings(self):
        from admmnet_tpu_torch.core.config import ADMMOptions
        from admmnet_tpu_torch.data.anchor import make_anchor_batch
        from admmnet_tpu_torch.kernels import fused_admm as k7
        from admmnet_tpu_torch.kernels.fused_admm_fast import (
            admm_solve_fused_fast,
            admm_solve_fused_fast_plain,
        )
        from admmnet_tpu_torch.kernels.polar import (
            psd_project_polar_kernel,
            psd_project_polar_plain,
        )
        from admmnet_tpu_torch.solver.admm import fused_kernel_options

        tag = f"[{self.card}]"
        y, b, s = to_dev(self.dev, *make_anchor_batch(B_TIME_K2, "redemod", seed=0))
        n_ii = B_TIME_K2 * ITERS
        for key, layout in (("K3", "lists"), ("K2", "lean")):
            kw = fused_kernel_options(ADMMOptions(fused_layout=layout, **HATCH))
            ms = cuda_ms(lambda: admm_solve_fused_fast(y, b, s, ITERS, 1.0, 1.0, **kw))
            pms = cuda_ms(lambda: admm_solve_fused_fast_plain(y, b, s, ITERS, 1.0, 1.0, **kw))
            flops = solve_flops(n_ii, len(kw["schedule"]))
            bms, by = tf32x3_bound(flops, solve_bytes(B_TIME_K2))
            fp32_ms, _ = bound(flops, solve_bytes(B_TIME_K2))
            log(f"[23 time {key} {layout}, unfolded] B={B_TIME_K2} x {ITERS}, sched2, 4/3 cold: "
                f"kernel {ms:.1f} ms ({n_ii / ms * 1e3:.0f} inst-iter/s), plain {pms:.1f} ms; "
                f"3xTF32 bound {bms:.1f} ms ({by}), fp32 SIMT bound {fp32_ms:.1f} ms {tag}")
            if key == "K3":
                self.kernels["K3"].update(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                                          library_ms=None)
        del y, b, s

        y, b, s = (x[:B_EXACT] for x in self.anchor)
        ms = cuda_ms(lambda: k7.admm_solve_fused(y, b, s, ITERS))
        flops = solve_flops(B_EXACT * ITERS, 7)
        bms, by = tf32x3_bound(flops, solve_bytes(B_EXACT))
        fp32_ms, _ = bound(flops, solve_bytes(B_EXACT))
        log(f"[23 time K7] B={B_EXACT} x {ITERS}: kernel {ms:.1f} ms "
            f"({B_EXACT * ITERS / ms * 1e3:.0f} inst-iter/s), plain {self.k7_plain_ms:.1f} ms "
            f"(one run, phase 20); 3xTF32 tensor-core bound {bms:.1f} ms ({by}; "
            f"{bms / ms:.1%} of it), fp32 SIMT bound {fp32_ms:.1f} ms ({fp32_ms / ms:.1%} of "
            f"it) {tag}")
        self.kernels["K7"].update(ms=ms, plain_ms=self.k7_plain_ms, bound_ms=bms, bound_by=by,
                                  library_ms=None, body=POLAR_BODY, fp32_bound_ms=fp32_ms)

        M = random_hermitian(np.random.default_rng(1), B_TIME_K1, 101, self.dev)
        ms = cuda_ms(lambda: psd_project_polar_kernel(M, mode="fast", bf16_store=True), reps=3)
        pms = cuda_ms(lambda: psd_project_polar_plain(M, "fast", bf16_store=True), reps=3)
        # the 6 low steps' 9 products each take bf16-valued operands; the 3
        # closing products read the fp32 M: in 3xTF32 on the tensor cores, or
        # as fp32 SIMT FMAs beside it
        closing, nbytes = B_TIME_K1 * 3 * 2.0 * 101**3, B_TIME_K1 * 2 * 101 * 101 * 8
        low = B_TIME_K1 * 9 * 6 * 2.0 * 101**3
        t_ops, t_bytes = low / PEAK_BF16 + 3 * closing / PEAK_TF32, nbytes / PEAK_BYTES
        bms, by = max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"
        fp32_ms, _ = bound(closing, nbytes, bf16_flops=low)
        log(f"[23 time K1 fast bf16_store] B={B_TIME_K1} m=101: kernel {ms:.2f} ms, plain "
            f"{pms:.2f} ms per call; bound (bf16 low steps, 3xTF32 closing) {bms:.3f} ms "
            f"({by}; {bms / ms:.1%} of it), with fp32 SIMT closing {fp32_ms:.3f} ms {tag}")


    # 26 ------------------------------------------------------------------
    def parallel(self) -> dict:
        """Data parallelism on the card: (a) the deploy solve sharded over a
        world-2 gloo fleet (both ranks on this card: NCCL refuses two ranks
        on one device) against the same solve in this process; (b) on the
        same fleet, net-10 trained with DistributedDataParallel (global
        batch 256, 128 a rank, the ZLayer's mean over the global batch)
        against the run in this process; (c) the same run on a world-1
        NCCL fleet, bit for bit the run without a mesh; (d) the scaling CLI
        on this card; (e) the multi-rank dry run on this card.  Returns the
        phase's kernel launches, over this process and every rank."""
        from admmnet_tpu_torch.cli import bench_scaling
        from admmnet_tpu_torch.graft_entry import dryrun_multichip
        from admmnet_tpu_torch.kernels import polar
        from admmnet_tpu_torch.parallel import spawn_ranks

        tag = f"[{self.card}]"
        t_phase = time.time()
        start = cheb_counts()
        log("[26 parallel] world-2 fleets below are two gloo ranks time-sharing this one card: "
            "their times are not scaling numbers")
        n = PAR_BATCH
        train = {k: v[:n] for k, v in self.train_split.items()}
        val = {k: v[:n] for k, v in self.val_split.items()}

        # (a) the sharded deploy solve
        phi1, peaks1, k2_single = deploy_solve(dev=self.dev)
        case = zlayer_case()
        work = tempfile.TemporaryDirectory(dir=ROOT / "build")
        t0 = time.time()
        ranks = spawn_ranks(parallel_rank, 2, backend="gloo", device="cuda:0",
                            args=(train, val, str(Path(work.name) / "ddp"), case),
                            timeout=PAR_TIMEOUT)
        t_fleet = time.time() - t0
        r0 = ranks[0]
        same, rel = bitwise_or_rel(r0["phi"], phi1)
        log(f"[26a sharded deploy] B={B_PAR_SOLVE} fused_fast x 10 + PRODUCTION_PEAKS on 2 gloo "
            f"ranks (cuda:0): K2 launches per rank {[r['K2'] for r in ranks]} (each must be "
            f"> 0); gathered phi " + ("bitwise equal to the single-process solve" if same else
                                      f"differs: max |diff| / max |phi| = {rel:.3e}"))
        check(all(r["K2"] > 0 for r in ranks), "a rank of the sharded solve never launched K2")
        worst = rel
        for k, v in peaks1.items():
            same_k, rel_k = bitwise_or_rel(r0["peaks"][k].astype(np.float64), v.astype(np.float64))
            log(f"[26a sharded deploy] peaks.{k}: "
                + ("bitwise equal" if same_k else f"max rel diff {rel_k:.3e}"))
            check(same_k or k != "valid", "the sharded peak lists' valid flags differ")
            worst = max(worst, rel_k)
        if worst:
            log(f"[26a sharded deploy] not bitwise: the kernel is per instance, so a difference "
                f"comes from the batch size the peak search's batched products see (4096 vs "
                f"8192 rows); gate max rel {worst:.3e} <= {PAR_SOLVE_RTOL}")
        check(worst <= PAR_SOLVE_RTOL, "the sharded deploy solve differs from one process's")

        # (b) the ZLayer's global mean and DDP's first step, each rank against
        # one process from the same state, then 20 steps of the trainer
        zref = zlayer_halves(None, case, self.dev)
        half = len(case["G"]) // 2
        zerr = 0.0
        for i, r in enumerate(ranks):
            sl = slice(i * half, (i + 1) * half)
            for got, want in [(r["zlayer"]["out"], zref["out"][sl])] + [
                    (g, w[sl]) for g, w in zip(r["zlayer"]["inputs"], zref["inputs"])]:
                zerr = max(zerr, float(np.max(np.abs(got - want) / (1.0 + np.abs(want)))))
        zsum = ranks[0]["zlayer"]["params"] + ranks[1]["zlayer"]["params"]
        zerr = max(zerr, float(np.max(np.abs(zsum - zref["params"])
                                      / (1.0 + np.abs(zref["params"])))))
        log(f"[26b ZLayer] net-10's z_0 on 2 gloo ranks, each on half of {len(case['G'])} "
            f"scenes of 10x different scales: outputs and input gradients per half, parameter "
            f"gradients summed over the ranks, vs the whole batch in one process: max "
            f"|diff| / (1 + |ref|) {zerr:.3e} (<= {PAR_ZLAYER_TOL})")
        check(zerr <= PAR_ZLAYER_TOL, "the ZLayer's mean is not the global batch's under 2 ranks")
        perm = np.random.default_rng(1).permutation(n)
        reordered = {k: v[perm] for k, v in train.items()}
        gref = first_gradient(None, train, self.dev)
        gerr = [float(np.linalg.norm(r["grad"] - gref) / np.linalg.norm(gref)) for r in ranks]
        gctl = float(np.linalg.norm(first_gradient(None, reordered, self.dev) - gref)
                     / np.linalg.norm(gref))
        log(f"[26b DDP first step] net-10 from its seed-0 init, global batch {n}: each rank's "
            f"clipped gradient (averaged by DDP) vs one process's, ||diff|| / ||g|| "
            f"{' '.join(f'{e:.3e}' for e in gerr)} (<= {PAR_GRAD_RTOL}); one process on the "
            f"batch reordered {gctl:.3e}")
        check(max(gerr) <= PAR_GRAD_RTOL, "DDP's first step is not the single-process step")

        single = net10_run(None, train, val, str(Path(work.name) / "single"), self.dev)
        control = net10_run(None, reordered, {k: v[perm] for k, v in val.items()},
                            str(Path(work.name) / "control"), self.dev)

        def dev_from_single(run, key):
            return np.abs(np.array(run[key]) / np.array(single[key]) - 1)

        for key in ("train_loss", "val_loss"):
            d, c = dev_from_single(r0, key), dev_from_single(control, key)
            log(f"[26b DDP net-10] {key} rel diff from one process, per step: DDP "
                f"{' '.join(f'{x:.1e}' for x in d)}; one process on the batch reordered "
                f"{' '.join(f'{x:.1e}' for x in c)} (max {d.max():.3e} vs {c.max():.3e})")
        dl0 = float(dev_from_single(r0, "train_loss")[0])
        dv0 = float(dev_from_single(r0, "val_loss")[0])
        log(f"[26b DDP net-10] {PAR_STEPS} steps of global batch {n} ({n // 2} a rank): step 1 "
            f"(the same initial state) train loss rel diff {dl0:.3e}, validation after it "
            f"{dv0:.3e} (each <= {PAR_LOSS_RTOL}); later steps are reported, not gated: a "
            f"reordering of the same batch in one process moves them as far (above); final "
            f"validation {r0['val_loss'][-1]:.6f} vs {single['val_loss'][-1]:.6f}, matched test "
            f"F1 {r0['test']['matched_f1']:.4f} vs {single['test']['matched_f1']:.4f}")
        check(dl0 <= PAR_LOSS_RTOL and dv0 <= PAR_LOSS_RTOL,
              "DDP's first step left the single-process run")
        check(ranks[0]["train_loss"] == ranks[1]["train_loss"],
              "the ranks report different global losses")
        glayers = 9
        for i, r in enumerate(ranks):
            log(f"[26b DDP net-10] rank {i} launches in the run: K5 {r['K5']}, K6 {r['K6']} "
                f"(each must be {glayers} x {PAR_STEPS} = {glayers * PAR_STEPS}), K4 {r['K4']} "
                f"in the validation and test passes (must be > 0)")
            check(r["K5"] == r["K6"] == glayers * PAR_STEPS and r["K4"] > 0,
                  "a rank did not launch K5/K6 once per GLayer and step")
        kinds = [json.loads(ln)["kind"] for ln in
                 (Path(work.name) / "ddp" / "metrics.jsonl").read_text().splitlines()]
        log(f"[26b DDP net-10] workdir: metrics.jsonl holds {kinds.count('epoch')} epoch and "
            f"{kinds.count('test')} test records (one writer: {PAR_STEPS} and 1)")
        check(kinds.count("epoch") == PAR_STEPS and kinds.count("test") == 1,
              "more than one rank wrote the workdir")

        # (c) NCCL at world 1: bit for bit the run without a mesh
        (nccl,) = spawn_ranks(net10_run, 1, backend="nccl", device="cuda",
                              args=(train, val, str(Path(work.name) / "nccl")),
                              timeout=PAR_TIMEOUT)
        same_loss = nccl["train_loss"] == single["train_loss"] and \
            nccl["val_loss"] == single["val_loss"]
        same_params = all(np.array_equal(nccl["params"][k], v) for k, v in single["params"].items())
        log(f"[26c NCCL world 1] {PAR_STEPS} steps: losses "
            f"{'bitwise equal' if same_loss else 'DIFFER'}, parameters "
            f"{'bitwise equal' if same_params else 'DIFFER'} to the run without a mesh; ms per "
            f"step + validation pass (median of epochs 2-{PAR_STEPS}): no mesh "
            f"{np.median(single['epoch_ms']):.2f}, NCCL world-1 DDP "
            f"{np.median(nccl['epoch_ms']):.2f}, gloo world 2 (time-shared) "
            f"{np.median(r0['epoch_ms']):.2f} {tag}")
        check(same_loss and same_params, "the world-1 NCCL run is not the run without a mesh")
        work.cleanup()

        # (d) the scaling CLI on this card
        polar.launches.reset()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            bench_scaling.main(["--devices", "1", "--json"])
        (row,) = json.loads(buf.getvalue().strip().splitlines()[-1])
        k1 = polar.launches.count
        log(f"[26d bench_scaling] --devices 1 (polar, 512 x 20 iterations): "
            f"{row['throughput_iters_per_s']:.0f} inst-iter/s, efficiency {row['efficiency']}; "
            f"K1 launches {k1} (must be > 0) {tag}")
        check(k1 > 0 and row["throughput_iters_per_s"] > 0, "bench_scaling did not run K1")

        # (e) the multi-rank dry run on this card
        t0 = time.time()
        with contextlib.redirect_stdout(io.StringIO()):
            dry = dryrun_multichip(2, device="cuda:0", backend="gloo")
        log(f"[26e dryrun_multichip] 2 gloo ranks on cuda:0: (train loss, sum |phi|) per rank "
            f"{dry} in {time.time() - t0:.1f} s")
        check(all(np.isfinite(v) for r in dry for v in r), "the dry run is not finite")
        log(f"[26 parallel] {time.time() - t_phase:.1f} s (the world-2 fleet {t_fleet:.1f} s)")
        totals = {k: v - start[k] for k, v in cheb_counts().items()}  # this process's
        return {"K1": k1, "K2": k2_single + sum(r["K2"] for r in ranks),
                **{k: totals[k] + nccl[k] + sum(r["total"][k] for r in ranks)
                   for k in ("K4", "K5", "K6")}}


def main() -> int:
    from admmnet_tpu_torch.kernels import cheb_filter, fused_admm_fast, polar

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's smoke test needs one GPU")
    t_start = time.time()
    sm = Smoke()
    sm.device()
    sm.build()
    sm.tc_sass()
    sm.k1_vs_plain()
    sm.k2_vs_plain()
    # 8: the main path's launches are counted from here to the end of phase 7
    polar.launches.reset()
    fused_admm_fast.launches.reset()
    sm.golden_gates()
    sm.main_path()
    sm.random_gate()
    counts = {"K1": polar.launches.count, "K2": fused_admm_fast.launches.count}
    log(f"[8 launches] main path (phases 5-7): K1 polar {counts['K1']}, "
        f"K2 fused {counts['K2']} (each must be > 0)")
    check(counts["K1"] > 0 and counts["K2"] > 0, "a kernel of the main path never launched")
    sm.fused_fallback()
    sm.timings()
    sm.k4_vs_plain()
    # the learned main path's launches are counted over phase 11
    cheb_filter.launches.reset()
    sm.learned_path()
    k4_net = cheb_filter.launches.count
    sm.learned_clis()
    counts["K4"] = cheb_filter.launches.count
    glayers = sm.net3_cfg.num_layers - 1  # the last depth runs no GLayer
    log(f"[11 launches] learned path (phase 11): K4 cheb_filter {counts['K4']} "
        f"(must be > 0), {k4_net} in the 512-scene forward (expect {glayers}, one per "
        f"GLayer that runs)")
    check(counts["K4"] > 0 and k4_net == glayers,
          "K4 did not launch once per GLayer on the learned path")
    sm.learned_timings()
    sm.profile()
    sm.k56_vs_plain()
    sm.golden_train_steps()
    # the training path's launches are counted over generate_dataset + train_cli
    for counter in (cheb_filter.launches, cheb_filter.fwd_launches, cheb_filter.bwd_launches):
        counter.reset()
    sm.training_run()
    # K5 and K6 run once per GLayer and step: net-3 runs the GLayer of its
    # first two depths (the last depth's G would feed nothing returned)
    tl, n = sm.train_launches, sm.train_steps
    log(f"[16 launches] training path (generate_dataset + train_cli): K5 {tl['K5']}, K6 "
        f"{tl['K6']} (each must be {glayers} x {n} steps = {glayers * n}), K4 {tl['K4']} in "
        f"the eval steps (must be > 0)")
    check(tl["K5"] == glayers * n and tl["K6"] == glayers * n and tl["K4"] > 0,
          "K5/K6 did not launch once per GLayer per training step")
    counts.update(K5=tl["K5"], K6=tl["K6"])
    sm.training_timings()
    sm.tmp.cleanup()
    sm.unfolded_vs_plain()
    # launches are counted over each route's solves: the escape hatch's in
    # phase 19, K7's in phase 20, K1's with bf16_store in phase 21's solve
    sm.escape_hatch()
    sm.k7_path()
    sm.k1_bf16()
    hl = sm.hatch_launches
    counts.update(K3=hl["K3"], K7=sm.k7_launches)
    log(f"[24 launches] escape hatch (phase 19): K3 {hl['K3']}, unfolded K2 "
        f"{hl['K2 unfolded']}; K7 (phase 20) {sm.k7_launches}; K1 with bf16_store (phase 21's "
        f"solve) {sm.k1_bf16_launches} (each must be > 0)")
    check(min(hl["K3"], hl["K2 unfolded"], sm.k7_launches, sm.k1_bf16_launches) > 0,
          "a kernel of the whole-solve routes never launched")
    sm.bench_time_cli()
    sm.variant_timings()
    k2_profile(sm.dev, f"[{sm.card}]")
    for k, v in sm.parallel().items():
        counts[k] += v
    log(f"[done] {time.time() - t_start:.1f} s")

    meta = {
        "K1": ("polar_psd", "admmnet_tpu_torch/kernels/csrc/polar.cu",
               "admmnet_tpu/kernels/polar.py:154"),
        "K2": ("fused_admm_fast", "admmnet_tpu_torch/kernels/csrc/fused_admm_fast.cu",
               "admmnet_tpu/kernels/fused_admm_fast.py:575"),
        "K4": ("cheb_filter", "admmnet_tpu_torch/kernels/csrc/cheb_filter.cu",
               "admmnet_tpu/kernels/cheb_filter.py:145"),
        "K5": ("cheb_filter_train_fwd", "admmnet_tpu_torch/kernels/csrc/cheb_filter.cu",
               "admmnet_tpu/kernels/cheb_filter.py:343"),
        "K6": ("cheb_bwd", "admmnet_tpu_torch/kernels/csrc/cheb_bwd.cu",
               "admmnet_tpu/kernels/cheb_filter.py:379"),
        "K3": ("fused_admm_lists", "admmnet_tpu_torch/kernels/csrc/fused_admm_fast.cu",
               "admmnet_tpu/kernels/fused_admm_fast.py:492"),
        "K7": ("fused_admm", "admmnet_tpu_torch/kernels/csrc/fused_admm.cu",
               "admmnet_tpu/kernels/fused_admm.py:209"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[k], **sm.kernels[k]}
        for k, (name, src, rep) in meta.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(sm.card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def time_cheb() -> int:
    """``--time-cheb``: phases 12 and 17's timing of K4 (B = 2048, 8192) and
    K5 (B = 256, 2048) alone, the median of CHEB_REPS calls each, to compare
    two trees on one card as ``--time-k6`` does."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: K4's and K5's timing needs one GPU")
    from admmnet_tpu_torch.kernels import _build
    from admmnet_tpu_torch.kernels import cheb_filter as kc

    _build.lib()
    dev = torch.device("cuda", 0)
    tag = f"[{card()}]"

    def report(name, B, calls):
        log(f"[time {name}] {ROOT} B={B}: median {np.median(calls):.3f} ms, mean "
            f"{np.mean(calls):.3f} ms; calls {' '.join(f'{t:.3f}' for t in calls)} {tag}")

    for B in B_TIME_NET:
        report("K4", B, k4_call_ms(*k4_inputs(B, dev)))
    for B in B_TIME_TRAIN:
        report("K5", B, k5_call_ms(kc, *k6_inputs(kc, B, dev)[:2]))
    return 0


def time_polar() -> int:
    """``--time-polar``: K1 (accurate, fast, fast with bf16_store) at
    B = 2048 m = 101, the median of POLAR_REPS CUDA-event calls each, and K7
    at B = 512 x 100 iterations with the default 32 x 32 nested projection
    and with outer_iters = inner_iters = 1 (the projection's share), the
    median of K7_REPS calls each; to compare two trees on one card as
    ``--time-k6`` does."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: K1's and K7's timing needs one GPU")
    from admmnet_tpu_torch.data.anchor import make_anchor_batch
    from admmnet_tpu_torch.kernels import _build
    from admmnet_tpu_torch.kernels import fused_admm as k7
    from admmnet_tpu_torch.kernels.polar import psd_project_polar_kernel

    _build.lib()
    dev = torch.device("cuda", 0)
    tag = f"[{card()}]"

    def report(name, calls):
        log(f"[time {name}] {ROOT}: median {np.median(calls):.3f} ms, mean "
            f"{np.mean(calls):.3f} ms; calls {' '.join(f'{t:.3f}' for t in calls)} {tag}")

    M = random_hermitian(np.random.default_rng(1), B_TIME_K1, 101, dev)
    for label, kw in (("accurate", dict(mode="accurate")), ("fast", dict(mode="fast")),
                      ("fast bf16_store", dict(mode="fast", bf16_store=True))):
        report(f"K1 {label} B={B_TIME_K1}",
               call_ms(lambda: psd_project_polar_kernel(M, **kw), POLAR_REPS))
    del M
    y, b, s = to_dev(dev, *make_anchor_batch(B_EXACT, "redemod", seed=0))
    for depth in (32, 1):
        report(f"K7 B={B_EXACT} x {ITERS} projection {depth}/{depth}",
               call_ms(lambda: k7.admm_solve_fused(y, b, s, ITERS, outer_iters=depth,
                                                    inner_iters=depth), K7_REPS))
    return 0


def codegen() -> int:
    """``--codegen``: build the kernels and print phase 2's ptxas report
    (registers and spills of every instantiation) and the HMMA and
    local-memory instruction counts of the tensor-core kernels, to compare
    the code of two trees as ``--time-k6`` pairs their times."""
    from admmnet_tpu_torch.kernels import _build

    _build.lib()
    log(f"[codegen] {ROOT}")
    log_ptxas("[codegen]")
    for name, (key, hmma, ldl, stl) in sorted(sass_counts().items()):
        log(f"[codegen {key} SASS] {demangle(name)}: {hmma} HMMA, {ldl} LDL / {stl} STL")
    return 0


def time_k6() -> int:
    """``--time-k6``: phase 17's timing of K6 alone, to compare two trees on
    one card.  Copy this file into the root of the other tree (for example
    the parent commit unpacked with ``git archive`` into ``build/parent``),
    then, in one session on the card, run ``python3 build/parent/chip_smoke.py
    --time-k6`` and ``python3 chip_smoke.py --time-k6`` in the order parent,
    change, change, parent: each process imports and builds the port beside
    its own file."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: K6's timing needs one GPU")
    from admmnet_tpu_torch.kernels import _build
    from admmnet_tpu_torch.kernels import cheb_filter as kc

    _build.lib()
    dev = torch.device("cuda", 0)
    tag = f"[{card()}]"
    for B in B_TIME_TRAIN:
        calls = k6_call_ms(kc, *k6_inputs(kc, B, dev))
        log(f"[time K6] {ROOT} B={B}: median {np.median(calls):.3f} ms, mean "
            f"{np.mean(calls):.3f} ms; calls {' '.join(f'{t:.3f}' for t in calls)} {tag}")
    return 0


def parallel_only() -> int:
    """``--parallel``: phase 26 alone, on the net-3 recipe's dataset made
    afresh by ``generate_dataset`` as phase 16 makes it."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the parallel phase needs one GPU")
    from admmnet_tpu_torch.cli import generate_dataset
    from admmnet_tpu_torch.data.generator import DatasetGenerator
    from admmnet_tpu_torch.kernels import _build

    _build.lib()
    sm = Smoke()
    sm.device()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        with contextlib.redirect_stdout(io.StringIO()):
            generate_dataset.main(["--out", tmp, "--fixed-snr", "20", "--total", "10000",
                                   "--seed", "13", "--device", "cuda"])
        gen = DatasetGenerator(data_dir=tmp)
        sm.train_split, sm.val_split = gen.load_split("train"), gen.load_split("val")
    log(f"[parallel] {ROOT}: launches {sm.parallel()}")
    return 0


def profile_k2() -> int:
    """``--profile-k2``: phase 25 alone (``k2_profile``), to compare two trees
    on one card as ``--time-k6`` does."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: K2's profile needs one GPU")
    from admmnet_tpu_torch.kernels import _build

    _build.lib()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[profile K2] {ROOT}")
    k2_profile(torch.device("cuda", 0), f"[{card()}]")
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--time-cheb", action="store_true",
                      help="time K4 and K5 alone as phases 12 and 17 do (see time_cheb) and run "
                           "nothing else")
    mode.add_argument("--time-k6", action="store_true",
                      help="time K6 alone as phase 17 does (see time_k6) and run nothing else")
    mode.add_argument("--codegen", action="store_true",
                      help="print the kernels' registers, spills and HMMA counts (see codegen) "
                           "and run nothing else")
    mode.add_argument("--time-polar", action="store_true",
                      help="time K1 and K7 alone (see time_polar) and run nothing else")
    mode.add_argument("--profile-k2", action="store_true",
                      help="run K2's subtraction profile alone (phase 25, see k2_profile)")
    mode.add_argument("--parallel", action="store_true",
                      help="run the parallel phase alone (phase 26, see parallel_only)")
    args = ap.parse_args()
    sys.exit(time_cheb() if args.time_cheb else time_k6() if args.time_k6
             else time_polar() if args.time_polar else codegen() if args.codegen
             else profile_k2() if args.profile_k2 else parallel_only() if args.parallel
             else main())
