#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``admmnet_tpu_torch``) on one GPU.

Builds the CUDA kernels from ``admmnet_tpu_torch/kernels/csrc`` and drives
the port's paths end to end on the card, through its public entry points,
against gates that no other harness holds there.  Each kernel it times
alone is also held to its plain PyTorch version on the same inputs, by the
card tests' limits (``tests/card_checks.py``); the card tests (``python -m
pytest --noconftest -m cuda tests/test_torch_cuda.py``) hold the kernels
over their sides, batches and edges, and the benchmark's cells
(``gpubench/run.py``) time the deploy points and the training step whole.
The phases keep their numbers; the gaps are the comparisons that moved to
the card tests.

- build and code generation (phase 2): ptxas's registers and spills, the
  dynamic shared memory and the HMMA count of every instantiation;
- the classical detection pipeline (phases 5-9): the solve against the
  committed eigh golden in every g_update, anchor / random-SNR scenes ->
  batched ADMM solve -> peak list -> detection score, the fused modes'
  fallback to the per-step loop above a lifted side of 128 (phase 8), and
  K2, K1 and the peak-search kernel timed alone beside their plain
  versions and held to them (phase 9);
- the learned pipeline (phases 11-12): the committed net-3 checkpoint
  (chebyshev GLayer on the Clenshaw kernel, spectrum head) on the 512
  random-SNR scenes, held against the JAX package's golden output, the
  learned CLIs on the card against the CPU, and K4 timed alone and held
  to its emulation;
- training (phases 15-17): three recipe steps of net-3 against the JAX
  package's golden steps and their emulation, then ``generate_dataset``
  and ``train_cli`` with the net-3 recipe (10k fixed-SNR-20 scenes, 15
  epochs) on the card through the native minibatch loader, scored against
  the committed net-3 checkpoint, and K5 and K6 timed alone and held to
  their emulations;
- the other whole-solve routes (phases 19-23): the escape hatch
  ``ADMMOptions(fused_layout="lists", ...)`` (K3) and K2's unfolded carry
  end to end (anchor and random-scene gates) and the layouts against each
  other, the first-generation fused solve K7 against the eigh golden and
  the per-step polar solve, a solve with K1's bf16 iterate storage, the
  ``bench_time`` CLI, and their timings, each kernel held to its plain
  version; then K2's subtraction profile by
  its ``ablate`` variants (phase 25);
- data parallelism (phase 26): the deploy point sharded over a world-2
  gloo fleet with both ranks on this card and the flagship net-10 trained
  with DistributedDataParallel on it, each against the same work in one
  process; net-10 on a world-1 NCCL fleet, bit for bit; ``bench_scaling
  --devices 1``; ``dryrun_multichip(2)`` on this card.  The ranks load the kernels
  built in phase 2;
- the phi-regression route (phase 27): ``generate_dataset --with-phi``
  labels 5000 scenes with K2's fused_exact solve (held against the
  complex128 eigh solve), a net-10 PhiEstADMMNet with the chebyshev GLayer
  takes three recipe steps against the JAX package's golden steps and
  trains through K5/K6 with ``train_cli --phi``, its trunk warm-starts
  runs/spec50k_warm's end-to-end net (``train_cli --init-from``), and
  ``eval_net`` deploys runs/phi10 with classical peak search on the
  labels' test split;
- upstream's published net (phase 28): runs/admmnet10 (ten layers, eigh
  GLayers on the batched Jacobi kernel, the attention head) on the card
  against the CPU, and the eigh kernel timed alone and held to the
  complex128 plain path.

Each path's kernel launches are counted and checked (phases 8, 11, 16, 24
and inside 26-28).  Precision: the kernels run the JAX package's tiers
(README, "PyTorch/CUDA port"), so the learned gates against the JAX
goldens (fp32 on a CPU) sit at limits re-based on the tier's CPU emulation
(tests/golden/cheb_tier_gap.py), and the training steps are also held to
that emulation run on the CPU (phases 15, 27).

Every phase prints one line with its numbers and the tolerance it is held
to; any failure raises (non-zero exit) before the last line.  The last line is the JSON status line

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

the line before it the card's name and power limit, and the one before
that a JSON summary of the kernels (each one's launches, its largest
absolute difference from its plain version, ``max_abs_err``, and its time
alone beside the plain version's).  Run from the repository root with ``python3
chip_smoke.py``; it needs one CUDA device and exits non-zero without one.
To pair two trees, one mode runs alone: ``--time-cheb`` phases 12 and 17's
timing of K4 and K5 (``time_cheb``), ``--time-k6`` phase 17's timing of K6
(``time_k6``), ``--time-polar`` K1's and K7's timing (``time_polar``),
``--time-peaks`` the peak-search kernel against its plain version
(``time_peaks``), ``--codegen`` phase 2's registers, spills and HMMA counts
(``codegen``), ``--profile-k2`` phase 25 (``k2_profile``) and
``--time-eigh`` the eigh kernel and the split of a round into its phases
(``time_eigh``); ``--parallel`` runs phase 26 alone (``parallel_only``),
``--phi-route`` phase 27 (``phi_route_only``) and ``--eigh`` phase 28
(``Smoke.eigh_net``).
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
sys.path.insert(0, str(ROOT / "tests"))  # card_checks; torch_rank_fns for the ranks
from card_checks import (  # noqa: E402  (the card tests' limits and checks)
    EIGH_ORTH_TOL,
    EIGH_REC_TOL,
    EIGH_W_TOL,
    K1_ONE_PASS,
    K1_PLAIN,
    K2_ONE_PASS,
    K4_ONE_PASS,
    K5_ONE_PASS,
    K6_TOL,
    K7_PLAIN,
    PEAK_H_TOL,
    eigh_errors,
    peak_height_gap,
    peak_lists_held,
    rel_err,
)

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
B_TIME_K2 = 8192  # timing shapes
B_TIME_K1 = 2048
B_TIME_NET = (2048, 8192)  # K4 timing batches
B_CLI = 128  # scenes of the eval_net CLI check
CHEB_DEGREE = 48
B_K56 = 64  # matrices of tests/golden/cheb_tier_gap.py's K5/K6 gradient inputs
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
# runs/profile_lean.py's subtraction profile of K2's unfolded lean kernel
# (--profile-k2): the full kernel at two iteration counts splits the fixed
# per-call cost from the per-iteration slope, then each ablate variant at
# the high count; sched2, a 4/3 cold root, final_hi off, best of the calls
B_PROFILE = 8192
PROFILE_ITERS = (100, 25)
PROFILE_REPS = 3
# The parallel phase (26): the flagship net-10 (MN = 100) trained
# data-parallel on a world-2 gloo fleet (both ranks on this card), against
# the same run in one process
B_PAR_SOLVE = 8192  # anchor scenes of the sharded deploy solve
PAR_SOLVE_RTOL = 1e-6  # its peaks vs one process's, relative to their largest
PAR_STEPS = 20  # steps of the DDP runs: 20 epochs of one global batch each
PAR_BATCH = 256  # global batch (128 a rank at world 2)
PAR_LOSS_RTOL = 5e-4  # tests/test_mesh_training.py's mesh-vs-single tolerance
# The validation loss after DDP's first step vs one process's: the step
# applies the first gradient, which at the card's one-pass tier moves with
# the order of the sums (PAR_GRAD_RTOL); measured on an H100 DDP 8.5e-3 and
# one process on the reordered batch 2.0e-2 (at fp32 both sat within
# PAR_LOSS_RTOL); the limit is ~2.5x that control.
PAR_VAL1_RTOL = 5e-2
PAR_ZLAYER_TOL = 1e-5  # the ZLayer under 2 ranks vs the whole batch (fp32 sums reordered)
# DDP's first gradient vs one process's: sums in another order through 10
# unrolled layers (the phase prints a reordering of the batch in one process
# beside it).  With the Clenshaw products at fp32 this sat at 2.7e-5 (limit
# 1e-3); at the card's one-pass tier the spectrum head's discontinuous
# top-k and argmax picks turn the forward's ~4e-3 rounding into a gradient
# that moves with the order of the sums: measured on an H100 DDP 3.39e-2
# and the reordered batch in one process 3.97e-2, so the limit is ~2.5x
# that control.  The phase checks that the gate still
# sees a rank left with its half batch's gradient (no all-reduce): that
# gradient must sit beyond the limit.
PAR_GRAD_RTOL = 0.1
PAR_TIMEOUT = 600  # seconds a fleet may take before it is killed
# The phi-regression route (27): RESULTS.md section 2's recipe.  The data
# (generate_dataset --with-phi: a 3500 / 750 / 750 split, fused_exact labels
# in chunks of 1024), a net-10 PhiEstADMMNet at runs/phi10's width with the
# chebyshev GLayer of runs/spec50k_warm's trunk trained on them (the recipe
# of trainPhi.py: lr 5e-3, batch 256), then runs/spec50k_warm's end-to-end
# net warm-started from its trunk, and runs/phi10 deployed with classical
# peak search on the labels' test split.
GOLDEN_PHI_TRAIN = ROOT / "tests" / "golden" / "phinet_train_golden.msgpack"
PHI10 = ROOT / "runs" / "phi10"
SPEC50K_WARM = ROOT / "runs" / "spec50k_warm"
PHI_DATA_ARGS = ("--total", "5000", "--fixed-snr", "20", "--with-phi", "--seed", "0")
PHI_LABEL_CHUNK = 1024  # label_phi's scenes per solve
B_PHI_CONTROL = 256  # labels held against the complex128 eigh solve
PHI_EPOCHS = 5
PHI_GOLDEN_STEPS_PER_EPOCH = 13  # 3500 // 256, the schedule of train_cli --phi here
WARM_EPOCHS = 2
PHI_LONG_FIRST_CYCLE_BEST = 1.299e-6  # RESULTS.md 2.8: runs/phi_long, epochs 1-10, eigh GLayer
PHI10_F1_BAND = 0.01  # phi10's F1 vs the labels' F1 on the same split (RESULTS 2: 0.876 / 0.877)
PHI10_NMSE_TOL = 1e-3  # phi10's phi scale-invariant NMSE vs the labels (RESULTS 2: 4.7e-4)
# The card's published peaks (H100 SXM at 700 W, NVIDIA's datasheet):
# fp32 outside the tensor cores, dense bf16 on the tensor cores (products
# of bf16-valued operands accumulated in fp32), and device memory bandwidth.
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12  # dense TF32 on the tensor cores
PEAK_BYTES = 3.35e12
# K4/K5's body (csrc/cheb_filter.cu), named in the kernels summary
CHEB_FWD_BODY = ("one thread-block cluster of P / 16 CTAs per matrix, bands in shared "
                 "memory, A and b_1 packed once as bf16 fragments and pulled by each warp "
                 "over distributed shared memory, one-pass bf16 mma.sync products (the "
                 "closing product 3xTF32 through tc_product.cuh with final_hi)")
# K1's and K7's body (csrc/polar_cta.cuh), named in the kernels summary
POLAR_BODY = ("one CTA per matrix or instance (a cluster of two at P = 128), the planes in "
              "shared memory, each whole product a mma.sync product of the CTA "
              "(polar_cta.cuh): 3xTF32 for hi steps and the closing product, one-pass bf16 "
              "for K1's low steps")
POLAR_REPS = 10  # timed calls of K1 per mode (--time-polar; the median is reported)
K7_REPS = 3  # timed calls of K7 per projection depth (--time-polar)
PEAK_REPS = 10  # timed calls of the peak search a batch (--time-peaks; the median is reported)
B_TIME_PEAKS = (1, 8192)  # a single scene's request and the deploy batch
NET10 = ROOT / "runs" / "admmnet10"  # upstream's published net: 10 layers, eigh G, attention
# runs/admmnet10 (9 eigh GLayers, the attention head) on the card against
# the CPU (complex128 eigh there): the plain fp32 Jacobi in the CPU's place
# measures phi 4.8e-6 (relative, worst scene) and the head 1.3e-6 (absolute)
# on 8 of the random scenes; held at ~20x for the kernel's other order
NET10_PHI_TOL = 1e-4
NET10_HEAD_TOL = 1e-4
EIGH_REPS = 5  # timed calls of the kernel at B = 4096 (the median is reported)

# Tolerances, with their reasons (each kernel against its plain version on
# the timing inputs: the card tests' limits, tests/card_checks.py):
# - K3, K2's unfolded carry and the folded K2 (one-pass tf32 low and
#   closing products) vs each other, 15 iterations, median / max
#   per-instance relative error of phi, held to K2_ONE_PASS.  In fp32 the JAX package's bands
#   held them (tests/test_fused_fast.py: lean vs lists 5e-5, folded vs
#   unfolded 1e-3); with one-pass products two layouts of the same
#   arithmetic sit as far apart as two summation orders do (measured on an
#   H100: their emulations 7.6e-3 and 9.4e-3 apart at the max, the kernels
#   7.9e-3 and 7.0e-3), and a kernel on the MXU's bf16 tier instead sat at
#   median 2.2e-2, max 7.9e-2 from its emulation.  The limits lie between;
#   the JAX package's band for "the fast mode's phi accuracy floor"
#   (tests/test_fused_fast.py, 0.05) is wider.
# - phi NMSE (scale-invariant, float64) vs the committed eigh golden.
EXACT_NMSE_TOL = 1e-5
POLAR_NMSE_TOL = 1e-5
EIGH_NMSE_TOL = 1e-5
FAST_NMSE_TOL = 0.2  # detection-grade contract; reference band ~0.06
FAST_NMSE_FP32 = 3.09e-2  # the fp32 tier's on an H100 (PERF.md)
FAST_NMSE_TPU = 0.0608  # BENCH_r05.json's phi_nmse_vs_eigh, one-pass bf16 on the MXU
K7_NMSE_TOL = 1e-5  # the phi-faithful gate that polar and fused_exact pass
# - K7 vs the port's per-step polar solve at 15 iterations,
#   tests/test_fused_kernel.py's bound.
K7_POLAR_TOL = 5e-4
# - net-3 trunk phi vs the JAX golden (fp32 on the CPU), per-scene relative
#   error, with K4's one-pass bf16 products: tests/golden/cheb_tier_gap.py
#   runs net-3 on the CPU at the card's tier (the emulation) and measures
#   median 4.17e-3 / max 7.62e-3 from the golden (float64 sums: 4.18e-3 /
#   7.51e-3), F1 equal to the golden's; limits ~2.5x that.  The fp32 gate
#   (2e-5 / 5e-5; measured 1.9e-6 / 5.2e-6) holds the plain path on the CPU
#   (tests/test_torch_net3_golden.py).
NET3_PHI_TOL = {"median": 1e-2, "max": 2e-2}
# - eval_net on the card vs on the CPU: the same detections up to one
#   flipped match (1 / 384 targets = 0.0026), RMSEs over the same pairs.
CLI_DET_TOL = 0.005
CLI_RMSE_TOL = 1e-3
# - three net-3 recipe steps vs the JAX golden (fp32 on the CPU): relative
#   error of each step's loss, and of the parameters' change over the steps
#   (||p - p_jax|| / ||p_jax - p_init||) over all leaves, which Adam's
#   normalization amplifies where a gradient is near zero.  At the card's
#   tiers (tests/golden/cheb_tier_gap.py, the emulation on the CPU) the
#   steps sit 4.9e-6 / 6.0e-4 / 1.9e-6 and 0.130 from the golden (the fp32
#   plain path 0 and 4.9e-3; on an H100 at 3xTF32 7.3e-8 and 9.0e-3);
#   limits ~2.5x that.  The steps are also held to the same steps run on
#   the CPU at the card's tiers (chip_smoke.card_tier_on_cpu): two
#   summation orders of that arithmetic (float32 vs float64 sums) sit
#   1.3e-6 / 3.9e-6 / 3.9e-4 and 0.032 apart; limits ~2.5-3x that.
GOLDEN_LOSS_TOL = 1.5e-3
GOLDEN_PARAM_TOL = 0.3
GOLDEN_EMUL_LOSS_TOL = 1e-3
GOLDEN_EMUL_PARAM_TOL = 0.1
# - the training run: the port's net-3 trained on the card from scratch vs
#   the committed net-3 checkpoint, matched test F1 on the same split; and
#   the test loss, the quantity training minimizes, must close at least
#   this share of the gap between the seed-0 init's test loss and the
#   committed checkpoint's (measured on an H100: 0.85 of it, and matched
#   F1 0 for the init against 0.8856 for both trained nets).
TRAIN_F1_BAND = 0.01
TRAIN_LOSS_GAP_CLOSED = 0.5
# - the phi route's labels vs the complex128 eigh solve of the same scenes:
#   the fused_exact contract (EXACT_NMSE_TOL) on the median scene.
PHI_LABEL_NMSE_TOL = EXACT_NMSE_TOL
# - three recipe steps of the net-10 phi net.  Step 1's loss, one forward
#   from the shared init, vs the JAX golden (fp32 on the CPU): at the card's
#   tiers ten layers of one-pass Clenshaw products move it 4.2e-2 (the
#   emulation on the CPU, tests/golden/cheb_tier_gap.py; float64 sums
#   4.3e-2; the fp32 plain path 3.9e-7); limit ~2.4x that.  After an
#   update the steps cannot be held to the fp32 golden at this tier: lr
#   5e-3 leaves step 3 steep (lr x 1.05 doubles its loss at fp32), and the
#   tier's 4% first loss turns into 1.3e-2 at step 2 and 0.99 at step 3
#   (step 3's loss is 8.2e-4 against the golden's ~8e-2) and a parameter
#   change error of 4.05, the same for both summation orders of the
#   emulation.  So the card's steps are held to the same steps run on the
#   CPU at the card's tiers (chip_smoke.card_tier_on_cpu), where two
#   summation orders of that arithmetic sit 6.2e-4 / 3.3e-4 / 0.125 apart
#   (steps 1-3) and 0.32 in parameters: limits ~3x that.  (At fp32 the
#   steps were held to the golden at 1e-4 and 0.3; the CPU's fp32 gates of
#   the phi route's training are tests/test_torch_phi_train.py.)
PHI_GOLDEN_STEP1_TOL = 0.1
PHI_EMUL_LOSS_TOL = (2e-3, 1e-3, 0.4)
PHI_EMUL_PARAM_TOL = 1.0


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


def k2_one_pass_gate(e: torch.Tensor):
    """(passed, text) of per-instance errors of K2 / K3 against their
    one-pass emulation, held to K2_ONE_PASS."""
    med, mx = float(e.median()), float(e.max())
    tol = K2_ONE_PASS
    return (med < tol["median"] and mx < tol["max"],
            f"median {med:.3e} (tol {tol['median']:g}), max {mx:.3e} (tol {tol['max']:g})")


def held(label: str, e, tol) -> None:
    """Log the per-instance errors ``e`` of a kernel against its plain
    version (a tensor, or a list of them: the largest median and max) and
    check them against ``tol``: a max, or a median and a max."""
    tol = tol if isinstance(tol, dict) else {"max": tol}
    es = e if isinstance(e, list) else [e]
    med, mx = max(float(x.median()) for x in es), max(float(x.max()) for x in es)
    said = f"median {med:.3e} (tol {tol['median']:g}), " if "median" in tol else ""
    log(f"{label} vs plain: per-instance rel err {said}max {mx:.3e} (tol {tol['max']:g})")
    check(med < tol.get("median", float("inf")) and mx < tol["max"],
          f"{label}: the kernel disagrees with its plain version")


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def cuda_ms(fn, reps: int = 1, keep: list = None) -> float:
    """Mean ms per call by CUDA events, after one warm call, whose output
    ``keep`` receives."""
    out = fn()
    if keep is not None:
        keep.append(out)
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
    """Useful operations of K6: 3 degree - 3 Karatsuba products per matrix
    (with the rebuilt b_degree's term)."""
    return B * (3 * degree - 3) * 3 * 2.0 * m**3


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
    """(one-pass bf16 bound ms, what bounds it, 3xTF32 bound ms) of K4, or of
    K5 (which also writes the four carry planes) at batch B: every product
    one-pass bf16 (final_hi off), against the 3xTF32 tier's."""
    nbytes = cheb_bytes(B) + (B * 4 * 101 * 101 * 4 if carries else 0)
    b, by = bound(0.0, nbytes, cheb_flops(B))
    return b, by, tf32x3_bound(cheb_flops(B), nbytes)[0]


def k6_inputs(kc, B: int, dev):
    """Phase 17's K6 timing inputs at batch B (seed 5): M, c, Y and K5's
    carries."""
    M, c, Y = cheb_inputs(np.random.default_rng(5), B, dev)
    return M, c, Y, kc.cheb_filter_planes(M, c, CHEB_DEGREE, carries=True)[2]


def k4_call_ms(M, c, keep: list = None) -> list:
    """ms of each of CHEB_REPS back-to-back K4 calls through the GLayer's
    entry point (call_ms)."""
    from admmnet_tpu_torch.kernels.cheb_filter import cheb_filter_matrices

    return call_ms(lambda: cheb_filter_matrices(M, c, CHEB_DEGREE), CHEB_REPS, keep)


def k5_call_ms(kc, M, c, keep: list = None) -> list:
    """ms of each of CHEB_REPS back-to-back K5 calls (call_ms)."""
    return call_ms(lambda: kc.cheb_filter_planes(M, c, CHEB_DEGREE, carries=True), CHEB_REPS,
                   keep)


def k6_call_ms(kc, M, c, Y, carries, keep: list = None) -> list:
    """ms of each of CHEB_REPS back-to-back K6 calls (call_ms)."""
    return call_ms(lambda: kc.cheb_bwd(M, c, carries, Y, CHEB_DEGREE), CHEB_REPS, keep)


def call_ms(fn, reps: int, keep: list = None) -> list:
    """ms of each of ``reps`` back-to-back calls, by CUDA events between
    them, after one warm call, whose output ``keep`` receives."""
    out = fn()
    if keep is not None:
        keep.append(out)
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
    kernel on the card.  The norm, zupd and finals variants change the
    values that flow on, so their marginals can read negative (RESULTS.md
    3.6): they are reported as read, not subtracted into a total."""
    from admmnet_tpu_torch.data.anchor import make_anchor_batch
    from admmnet_tpu_torch.kernels import fused_admm_fast as kf
    from admmnet_tpu_torch.ops.projections import POLAR_BF16_SCHED2

    kw = dict(hi_steps=0, outer_iters=4, inner_iters=3, schedule=POLAR_BF16_SCHED2,
              final_hi=False, layout="lean", fold_diag=False)
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
    16 (P + 4) floats, the stage of 4 x 16 (P + 8), the packed bf16 A and
    b_1 (P / 16 x 1536 B each) and 16 floats of partials and slot."""
    return 4 * (6 * 16 * (P + 4) + 4 * 16 * (P + 8) + 16) + 2 * (P // 16) * 1536


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
    """{mangled name: (key, HMMA, LDL, STL, bf16 HMMA)} of the built
    library's kernels named in SASS_KEYS, from ``cuobjdump -sass`` (the
    bf16 HMMA: K1's one-pass m16n8k16 products; the rest are TF32)."""
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
            found[name] = (key, block.count("HMMA"), block.count("LDL"), block.count("STL"),
                           len(re.findall(r"HMMA\.\S*BF16", block)))
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


def tf32x3_bound(flops: float, nbytes: float, one_pass_flops: float = 0.0,
                 one_pass_peak: float = PEAK_TF32):
    """(bound ms, what bounds it) of fp32-faithful products run in 3xTF32
    on the tensor cores (three TF32 products per useful one) beside
    ``one_pass_flops`` of one-pass products at ``one_pass_peak`` (TF32's
    for K2/K3, bf16's for K1)."""
    t_ops = 3 * flops / PEAK_TF32 + one_pass_flops / one_pass_peak
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def fused_bounds(B: int, kw: dict, iters: int = ITERS):
    """(bound ms, what bounds it, 3xTF32 bound ms, fp32 SIMT bound ms) of a
    fused solve with the kernel options ``kw`` at B x iters: its one-pass
    products (one_pass_products) at TF32's rate, the rest in 3xTF32."""
    from admmnet_tpu_torch.kernels.fused_admm_fast import full_schedule, one_pass_products

    sched = full_schedule(kw["schedule"], kw["hi_steps"], kw.get("all_hi", False))
    total = solve_flops(B * iters, len(sched))
    low = one_pass_products(len(sched), kw["hi_steps"], kw.get("all_hi", False),
                            kw["final_hi"])
    low_flops = B * iters * low * 2.0 * 101**3
    nbytes = solve_bytes(B)
    b, by = tf32x3_bound(total - low_flops, nbytes, low_flops)
    return b, by, tf32x3_bound(total, nbytes)[0], bound(total, nbytes)[0]


def polar_fast_bound(B: int, nsteps: int = 6, m: int = 101):
    """(bound ms, what bounds it) of K1 fast with nsteps low steps: 9 one-pass
    products a step at bf16's rate, 3 closing ones in 3xTF32."""
    low, closing = B * 9 * nsteps * 2.0 * m**3, B * 3 * 2.0 * m**3
    return tf32x3_bound(closing, B * 2 * m * m * 8, low, PEAK_BF16)


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


def golden_steps(dev, state_out=None):
    """Three net-3 recipe steps on ``dev`` from the JAX golden's init, on the
    golden's batches: (losses, golden losses, parameter change error); the
    parameters after the steps (on the CPU) into ``state_out``, if given."""
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
    if state_out is not None:
        state_out.update({k: v.cpu() for k, v in model.state_dict().items()}, init=init)
    return np.array(losses), np.asarray(gold["losses"], np.float64), err


def net3_vs_golden(dev) -> dict:
    """The committed net-3 (runs/train_net3_r05) on ``dev`` on the 512
    random-SNR scenes as one batch, against the JAX package's golden
    output: the model and its config, the scenes, the port's and the
    golden's match_peaks stats (``st``, ``gst``), the predictions, and the
    per-scene relative error of phi (its median and max)."""
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
    model = model.to(dev).eval()
    y, b, s = to_dev(dev, raw["y"], raw["b"], raw["sigma"])
    st, pred = evaluate_e2e(model, y, b, s, raw["tau"], raw["f"])
    e = np.linalg.norm(pred["phi"] - gold["phi"], axis=-1) / np.linalg.norm(gold["phi"], axis=-1)
    return {"model": model, "cfg": cfg, "raw": raw, "st": st, "gst": gst, "pred": pred,
            "med": float(np.median(e)), "mx": float(e.max())}


@contextlib.contextmanager
def card_tier_on_cpu():
    """The Clenshaw kernels' CPU dispatches at the card's tiers: the plain
    forward with ``one_pass=True`` (K4/K5's one-pass bf16 products) and the
    plain backward with ``three_pass=True, one_pass=True`` (K6's split-bf16
    products with rounded residuals), so a run on CPU tensors computes the
    card's arithmetic with its sums in another order."""
    from admmnet_tpu_torch.kernels import cheb_filter as kc

    fwd, bwd = kc.cheb_filter_matrices_plain_with_residuals, kc.cheb_bwd_plain

    def fwd_card(M, coeffs, degree, one_pass=False, final_hi=False):
        return fwd(M, coeffs, degree, True, final_hi)

    def bwd_card(M, coeffs, carries, Y, degree, three_pass=False, one_pass=False):
        return bwd(M, coeffs, carries, Y, degree, True, True)

    kc.cheb_filter_matrices_plain_with_residuals, kc.cheb_bwd_plain = fwd_card, bwd_card
    try:
        yield
    finally:
        kc.cheb_filter_matrices_plain_with_residuals, kc.cheb_bwd_plain = fwd, bwd


def state_distance(a: dict, b: dict) -> float:
    """||a - b|| / ||b - init|| over every leaf of two ``state_out`` dicts
    of the same steps (``init`` from b)."""
    init = b["init"]
    return param_change_error({k: a[k] for k in init}, {k: b[k] for k in init}, init)


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


def parallel_rank(mesh, train, val, workdir, case, deploy) -> dict:
    """Phase 26 (a) and (b) on one rank of the world-2 gloo fleet."""
    import torch_rank_fns

    start = cheb_counts()
    phi, peaks, k2 = torch_rank_fns.sharded_solve(mesh, *deploy)
    z = zlayer_halves(mesh, case)
    grad = first_gradient(mesh, train)
    out = net10_run(mesh, train, val, workdir)
    del out["params"]
    return {**out, "phi": phi, "peaks": peaks, "K2": k2, "zlayer": z, "grad": grad,
            "total": {k: v - start[k] for k, v in cheb_counts().items()}}


def flat_leaves(tree, path: str = ""):
    """(path, array) of every leaf of a nested dict, in key order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat_leaves(v, f"{path}/{k}")
    else:
        yield path, np.asarray(tree)


def phi_net_configs():
    """The phi route's net and recipe: a net-10 PhiEstADMMNet (hidden 128,
    MN = 100) with the chebyshev GLayer on the Clenshaw kernels, trained by
    trainPhi.py's recipe (lr 5e-3, batch 256, AdamW, SGDR) for PHI_EPOCHS;
    tests/golden/make_phinet_train_golden.py makes its golden steps."""
    from admmnet_tpu_torch.core.config import ModelConfig, ProblemSpec, TrainConfig

    return (ModelConfig(spec=ProblemSpec(Nb=10, Nd=10, L_max=3), num_layers=10,
                        g_mode="chebyshev", cheb_impl="pallas"),
            TrainConfig(batch_size=256, epochs=PHI_EPOCHS, lr=5e-3, patience=100, seed=0))


def phi_train_args() -> list:
    """``train_cli --phi`` flags of ``phi_net_configs``."""
    mcfg, tcfg = phi_net_configs()
    return ["--phi", "--num-layers", str(mcfg.num_layers), "--g-mode", mcfg.g_mode,
            "--cheb-impl", mcfg.cheb_impl, "--batch-size", str(tcfg.batch_size), "--lr",
            str(tcfg.lr), "--epochs", str(tcfg.epochs), "--patience", str(tcfg.patience),
            "--seed", str(tcfg.seed)]


def warm_train_args() -> list:
    """``train_cli`` flags of runs/spec50k_warm/config.json for WARM_EPOCHS,
    with the Clenshaw kernels as its GLayer's engine (the config names the
    default torch engine; the two compute the same function)."""
    run = json.loads((SPEC50K_WARM / "config.json").read_text())
    m, t = run["model"], run["train"]
    return ["--num-layers", str(m["num_layers"]), "--g-mode", m["g_mode"], "--cheb-impl",
            "pallas", "--head", m["head"], "--assignment", t["assignment"],
            "--spectral-weight", str(t["spectral_weight"]), "--lr", str(t["lr"]),
            "--batch-size", str(t["batch_size"]), "--patience", str(t["patience"]), "--seed",
            str(t["seed"]), "--epochs", str(WARM_EPOCHS)]


def phi_golden_steps(dev, order_seed=None, lr_scale: float = 1.0, state_out=None):
    """Three phi-route recipe steps on ``dev`` from the JAX golden's init,
    on the golden's scenes and labels: (losses, golden losses, parameter
    change error, each leaf's share of that error's square).  For the
    controls of tests/golden/phinet_golden_gap.py: ``order_seed``
    reorders each batch (only the order of the sums changes), ``lr_scale``
    scales the learning rate (a fault the gate must see).  The parameters
    after the steps (on the CPU) go into ``state_out``, if given, with the
    init under the key ``init``."""
    from admmnet_tpu_torch.core.convert import params_from_jax
    from admmnet_tpu_torch.models import PhiEstADMMNet
    from admmnet_tpu_torch.train.checkpoint import msgpack_decode
    from admmnet_tpu_torch.train.schedules import sgdr_schedule
    from admmnet_tpu_torch.train.trainer import batch_to_device, build_steps, make_optimizer

    mcfg, tcfg = phi_net_configs()
    gold = msgpack_decode(GOLDEN_PHI_TRAIN.read_bytes())
    init = params_from_jax(gold["init"]["params"], mcfg)
    after_gold = params_from_jax(gold["after"]["params"], mcfg)
    model = PhiEstADMMNet(mcfg)
    model.load_state_dict(init)
    model.to(dev)
    sched = sgdr_schedule(tcfg.lr * lr_scale, PHI_GOLDEN_STEPS_PER_EPOCH, tcfg.epochs,
                          tcfg.sgdr_t0, tcfg.sgdr_t_mult, tcfg.lr_min)
    step, _ = build_steps(model, make_optimizer(model, tcfg), "phi", sched, tcfg.grad_clip)
    n = GOLDEN_STEPS * GOLDEN_BATCH
    with np.load(RANDOM_SCENES) as d:
        raw = {k: d[k][:n] for k in ("y", "b", "sigma")}
    raw["phi"] = np.array(gold["phi"])  # writable: torch.from_numpy warns on a read-only view
    losses = []
    for i in range(GOLDEN_STEPS):
        batch = {k: v[i * GOLDEN_BATCH:(i + 1) * GOLDEN_BATCH] for k, v in raw.items()}
        if order_seed is not None:
            order = np.random.default_rng(order_seed + i).permutation(GOLDEN_BATCH)
            batch = {k: v[order] for k, v in batch.items()}
        losses.append(float(step(batch_to_device(batch, dev), i)))
    after = model.state_dict()
    err = param_change_error(after, after_gold, init)
    if state_out is not None:
        state_out.update({k: v.cpu() for k, v in after.items()}, init=init)
    sq = {k: float(torch.sum((after[k].cpu() - after_gold[k]) ** 2)) for k in init}
    total = sum(sq.values()) or 1.0
    return (np.array(losses), np.asarray(gold["losses"], np.float64), err,
            {k: v / total for k, v in sq.items()})


def eigh_launch_ms(M, max_sweeps: int) -> float:
    """Median ms of EIGH_REPS calls of ``eigh_jacobi_launch`` on the CUDA
    complex64 batch M (B, m, m) with ``max_sweeps``, sweep counts not
    written."""
    from admmnet_tpu_torch.kernels import _build
    from admmnet_tpu_torch.kernels import eigh as ke

    B, m = M.shape[0], M.shape[-1]
    w = torch.empty((B, m), dtype=torch.float32, device=M.device)
    V = torch.empty_like(M)
    return float(np.median(call_ms(lambda: _build.launch(
        "eigh_jacobi_launch", ke.launches, M=M, w=w, V=V, sweeps=None, B=B, m=m,
        max_sweeps=max_sweeps, smem=ke.smem_bytes(m)), EIGH_REPS)))


def eigh_timing(M, tag: str) -> dict:
    """The eigh kernel alone on the random batch M (B = 4096, m = 101): the
    median of EIGH_REPS calls, its device time under the profiler, the
    sweep counts, its bound, and the split of a round into its phases, by
    ``eigh_jacobi_launch`` with ``max_sweeps`` set: 0 (load, hermitize, sort
    and store), one sweep of a diagonal batch (its rounds run phase 1
    alone: no pair rotates) and one sweep of M (every round rotates)."""
    from admmnet_tpu_torch.kernels import eigh as ke
    from gpubench.flops.learned_eigh_deploy import eigh_bytes, eigh_flops

    B, m = M.shape[0], M.shape[-1]
    kernel = call_ms(lambda: ke.eigh_kernel(M)[0], EIGH_REPS)
    prof = device_profile(lambda: ke.eigh_kernel(M)[0])
    dev_ms = (sum(t for name, t in prof[2] if "eigh_jacobi" in name) / 1e3
              if prof is not None else float("nan"))
    sweeps = ke.eigh_kernel(M, sweeps=True)[2].float()
    # the benchmark's fixed count (36 m^3 a matrix) at the fp32 SIMT peak
    bound_ms, by = bound(eigh_flops(B, m), eigh_bytes(B, m))
    log(f"[28 eigh] {ROOT} time B={B} m={m}: kernel median {np.median(kernel):.3f} ms a call "
        f"(device {dev_ms:.3f} ms; calls {' '.join(f'{t:.3f}' for t in kernel)}); sweeps mean "
        f"{float(sweeps.mean()):.3f} max {int(sweeps.max())}; bound {bound_ms:.4f} ms ({by}, "
        f"{bound_ms / dev_ms:.2%} of it) {tag}")
    diag = torch.diag_embed(torch.randn(B, m, device=M.device)).to(M.dtype)
    rounds = m + (m & 1) - 1
    base = eigh_launch_ms(M, 0)
    phase1 = (eigh_launch_ms(diag, ke.MAX_SWEEPS) - base) / rounds
    phase2 = (eigh_launch_ms(M, 1) - base) / rounds - phase1
    sms = torch.cuda.get_device_properties(M.device).multi_processor_count
    per_sm = 1e3 * sms / B  # us of one block on its SM for each ms of the batch
    log(f"[28 eigh] {ROOT} phases B={B} m={m}: load, hermitize, sort and store {base:.3f} ms; a "
        f"round: phase 1 {phase1:.4f} ms, phase 2 {phase2:.4f} ms ({phase1 * per_sm:.3f} and "
        f"{phase2 * per_sm:.3f} us a matrix on its SM) {tag}")
    return {"ms": float(np.median(kernel)), "bound_ms": bound_ms, "bound_by": by,
            "phase1_ms": phase1, "phase2_ms": phase2}


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
        for name, (key, hmma, ldl, stl, bf16) in sorted(found.items()):
            log(f"[2 {key} SASS] {demangle(name)}: {hmma} HMMA ({bf16} bf16), {ldl} LDL / "
                f"{stl} STL (local memory)")
        hmma = {v: [h for k, h, _, _, _ in found.values() if k == v] for v in SASS_KEYS.values()}
        # K4/K5 at P = 112, 128; K6 at each of P = 112, 128 in both tiers;
        # K2/K3: 5 instantiations and 7 ablate variants at each of P = 112,
        # 128; K1 with and without bf16_store and K7 at each of P = 112, 128
        check([len(hmma[k]) for k in ("K4/K5", "K6", "K2/K3", "K1", "K7")] == [2, 4, 24, 4, 2]
              and min(sum(hmma.values(), [])) > 0,
              "a tensor-core kernel's SASS has no HMMA instruction")
        # bf16 m16n8k16 products: K1's low steps, K4/K5's Clenshaw steps and
        # K6's split tier (tcp::Prec 4, SPLIT_BF16); K6's 3xTF32 tier, K2/K3
        # and K7 have none
        check(all((v[4] > 0) == (v[0] in ("K1", "K4/K5") or "Prec)4" in demangle(n)
                                 or "PrecE4E" in n) for n, v in found.items()),
              "the bf16 HMMA are not where the one-pass and split-bf16 tiers are")

    # 5 -------------------------------------------------------------------
    def golden_gates(self):
        from admmnet_tpu_torch.core.config import ADMMOptions
        from admmnet_tpu_torch.data.anchor import make_anchor_batch
        from admmnet_tpu_torch.peaks import scale_invariant_nmse
        from admmnet_tpu_torch.solver import admm_solve_fixed

        with np.load(GOLDEN_EIGH) as d:
            golden = d["phi"]
        self.anchor = to_dev(self.dev, *make_anchor_batch(B_SOLVE, "redemod", seed=0))
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
            ref = (f"; the fp32 tier's {FAST_NMSE_FP32:g}, the TPU record's (one-pass bf16) "
                   f"{FAST_NMSE_TPU:g}" if label == "fused_fast" else "")
            log(f"[5 golden {label}] B={B} x {ITERS}: phi NMSE vs phi_eigh_2048 "
                f"{nmse:.3e} (tol {tol:g}{ref}) [{secs:.1f} s]")
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
        """K2, K1 and the peak-search kernel alone, each beside its plain
        version at its tier, for the kernels line, and held to it on the
        same inputs (the card tests' limits)."""
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
        from admmnet_tpu_torch.peaks import PeakResult, find_peaks
        from admmnet_tpu_torch.peaks.search import find_peaks_plain
        from admmnet_tpu_torch.solver import admm_solve_fixed
        from admmnet_tpu_torch.solver.admm import fused_kernel_options

        tag = f"[{self.card}]"
        y, b, s = to_dev(self.dev, *make_anchor_batch(B_TIME_K2, "redemod", seed=0))
        kw = fused_kernel_options(self.prod)
        pk, pp = [], []
        k2 = cuda_ms(lambda: admm_solve_fused_fast(y, b, s, ITERS, 1.0, 1.0, **kw), keep=pk)
        k2p = cuda_ms(lambda: admm_solve_fused_fast_plain(y, b, s, ITERS, 1.0, 1.0,
                                                          one_pass=True, **kw), keep=pp)
        (pk,), (pp,) = pk, pp
        check(bool(torch.all(torch.isfinite(torch.view_as_real(pk)))), "K2: non-finite phi")
        held(f"[9 K2 fused_fast] B={B_TIME_K2} x {ITERS}, one-pass emulation", rel_err(pk, pp),
             K2_ONE_PASS)
        n_ii = B_TIME_K2 * ITERS
        k2_bound, k2_by, k2_x3, k2_fp32 = fused_bounds(B_TIME_K2, kw)
        log(f"[9 time K2 fused_fast] B={B_TIME_K2} x {ITERS}: kernel {k2:.1f} ms "
            f"({n_ii / k2 * 1e3:.0f} inst-iter/s), plain {k2p:.1f} ms "
            f"({n_ii / k2p * 1e3:.0f} inst-iter/s); one-pass (TF32) bound {k2_bound:.1f} ms "
            f"({k2_by}; {k2_bound / k2:.1%} of it), 3xTF32 bound {k2_x3:.1f} ms "
            f"({k2_x3 / k2:.1%}), fp32 SIMT bound {k2_fp32:.1f} ms ({k2_fp32 / k2:.1%}) {tag}")
        self.kernels["K2"] = dict(max_abs_err=max_abs(pk, pp), ms=k2, plain_ms=k2p,
                                  bound_ms=k2_bound, bound_by=k2_by, library_ms=None)

        M = random_hermitian(np.random.default_rng(1), B_TIME_K1, 101, self.dev)
        k1_err = 0.0
        for mode in ("accurate", "fast"):
            Pk, Pp = [], []
            k1 = cuda_ms(lambda: psd_project_polar_kernel(M, mode=mode), reps=3, keep=Pk)
            k1p = cuda_ms(lambda: psd_project_polar_plain(M, mode=mode, one_pass=mode == "fast"),
                          reps=3, keep=Pp)
            (Pk,), (Pp,) = Pk, Pp
            held(f"[9 K1 {mode}] B={B_TIME_K1} m=101", rel_err(Pk, Pp),
                 K1_ONE_PASS if mode == "fast" else K1_PLAIN)
            k1_err = max(k1_err, max_abs(Pk, Pp))
            k1_bound, k1_by, k1_fp32 = polar_bounds(B_TIME_K1, 7 if mode == "accurate" else 6)
            if mode == "fast":
                k1_x3 = k1_bound
                k1_bound, k1_by = polar_fast_bound(B_TIME_K1)
            log(f"[9 time K1 {mode}] B={B_TIME_K1} m=101: kernel {k1:.2f} ms, "
                f"plain {k1p:.2f} ms per call; "
                + (f"one-pass (bf16) bound {k1_bound:.3f} ms ({k1_by}; {k1_bound / k1:.1%} of "
                   f"it), all-3xTF32 bound {k1_x3:.2f} ms {tag}" if mode == "fast" else
                   f"3xTF32 tensor-core bound {k1_bound:.2f} ms ({k1_by}; "
                   f"{k1_bound / k1:.1%} of it), fp32 SIMT bound {k1_fp32:.2f} ms "
                   f"({k1_fp32 / k1:.1%} of it) {tag}"))
            if mode == "accurate":
                self.kernels["K1"] = dict(ms=k1, plain_ms=k1p, bound_ms=k1_bound,
                                          bound_by=k1_by, library_ms=None, body=POLAR_BODY,
                                          fp32_bound_ms=k1_fp32)
        self.kernels["K1"]["max_abs_err"] = k1_err

        cfg = PRODUCTION_PEAKS
        phi = admm_solve_fixed(y, b, s, DETECTION_BUDGET_ITERS, 1.0, self.prod)
        pk, pp = [], []
        ms = float(np.median(call_ms(lambda: find_peaks(phi, 10, 10, cfg), PEAK_REPS, pk)))
        pms = float(np.median(call_ms(lambda: find_peaks_plain(phi, 10, 10, cfg), PEAK_REPS,
                                      pp)))
        pk, pp = pk[0], PeakResult(*pp[0])
        gap = peak_height_gap(pk, pp, cfg)
        near = torch.isfinite(gap)
        worst = float(gap[near].max()) if bool(near.any()) else 0.0
        n_differ, n_bad = peak_lists_held(phi, pk, pp, cfg)
        ordered = bool((pk.height[:, 1:] <= pk.height[:, :-1]).all())
        log(f"[9 peaks] B={B_TIME_K2}, K2 phi at the detection budget, PRODUCTION_PEAKS, vs "
            f"plain: valid entries {int(pk.valid.sum())} (plain {int(pp.valid.sum())}), largest "
            f"height gap {worst:.3e} of the top (tol {PEAK_H_TOL[cfg.refine_precision]:g}); "
            f"{n_differ} scenes differ, {n_bad} of them not at a near tie of the coarse grid "
            f"with real peaks (must be 0); heights descending {ordered}")
        check(n_bad == 0 and ordered, "the peak-search kernel disagrees with its plain version")
        peak_err = float((gap[near] * pp.height[near, 0]).max()) if bool(near.any()) else 0.0
        bms, by = peak_search_bound(B_TIME_K2, cfg)
        log(f"[9 time peaks] B={B_TIME_K2}, K2 phi at the detection budget, PRODUCTION_PEAKS: "
            f"kernel {ms:.4f} ms, plain {pms:.4f} ms a call (median of {PEAK_REPS}); bound "
            f"{bms:.4f} ms ({by}; {bms / ms:.1%} of it) {tag}")
        self.kernels["peaks"] = {"max_abs_err": peak_err, "ms": ms, "plain_ms": pms,
                                 "bound_ms": bms, "bound_by": by, "library_ms": None}

    # 11 ------------------------------------------------------------------
    def learned_path(self):
        """The learned main path: checkpoint -> net-3 on the card -> score."""
        t0 = time.time()
        r = net3_vs_golden(self.dev)
        secs = time.time() - t0
        raw, st, gst, pred, med, mx = (r[k] for k in ("raw", "st", "gst", "pred", "med", "mx"))
        cfg = self.net3_cfg = r["cfg"]
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
        """K4 alone beside its plain version (the one-pass emulation), for
        the kernels line, and held to it on the same inputs."""
        from admmnet_tpu_torch.kernels.cheb_filter import cheb_filter_matrices_plain

        tag = f"[{self.card}]"
        k4_err = 0.0
        for B in B_TIME_NET:
            M, c = k4_inputs(B, self.dev)
            G, Ge = [], []
            calls = k4_call_ms(M, c, G)
            k4 = float(np.median(calls))
            k4p = cuda_ms(lambda: cheb_filter_matrices_plain(M, c, CHEB_DEGREE, one_pass=True),
                          reps=3, keep=Ge)
            (G,), (Ge,) = G, Ge
            held(f"[12 K4] B={B} m=101 degree {CHEB_DEGREE}, one-pass emulation", rel_err(G, Ge),
                 K4_ONE_PASS)
            k4_err = max(k4_err, max_abs(G, Ge))
            k4_bound, k4_by, k4_x3 = cheb_bounds(B, carries=False)
            log(f"[12 time K4] one GLayer call, B={B} m=101 degree {CHEB_DEGREE}: kernel "
                f"{k4:.2f} ms, the median of {CHEB_REPS} calls {min(calls):.2f}-{max(calls):.2f} "
                f"({cheb_flops(B) / k4 / 1e9:.2f} TFLOP/s useful), plain (one-pass emulation) "
                f"{k4p:.2f} ms; one-pass bf16 bound {k4_bound:.2f} ms ({k4_by}; "
                f"{k4_bound / k4:.1%} of it), 3xTF32 bound {k4_x3:.2f} ms {tag}")
            del M, c, G, Ge
        self.kernels["K4"] = dict(max_abs_err=k4_err, ms=k4, plain_ms=k4p, bound_ms=k4_bound,
                                  bound_by=k4_by, library_ms=None, body=CHEB_FWD_BODY,
                                  tf32x3_bound_ms=k4_x3)

    # 15 ------------------------------------------------------------------
    def golden_train_steps(self):
        t0 = time.time()
        state = {}
        losses, gold, err = golden_steps(self.dev, state_out=state)
        secs = time.time() - t0
        e_loss = float(np.max(np.abs(losses - gold) / np.abs(gold)))
        log(f"[15 golden steps] net-3, {GOLDEN_STEPS} recipe steps of {GOLDEN_BATCH} scenes "
            f"from the JAX seed-0 init: losses {np.round(losses, 7).tolist()} vs JAX "
            f"{np.round(gold, 7).tolist()}, max rel err {e_loss:.3e} (tol {GOLDEN_LOSS_TOL:g}); "
            f"parameter change error {err:.3e} (tol {GOLDEN_PARAM_TOL:g}) [{secs:.1f} s]")
        check(np.all(np.isfinite(losses)), "golden steps: non-finite loss")
        check(e_loss < GOLDEN_LOSS_TOL and err < GOLDEN_PARAM_TOL, "golden steps vs JAX")
        t0 = time.time()
        emul = {}
        with card_tier_on_cpu():
            le, _, _ = golden_steps(torch.device("cpu"), state_out=emul)
        e_emul = float(np.max(np.abs(losses - le) / np.abs(le)))
        d_emul = state_distance(state, emul)
        log(f"[15 golden steps] the same steps on the CPU at the card's tiers (emulation): "
            f"losses {np.round(le, 7).tolist()}, max rel diff {e_emul:.3e} (tol "
            f"{GOLDEN_EMUL_LOSS_TOL:g}); parameter distance {d_emul:.3e} (tol "
            f"{GOLDEN_EMUL_PARAM_TOL:g}) [{time.time() - t0:.1f} s]")
        check(e_emul < GOLDEN_EMUL_LOSS_TOL and d_emul < GOLDEN_EMUL_PARAM_TOL,
              "golden steps vs their emulation")

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
        """K5 and K6 alone beside their plain versions at their tiers, for
        the kernels line, and held to them on the same inputs (the zero
        matrix left out): K5's output bit for bit K4's and its carries vs
        the one-pass emulation, K6's split tier vs its rounded emulation."""
        from admmnet_tpu_torch.kernels import cheb_filter as kc

        tag = f"[{self.card}]"
        D, m = CHEB_DEGREE, 101
        k5_err = k6_err = 0.0
        for B in B_TIME_TRAIN:
            M, c, Y, carries = k6_inputs(kc, B, self.dev)
            cropped = [x[:, :m, :m].contiguous() for x in carries]
            out5, emul5, out6, emul6 = [], [], [], []
            calls5 = k5_call_ms(kc, M, c, out5)
            k5 = float(np.median(calls5))
            k5p = cuda_ms(lambda: kc.cheb_filter_matrices_plain_with_residuals(M, c, D, True),
                          reps=3, keep=emul5)
            calls = k6_call_ms(kc, M, c, Y, carries, out6)
            k6 = float(np.median(calls))
            k6p = cuda_ms(lambda: kc.cheb_bwd_plain(M, c, cropped, Y, D, True, True), reps=3,
                          keep=emul6)
            (Gr, Gi, car5), (Ge, care), (Abar, cbar), (Ap, cp) = (
                x[0] for x in (out5, emul5, out6, emul6))
            G4r, G4i, _ = kc.cheb_filter_planes(M, c, D)
            check(torch.equal(Gr, G4r) and torch.equal(Gi, G4i), "K5's output differs from K4's")
            e5 = [rel_err(k[:-1, :m, :m], e[:-1]) for k, e in zip(car5, care)]
            held(f"[17 K5 carries] B={B} m={m} degree {D}, one-pass emulation", e5,
                 {"median": K4_ONE_PASS["median"], "max": K5_ONE_PASS})
            k5_err = max(k5_err, max_abs(torch.complex(Gr[:, :m, :m], Gi[:, :m, :m]), Ge),
                         *(max_abs(k[:, :m, :m], e) for k, e in zip(car5, care)))
            Mb, Mbp = (kc.normalization_backward(M, A)[:-1] for A in (Abar, Ap))
            check(bool(torch.all(torch.isfinite(torch.view_as_real(Mb)))), "K6: non-finite Mbar")
            tol = K6_TOL[True]
            held(f"[17 K6 Mbar] B={B}, split tier, rounded split emulation", rel_err(Mb, Mbp),
                 tol)
            held(f"[17 K6 cbar] B={B}", rel_err(cbar[:-1], cp[:-1]), tol["cbar"])
            k6_err = max(k6_err, max_abs(Abar, Ap), max_abs(cbar, cp))
            b5, by5, b5x = cheb_bounds(B, carries=True)
            # K6's split-bf16 products: three bf16 passes per useful product;
            # the 3xTF32 tier's bound (three TF32 passes) beside it
            b6, by6 = bound(0.0, cheb_bwd_bytes(B), 3 * cheb_bwd_flops(B))
            b6x, _ = tf32x3_bound(cheb_bwd_flops(B), cheb_bwd_bytes(B))
            log(f"[17 time K5] B={B} m=101 degree {D}: kernel {k5:.3f} ms, the median of "
                f"{CHEB_REPS} calls {min(calls5):.3f}-{max(calls5):.3f}, plain {k5p:.2f} ms; "
                f"one-pass bf16 bound {b5:.3f} ms ({by5}; {b5 / k5:.1%} of it), 3xTF32 bound "
                f"{b5x:.3f} ms {tag}")
            log(f"[17 time K6] B={B}: kernel {k6:.3f} ms, the median of {CHEB_REPS} calls "
                f"{min(calls):.3f}-{max(calls):.3f} ({cheb_bwd_flops(B) / k6 / 1e9:.2f} "
                f"TFLOP/s useful), plain {k6p:.2f} ms; split-bf16 bound {b6:.3f} ms ({by6}; "
                f"{b6 / k6:.1%} of it), 3xTF32 bound {b6x:.3f} ms {tag}")
            if B == 256:
                self.kernels["K5"] = dict(ms=k5, plain_ms=k5p, bound_ms=b5, bound_by=by5,
                                          library_ms=None, body=CHEB_FWD_BODY,
                                          tf32x3_bound_ms=b5x)
                self.kernels["K6"] = dict(ms=k6, plain_ms=k6p, bound_ms=b6, bound_by=by6,
                                          library_ms=None, tf32x3_bound_ms=b6x)
            del M, c, Y, carries, cropped, out5, emul5, out6, emul6, Gr, Gi, car5, Ge, care
            del Abar, cbar, Ap, cp, Mb, Mbp, G4r, G4i
        self.kernels["K5"]["max_abs_err"] = k5_err
        self.kernels["K6"]["max_abs_err"] = k6_err

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
        ok_ll, e_ll = k2_one_pass_gate(rel_err(phis["lists"], phis["lean"]))
        ok_fold, e_fold = k2_one_pass_gate(rel_err(phis["folded"], phis["lean"]))
        ok_lf, e_lf = k2_one_pass_gate(rel_err(phis["lists"], phis["folded"]))
        log(f"[19 hatch layouts] B={B_SOLVE} x {it} iters, per-instance rel err: K3 vs "
            f"unfolded K2 {e_ll}; folded vs unfolded K2 {e_fold}; K3 vs folded K2 {e_lf}")
        check(ok_ll, "K3 vs the unfolded K2")
        check(ok_fold and ok_lf, "the folded K2 vs the unfolded layouts")

    # 20 ------------------------------------------------------------------
    def k7_path(self):
        """K7 on the anchor: the solve scored against the eigh golden, then
        held against the per-step polar solve."""
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

    # 21 ------------------------------------------------------------------
    def k1_bf16(self):
        """One polar_fast solve of the anchor with polar_bf16_store (K1's bf16
        iterate storage) through admm_solve_fixed."""
        from admmnet_tpu_torch.core.config import ADMMOptions, PeakSearchConfig
        from admmnet_tpu_torch.kernels import polar
        from admmnet_tpu_torch.solver import admm_solve_fixed

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
        """K3, K2's unfolded carry, K7 and K1 with ``bf16_store`` alone,
        each beside its plain version at its tier and held to it on the
        same inputs."""
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
            pk, pp = [], []
            ms = cuda_ms(lambda: admm_solve_fused_fast(y, b, s, ITERS, 1.0, 1.0, **kw), keep=pk)
            pms = cuda_ms(lambda: admm_solve_fused_fast_plain(y, b, s, ITERS, 1.0, 1.0,
                                                              one_pass=True, **kw), keep=pp)
            (pk,), (pp,) = pk, pp
            check(bool(torch.all(torch.isfinite(torch.view_as_real(pk)))),
                  f"{key} {layout}: non-finite phi")
            held(f"[23 {key} {layout}, unfolded] B={B_TIME_K2} x {ITERS}, one-pass emulation",
                 rel_err(pk, pp), K2_ONE_PASS)
            bms, by, x3_ms, fp32_ms = fused_bounds(B_TIME_K2, kw)
            log(f"[23 time {key} {layout}, unfolded] B={B_TIME_K2} x {ITERS}, sched2, 4/3 cold: "
                f"kernel {ms:.1f} ms ({n_ii / ms * 1e3:.0f} inst-iter/s), plain {pms:.1f} ms; "
                f"one-pass (TF32) bound {bms:.1f} ms ({by}; {bms / ms:.1%} of it), 3xTF32 "
                f"bound {x3_ms:.1f} ms, fp32 SIMT bound {fp32_ms:.1f} ms {tag}")
            if key == "K3":
                self.kernels["K3"] = dict(max_abs_err=max_abs(pk, pp), ms=ms, plain_ms=pms,
                                          bound_ms=bms, bound_by=by, library_ms=None)
            else:
                k2 = self.kernels["K2"]
                k2["max_abs_err"] = max(k2["max_abs_err"], max_abs(pk, pp))
        del y, b, s

        y, b, s = (x[:B_EXACT] for x in self.anchor)
        pk = []
        ms = cuda_ms(lambda: k7.admm_solve_fused(y, b, s, ITERS), keep=pk)
        # the plain version: ~1e5 small launches, so one run, timed
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        pp = k7.admm_solve_fused_plain(y, b, s, ITERS)
        end.record()
        end.synchronize()
        plain_ms = start.elapsed_time(end)
        held(f"[23 K7] B={B_EXACT} x {ITERS}", rel_err(pk[0], pp), K7_PLAIN)
        flops = solve_flops(B_EXACT * ITERS, 7)
        bms, by = tf32x3_bound(flops, solve_bytes(B_EXACT))
        fp32_ms, _ = bound(flops, solve_bytes(B_EXACT))
        log(f"[23 time K7] B={B_EXACT} x {ITERS}: kernel {ms:.1f} ms "
            f"({B_EXACT * ITERS / ms * 1e3:.0f} inst-iter/s), plain {plain_ms:.1f} ms "
            f"(one run); 3xTF32 tensor-core bound {bms:.1f} ms ({by}; "
            f"{bms / ms:.1%} of it), fp32 SIMT bound {fp32_ms:.1f} ms ({fp32_ms / ms:.1%} of "
            f"it) {tag}")
        self.kernels["K7"] = dict(max_abs_err=max_abs(pk[0], pp), ms=ms, plain_ms=plain_ms,
                                  bound_ms=bms, bound_by=by, library_ms=None, body=POLAR_BODY,
                                  fp32_bound_ms=fp32_ms)

        M = random_hermitian(np.random.default_rng(1), B_TIME_K1, 101, self.dev)
        Pk, Pp = [], []
        ms = cuda_ms(lambda: psd_project_polar_kernel(M, mode="fast", bf16_store=True), reps=3,
                     keep=Pk)
        pms = cuda_ms(lambda: psd_project_polar_plain(M, "fast", bf16_store=True, one_pass=True),
                      reps=3, keep=Pp)
        held(f"[23 K1 fast bf16_store] B={B_TIME_K1} m=101, one-pass emulation",
             rel_err(Pk[0], Pp[0]), K1_ONE_PASS)
        k1 = self.kernels["K1"]
        k1["max_abs_err"] = max(k1["max_abs_err"], max_abs(Pk[0], Pp[0]))
        # the 6 low steps' 9 products each one-pass (bf16 operands); the 3
        # closing products read the fp32 M: in 3xTF32 on the tensor cores, or
        # as fp32 SIMT FMAs beside it
        bms, by = polar_fast_bound(B_TIME_K1)
        closing, nbytes = B_TIME_K1 * 3 * 2.0 * 101**3, B_TIME_K1 * 2 * 101 * 101 * 8
        fp32_ms, _ = bound(closing, nbytes, bf16_flops=B_TIME_K1 * 9 * 6 * 2.0 * 101**3)
        log(f"[23 time K1 fast bf16_store] B={B_TIME_K1} m=101: kernel {ms:.2f} ms, plain "
            f"{pms:.2f} ms per call; bound (bf16 low steps, 3xTF32 closing) {bms:.3f} ms "
            f"({by}; {bms / ms:.1%} of it), with fp32 SIMT closing {fp32_ms:.3f} ms {tag}")

    # 26 ------------------------------------------------------------------
    def parallel(self) -> dict:
        """Data parallelism on the card: on a world-2 gloo fleet (both ranks
        on this card: NCCL refuses two ranks on one device) (a) the deploy
        point sharded (torch_rank_fns.sharded_solve) against this process
        and (b) net-10 trained with DistributedDataParallel (global batch
        256, 128 a rank, the ZLayer's mean over the global batch) against
        the run in this process; (c) the same run on a world-1 NCCL fleet,
        bit for bit; (d) the scaling CLI on this card; (e) the multi-rank
        dry run on this card.  Returns the phase's kernel launches, over
        this process and every rank."""
        from admmnet_tpu_torch.cli import bench_scaling
        from admmnet_tpu_torch.core.config import (
            DETECTION_BUDGET_ITERS,
            PRODUCTION_PEAKS,
            ADMMOptions,
        )
        from admmnet_tpu_torch.data.anchor import make_anchor_batch
        from admmnet_tpu_torch.graft_entry import dryrun_multichip
        from admmnet_tpu_torch.kernels import polar
        from admmnet_tpu_torch.parallel import spawn_ranks
        from admmnet_tpu_torch.peaks import find_peaks
        from admmnet_tpu_torch.solver import admm_solve_fixed

        tag = f"[{self.card}]"
        t_phase = time.time()
        start = cheb_counts()
        log("[26 parallel] world-2 fleets below are two gloo ranks time-sharing this one card: "
            "their times are not scaling numbers")
        n = PAR_BATCH
        train = {k: v[:n] for k, v in self.train_split.items()}
        val = {k: v[:n] for k, v in self.val_split.items()}

        case = zlayer_case()
        opts = ADMMOptions(g_update="fused_fast")
        deploy = (*make_anchor_batch(B_PAR_SOLVE, mode="redemod", seed=0),
                  DETECTION_BUDGET_ITERS, opts)
        work = tempfile.TemporaryDirectory(dir=ROOT / "build")
        t0 = time.time()
        ranks = spawn_ranks(parallel_rank, 2, backend="gloo", device="cuda:0",
                            args=(train, val, str(Path(work.name) / "ddp"), case, deploy),
                            timeout=PAR_TIMEOUT)
        t_fleet = time.time() - t0
        r0 = ranks[0]

        # (a) the sharded deploy point against this process, by the card
        # test's rules (test_sharded_solve_gloo_fleet_on_one_card): phi and
        # the valid flags bit for bit (K2 is per instance), the peaks'
        # positions and heights within PAR_SOLVE_RTOL of their largest
        phi = admm_solve_fixed(*to_dev(self.dev, *deploy[:3]), DETECTION_BUDGET_ITERS, 1.0, opts)
        single = {k: v.cpu().numpy()
                  for k, v in find_peaks(phi, 10, 10, PRODUCTION_PEAKS)._asdict().items()}
        phi = phi.cpu().numpy()
        for i, r in enumerate(ranks):
            gap = 0.0
            for k in ("tau", "f", "height"):
                v = single[k].astype(np.float64)
                diff = np.abs(np.where(r["peaks"][k] == v, 0.0, r["peaks"][k] - v))
                gap = max(gap, float(np.max(diff)) / float(np.max(np.abs(v[np.isfinite(v)]))))
            same = (np.array_equal(r["phi"], phi)
                    and np.array_equal(r["peaks"]["valid"], single["valid"]))
            log(f"[26a sharded deploy] rank {i}: B={B_PAR_SOLVE} fused_fast x "
                f"{DETECTION_BUDGET_ITERS} + PRODUCTION_PEAKS on 2 gloo ranks, gathered vs one "
                f"process: phi and valid flags bit for bit {same}, peaks' largest relative gap "
                f"{gap:.3e} (tol {PAR_SOLVE_RTOL:g}); K2 launches {r['K2']} (must be > 0)")
            check(same and gap <= PAR_SOLVE_RTOL and r["K2"] > 0,
                  "the sharded deploy point differs from one process")

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
        half = {k: v[:n // 2] for k, v in train.items()}
        ghalf = float(np.linalg.norm(first_gradient(None, half, self.dev) - gref)
                      / np.linalg.norm(gref))
        log(f"[26b DDP first step] net-10 from its seed-0 init, global batch {n}: each rank's "
            f"clipped gradient (averaged by DDP) vs one process's, ||diff|| / ||g|| "
            f"{' '.join(f'{e:.3e}' for e in gerr)} (<= {PAR_GRAD_RTOL}); one process on the "
            f"batch reordered {gctl:.3e}; on its first half alone (no all-reduce) {ghalf:.3e} "
            f"(must be > {PAR_GRAD_RTOL})")
        check(max(gerr) <= PAR_GRAD_RTOL, "DDP's first step is not the single-process step")
        check(ghalf > PAR_GRAD_RTOL, "the first-gradient gate cannot see a missing all-reduce")

        single = net10_run(None, train, val, str(Path(work.name) / "single"), self.dev)
        control = net10_run(None, reordered, {k: v[perm] for k, v in val.items()},
                            str(Path(work.name) / "control"), self.dev)
        # (c) NCCL at world 1: bit for bit the run without a mesh
        (nccl,) = spawn_ranks(net10_run, 1, backend="nccl", device="cuda",
                              args=(train, val, str(Path(work.name) / "nccl")),
                              timeout=PAR_TIMEOUT)
        same = (nccl["train_loss"] == single["train_loss"]
                and nccl["val_loss"] == single["val_loss"]
                and all(np.array_equal(nccl["params"][k], v) for k, v in single["params"].items()))
        log(f"[26c NCCL world 1] net-10, {PAR_STEPS} steps of {n}: losses and parameters bit "
            f"for bit the run without a mesh: {same}")
        check(same, "NCCL at world 1 differs from the run without a mesh")

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
            f"{dv0:.3e} (<= {PAR_LOSS_RTOL}, {PAR_VAL1_RTOL}); later steps are reported, not "
            f"gated: a reordering of the same batch in one process moves them as far (above); "
            f"final "
            f"validation {r0['val_loss'][-1]:.6f} vs {single['val_loss'][-1]:.6f}, matched test "
            f"F1 {r0['test']['matched_f1']:.4f} vs {single['test']['matched_f1']:.4f}")
        check(dl0 <= PAR_LOSS_RTOL and dv0 <= PAR_VAL1_RTOL,
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
        return {"K1": k1, **{k: totals[k] + nccl[k] + sum(r["total"][k] for r in ranks)
                             for k in ("K4", "K5", "K6")}}

    # 27 ------------------------------------------------------------------
    def phi_route(self):
        """The phi-regression route on the card: (a) generate_dataset
        --with-phi labels 5000 scenes with K2 (fused_exact), held against
        the complex128 eigh solve; (b) three recipe steps of the net-10
        phi net against the JAX package's golden steps; (c) train_cli --phi
        trains it through K5/K6; (d) train_cli --init-from grafts its trunk
        into runs/spec50k_warm's end-to-end net; (e) eval_net deploys
        runs/phi10 with classical peak search on the labels' test split;
        (f) timings.  Returns the route's kernel launches in (a)-(e)."""
        from admmnet_tpu_torch.cli import eval_net, generate_dataset, train_cli
        from admmnet_tpu_torch.core.config import ADMMOptions
        from admmnet_tpu_torch.core.convert import options_from_jax, params_to_jax
        from admmnet_tpu_torch.data.generator import DatasetGenerator
        from admmnet_tpu_torch.kernels import cheb_filter as kc
        from admmnet_tpu_torch.kernels import fused_admm_fast
        from admmnet_tpu_torch.models import ADMMNet, PhiEstADMMNet
        from admmnet_tpu_torch.peaks import scale_invariant_nmse
        from admmnet_tpu_torch.solver import admm_solve_fixed
        from admmnet_tpu_torch.train import trainer
        from admmnet_tpu_torch.train.checkpoint import restore_checkpoint
        from admmnet_tpu_torch.train.schedules import sgdr_schedule

        tag = f"[{self.card}]"
        t_phase = time.time()
        glayers = phi_net_configs()[0].num_layers - 1  # the last depth runs no GLayer
        (ROOT / "build").mkdir(exist_ok=True)
        tmp = tempfile.TemporaryDirectory(dir=ROOT / "build")
        data, phi_work, warm_work = (Path(tmp.name) / d for d in ("phi5k", "phinet", "warm"))
        counts = {}

        # (a) the labels: generate_dataset --with-phi on the card
        fused_admm_fast.launches.reset()
        t0 = time.time()
        with contextlib.redirect_stdout(io.StringIO()):
            generate_dataset.main(["--out", str(data), *PHI_DATA_ARGS, "--device", "cuda"])
        t_gen = time.time() - t0
        counts["K2"] = fused_admm_fast.launches.count
        gen = DatasetGenerator(data_dir=data)
        splits = {s: gen.load_split(s) for s in ("train", "val", "test")}
        sizes = [len(v["y"]) for v in splits.values()]
        expect_k2 = sum(-(-n // PHI_LABEL_CHUNK) for n in sizes)
        train = splits["train"]
        rows = [np.asarray(train[k][:B_PHI_CONTROL], np.complex64 if k != "sigma" else np.float32)
                for k in ("y", "b", "sigma")]
        t0 = time.time()
        ref = admm_solve_fixed(*to_dev(self.dev, *rows), ITERS, 1.0,
                               ADMMOptions(g_update="eigh")).cpu().numpy()
        t_eigh = time.time() - t0
        nmse = np.array([scale_invariant_nmse(lab, r)
                         for lab, r in zip(train["phi"][:B_PHI_CONTROL], ref)])
        med = float(np.median(nmse))
        log(f"[27a labels] generate_dataset {' '.join(PHI_DATA_ARGS)} on the card: splits "
            f"{sizes} in {t_gen:.1f} s; K2 (fused_exact, chunks of {PHI_LABEL_CHUNK}) launches "
            f"{counts['K2']} (expect {expect_k2}: one per chunk of each split)")
        log(f"[27a labels] the first {B_PHI_CONTROL} training labels vs the complex128 eigh "
            f"solve of the same scenes, {ITERS} iterations ({t_eigh:.1f} s): per-scene phi "
            f"scale-invariant NMSE median {med:.3e} (tol {PHI_LABEL_NMSE_TOL:g}), max "
            f"{float(nmse.max()):.3e}")
        check(counts["K2"] == expect_k2, "the labelling did not launch K2 once per chunk")
        check(all(np.isfinite(v["phi"]).all() for v in splits.values()), "non-finite labels")
        check(med <= PHI_LABEL_NMSE_TOL, "the labels leave the fused_exact contract")

        # (b) three recipe steps against the JAX package's golden steps
        for counter in (kc.launches, kc.fwd_launches, kc.bwd_launches):
            counter.reset()
        t0 = time.time()
        state = {}
        losses, gold, err, _ = phi_golden_steps(self.dev, state_out=state)
        e_loss = np.abs(losses - gold) / np.abs(gold)
        golden = cheb_counts()
        log(f"[27b golden steps] net-10 phi net, {GOLDEN_STEPS} recipe steps of {GOLDEN_BATCH} "
            f"scenes from the JAX seed-0 init on JAX's labels: losses "
            f"{np.round(losses, 7).tolist()} vs JAX {np.round(gold, 7).tolist()}, rel err per "
            f"step {' '.join(f'{e:.3e}' for e in e_loss)} (tol step 1 "
            f"{PHI_GOLDEN_STEP1_TOL:g}); parameter change error {err:.3e}; K5 {golden['K5']}, "
            f"K6 {golden['K6']} (each {glayers} x {GOLDEN_STEPS}) [{time.time() - t0:.1f} s]")
        check(np.all(np.isfinite(losses)), "phi golden steps: non-finite loss")
        check(golden["K5"] == golden["K6"] == glayers * GOLDEN_STEPS,
              "the phi golden steps did not launch K5/K6 once per GLayer and step")
        check(e_loss[0] < PHI_GOLDEN_STEP1_TOL, "phi golden step 1 vs JAX")
        t0 = time.time()
        emul = {}
        with card_tier_on_cpu():
            le, _, _, _ = phi_golden_steps(torch.device("cpu"), state_out=emul)
        e_emul = np.abs(losses - le) / np.abs(le)
        d_emul = state_distance(state, emul)
        log(f"[27b golden steps] the same steps on the CPU at the card's tiers (emulation): "
            f"losses {np.round(le, 7).tolist()}, rel diff per step "
            f"{' '.join(f'{e:.3e}' for e in e_emul)} (tol "
            f"{' '.join(f'{t:g}' for t in PHI_EMUL_LOSS_TOL)}); parameter distance "
            f"{d_emul:.3e} (tol {PHI_EMUL_PARAM_TOL:g}) [{time.time() - t0:.1f} s]")
        check(all(e < t for e, t in zip(e_emul, PHI_EMUL_LOSS_TOL))
              and d_emul < PHI_EMUL_PARAM_TOL, "phi golden steps vs their emulation")

        # (c) train_cli --phi
        before = cheb_counts()
        buf = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(buf):
            train_cli.main(["--data", str(data), "--workdir", str(phi_work), *phi_train_args(),
                            "--device", "cuda"])
        t_phi = time.time() - t0
        phi_counts = {k: v - before[k] for k, v in cheb_counts().items()}
        hist = json.loads((phi_work / "training_history.json").read_text())
        epochs = len(hist["train_loss"])
        steps = epochs * -(-sizes[0] // phi_net_configs()[1].batch_size)
        epoch_s = [float(ln.split()[2].rstrip("s")) for ln in buf.getvalue().splitlines()
                   if ln.startswith("epoch")]
        for ln in buf.getvalue().splitlines():
            if ln.startswith("epoch"):
                log(f"[27c train_cli --phi]   {ln}")
        finite = all(np.isfinite(hist["train_loss"])) and all(np.isfinite(hist["val_loss"]))
        fell = hist["val_loss"][-1] < hist["val_loss"][0]
        log(f"[27c train_cli --phi] {' '.join(phi_train_args())}: {epochs} epochs, {steps} "
            f"steps in {t_phi:.1f} s; val loss {hist['val_loss'][0]:.4e} -> "
            f"{hist['val_loss'][-1]:.4e} (must fall: {fell}); best {min(hist['val_loss']):.4e} "
            f"(a reading: runs/phi_long's first SGDR cycle, eigh GLayer, 10 epochs, reached "
            f"{PHI_LONG_FIRST_CYCLE_BEST:g}); K5 {phi_counts['K5']}, K6 {phi_counts['K6']} (each "
            f"must be {glayers} x {steps} = {glayers * steps}), K4 {phi_counts['K4']} in the "
            f"validation and test passes (must be > 0)")
        check(finite and fell, "train_cli --phi: a loss is not finite or val loss did not fall")
        check(phi_counts["K5"] == phi_counts["K6"] == glayers * steps and phi_counts["K4"] > 0,
              "train_cli --phi did not launch K5/K6 once per GLayer and step")

        # (d) train_cli --init-from the phi run: the e2e net's trunk must be the
        # donor's best checkpoint bit for bit when its first step is built
        donor = restore_checkpoint(phi_work)[0]["params"]["params"]
        donor_leaves = dict(flat_leaves(donor["trunk"]))
        seen = {}
        real_build_steps = trainer.build_steps

        def capture(model, *a, **k):
            seen["trunk"] = dict(flat_leaves(params_to_jax(model.state_dict(), model.cfg)["trunk"]))
            return real_build_steps(model, *a, **k)

        before = cheb_counts()
        buf = io.StringIO()
        t0 = time.time()
        trainer.build_steps = capture
        try:
            with contextlib.redirect_stdout(buf):
                train_cli.main(["--data", str(data), "--workdir", str(warm_work), "--init-from",
                                str(phi_work), *warm_train_args(), "--device", "cuda"])
        finally:
            trainer.build_steps = real_build_steps
        t_warm = time.time() - t0
        warm_counts = {k: v - before[k] for k, v in cheb_counts().items()}
        lines = buf.getvalue().splitlines()
        graft = [ln for ln in lines if ln.startswith("warm-started")]
        for ln in graft + [ln for ln in lines if ln.startswith("epoch")]:
            log(f"[27d train_cli --init-from]   {ln}")
        whist = json.loads((warm_work / "training_history.json").read_text())
        wrun = json.loads((warm_work / "config.json").read_text())
        wcfg, wtcfg = options_from_jax(wrun["model"]), options_from_jax(wrun["train"])
        wsteps = len(whist["train_loss"]) * -(-sizes[0] // wtcfg.batch_size)
        same = (set(seen.get("trunk", {})) == set(donor_leaves)
                and all(np.array_equal(seen["trunk"][k], v) for k, v in donor_leaves.items()))
        wfinite = all(np.isfinite(whist["train_loss"])) and all(np.isfinite(whist["val_loss"]))
        log(f"[27d train_cli --init-from] runs/spec50k_warm's config, {len(whist['train_loss'])} "
            f"epochs, {wsteps} steps in {t_warm:.1f} s: the log names {graft}; the phi net's "
            f"trunk has {len(donor_leaves)} leaves; the e2e trunk before its first step is the "
            f"donor's best checkpoint bit for bit: {same}; losses finite: {wfinite} (train "
            f"{whist['train_loss']}, val {whist['val_loss']}); K5 {warm_counts['K5']}, K6 "
            f"{warm_counts['K6']} (each must be {glayers} x {wsteps} = {glayers * wsteps})")
        check(len(graft) == 1 and f"warm-started {len(donor_leaves)} leaves in submodules "
              "['trunk']" in graft[0], "the warm start did not graft the whole trunk")
        check(same, "the e2e trunk is not the phi net's best trunk before its first step")
        check(wfinite, "the warm-started run has a non-finite loss")
        check(warm_counts["K5"] == warm_counts["K6"] == glayers * wsteps,
              "the warm-started run did not launch K5/K6 once per GLayer and step")

        # (e) the reference's deploy of the phi net: runs/phi10 + peak search
        t0 = time.time()
        ev = run_cli(eval_net.main, ["--data", str(data), "--ckpt", str(PHI10), "--limit",
                                     str(sizes[2]), "--json", "--device", "cuda"])
        net, cls = ev["net_detection"], ev["classical_detection"]
        gap = abs(net["f1"] - cls["f1"])
        log(f"[27e eval_net phi10] {ev['samples']} test scenes on {ev['device']} "
            f"[{time.time() - t0:.1f} s]: F1 net {net['f1']:.4f} vs the labels' {cls['f1']:.4f} "
            f"(|gap| {gap:.4f}, tol {PHI10_F1_BAND}); tau/f RMSE net {net['tau_rmse']:.5f} / "
            f"{net['f_rmse']:.5f}, labels {cls['tau_rmse']:.5f} / {cls['f_rmse']:.5f}; phi "
            f"scale-invariant NMSE vs the labels {ev['phi_scale_invariant_nmse']:.3e} (tol "
            f"{PHI10_NMSE_TOL:g}); phi alignment loss {ev['phi_alignment_loss']:.3e} (RESULTS.md "
            f"2, JAX's split: F1 0.876 vs 0.877, NMSE 4.7e-4, loss 7.0e-7)")
        check(ev["device"] == "cuda" and gap <= PHI10_F1_BAND
              and ev["phi_scale_invariant_nmse"] <= PHI10_NMSE_TOL,
              "runs/phi10 on the port's labels misses the reference's deploy gates")
        counts.update({k: golden[k] + phi_counts[k] + warm_counts[k] for k in ("K4", "K5", "K6")})

        # (f) timings
        y, b, s = to_dev(self.dev, *(np.asarray(train[k][:PHI_LABEL_CHUNK],
                                                np.complex64 if k != "sigma" else np.float32)
                                     for k in ("y", "b", "sigma")))
        exact = ADMMOptions(g_update="fused_exact")
        label_ms = cuda_ms(lambda: admm_solve_fixed(y, b, s, ITERS, 1.0, exact))
        mcfg, tcfg = phi_net_configs()
        batch = trainer.batch_to_device({k: v[:tcfg.batch_size] for k, v in train.items()},
                                        self.dev)
        model = trainer.init_model(PhiEstADMMNet, mcfg, 1, self.dev)
        step, _ = trainer.build_steps(model, trainer.make_optimizer(model, tcfg), "phi",
                                      sgdr_schedule(tcfg.lr, PHI_GOLDEN_STEPS_PER_EPOCH,
                                                    tcfg.epochs), tcfg.grad_clip)
        phi_ms = cuda_ms(lambda: step(batch, 0), reps=5)
        wmodel = trainer.init_model(ADMMNet, wcfg, 1, self.dev)
        wstep, _ = trainer.build_steps(wmodel, trainer.make_optimizer(wmodel, wtcfg), "e2e",
                                       sgdr_schedule(wtcfg.lr, 13, wtcfg.epochs), wtcfg.grad_clip,
                                       wtcfg.assignment, wtcfg.spectral_weight)
        warm_ms = cuda_ms(lambda: wstep(batch, 0), reps=5)
        log(f"[27f time] labelling: one fused_exact K2 call of {PHI_LABEL_CHUNK} scenes x "
            f"{ITERS} iterations {label_ms:.1f} ms; phi net step (B={tcfg.batch_size}, "
            f"{glayers} GLayers) {phi_ms:.1f} ms, the trainer's epochs (steps + validation) "
            f"{' '.join(f'{t:.1f}' for t in epoch_s)} s; the warm-started e2e net's step "
            f"{warm_ms:.1f} ms {tag}")
        prof = device_profile(lambda: step(batch, 0))
        if prof is None:
            log("[27f profile phi step] torch.profiler shows no device time")
        else:
            busy, window_us, kernels = prof
            share = {key: sum(t for n, t in kernels if frag in n) / busy
                     for key, frag in (("K5", "cheb_filter_kernel"), ("K6", "cheb_bwd_kernel"))}
            top = "; ".join(f"{name[:40]} {t / busy:.1%}" for name, t in kernels[:6])
            log(f"[27f profile phi step] B={tcfg.batch_size}: device busy {busy / 1e3:.1f} ms "
                f"of a {window_us / 1e3:.1f} ms window ({busy / window_us:.1%}); K5 "
                f"{share['K5']:.1%}, K6 {share['K6']:.1%} of device time; {len(kernels)} kernel "
                f"names; by device time: {top} {tag}")
        tmp.cleanup()
        log(f"[27 phi route] {time.time() - t_phase:.1f} s; launches (a)-(e): {counts}")
        return counts


    # 28 ------------------------------------------------------------------
    def eigh_net(self) -> dict:
        """Upstream's published net (runs/admmnet10: 10 layers, eigh GLayers on
        the batched Jacobi kernel, the attention head) on the card against
        the CPU (complex128 eigh there), then the kernel's time at B = 4096
        beside the plain path's (hermitian_eigh, complex128 cuSOLVER), the
        kernel held to that path's eigenvalues on the same batch, and the
        judge's complex128 solves.  The kernel's sides, batches and edge
        spectra and the GLayer's kernel route are card tests
        (tests/test_torch_cuda.py).  Returns the kernel's entry of the
        ``kernels`` line; its ``launches`` are those of one forward of the
        published net (num_layers - 1), not of the timings."""
        from admmnet_tpu_torch.core.convert import options_from_jax, params_from_jax
        from admmnet_tpu_torch.kernels import _build
        from admmnet_tpu_torch.kernels import eigh as ke
        from admmnet_tpu_torch.models import ADMMNet
        from admmnet_tpu_torch.ops.projections import hermitian_eigh
        from admmnet_tpu_torch.train.checkpoint import restore_checkpoint

        dev, tag = self.dev, f"[{self.card}]"
        _build.lib()
        for ln in _build.build_logs.get("eigh_jacobi.cu", "").splitlines():
            if "registers" in ln or "spill" in ln or "smem" in ln:
                log(f"[28 eigh] ptxas eigh_jacobi.cu: {ln.strip()}")
        state, _ = restore_checkpoint(NET10)
        cfg = options_from_jax(json.loads((NET10 / "config.json").read_text())["model"])
        params = params_from_jax(state["params"]["params"], cfg)
        scenes = np.load(RANDOM_SCENES)
        y, b, s = (torch.from_numpy(np.asarray(scenes[k])) for k in ("y", "b", "sigma"))
        net_cpu = ADMMNet(cfg).eval()
        net_cpu.load_state_dict(params)
        net_dev = ADMMNet(cfg).to(dev).eval()
        net_dev.load_state_dict(params)
        # the main path's own launches: the counter runs over this forward alone
        with torch.no_grad():
            ke.launches.reset()
            out_d = [t.cpu() for t in net_dev(y.to(dev), b.to(dev), s.to(dev))]
            per_fwd = ke.launches.count
            out_c = net_cpu(y, b, s)
        phi_gap = float(rel_err(out_d[3], out_c[3]).max())
        head_gap = max(float((a - c).abs().max()) for a, c in zip(out_d[:3], out_c[:3]))
        log(f"[28 eigh] runs/admmnet10 on the {y.shape[0]} random scenes, card vs CPU: phi "
            f"{phi_gap:.3e} (tol {NET10_PHI_TOL:g}), head (tau, f, conf) {head_gap:.3e} (tol "
            f"{NET10_HEAD_TOL:g}); {per_fwd} eigh launches a forward (expect "
            f"{cfg.num_layers - 1})")
        check(phi_gap <= NET10_PHI_TOL and head_gap <= NET10_HEAD_TOL
              and per_fwd == cfg.num_layers - 1, "runs/admmnet10 on the card is off the CPU")

        # time: the kernel (with its phase split) and the plain path at B = 4096, m = 101
        M = random_hermitian(np.random.default_rng(28), 4096, 101, dev)
        timing = eigh_timing(M, tag)
        t0 = time.perf_counter()
        w_p, _ = hermitian_eigh(M)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        log(f"[28 eigh] time B=4096 m=101: plain path (hermitian_eigh, complex128 cuSOLVER) "
            f"{plain_ms:.1f} ms, {plain_ms / timing['ms']:.1f}x the kernel {tag}")
        w, V, sweeps = ke.eigh_kernel(M, sweeps=True)
        rec, orth, werr = (float(x.max()) for x in eigh_errors(M, w, V, w_ref=w_p))
        asc = bool((w[..., 1:] >= w[..., :-1]).all())
        log(f"[28 eigh] kernel vs plain B=4096 m=101: reconstruction {rec:.3e} (tol "
            f"{EIGH_REC_TOL:g}), orthogonality {orth:.3e} (tol {EIGH_ORTH_TOL:g}), eigenvalues "
            f"{werr:.3e} (tol {EIGH_W_TOL:g}), ascending {asc}, sweeps max {int(sweeps.max())} "
            f"(of {ke.MAX_SWEEPS})")
        check(rec <= EIGH_REC_TOL and orth <= EIGH_ORTH_TOL and werr <= EIGH_W_TOL and asc
              and int(sweeps.max()) < ke.MAX_SWEEPS, "eigh kernel: off the plain path")
        del w, V, sweeps, w_p
        # the judge's options for the benchmark's reference: complex128 eigh on
        # the card and on the host's LAPACK
        Ms = M[:256].to(torch.complex128)
        t0 = time.perf_counter()
        torch.linalg.eigh(Ms)
        torch.cuda.synchronize()
        card_ms = 1e3 * (time.perf_counter() - t0) / 256
        Mh = Ms.cpu()
        t0 = time.perf_counter()
        torch.linalg.eigh(Mh)
        host_ms = 1e3 * (time.perf_counter() - t0) / 256
        log(f"[28 eigh] complex128 torch.linalg.eigh at m=101: {card_ms:.3f} ms a matrix on the "
            f"card, {host_ms:.3f} ms on the host ({torch.get_num_threads()} threads)")
        return {"launches": per_fwd, "max_abs_err": werr, "ms": timing["ms"],
                "plain_ms": plain_ms, "bound_ms": timing["bound_ms"],
                "bound_by": timing["bound_by"], "library_ms": plain_ms}


def main() -> int:
    from admmnet_tpu_torch.kernels import cheb_filter, fused_admm_fast, peak_search, polar

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's smoke test needs one GPU")
    t_start = time.time()
    sm = Smoke()
    sm.device()
    sm.build()
    sm.tc_sass()
    # 8: the main path's launches are counted from here to the end of phase 7
    polar.launches.reset()
    fused_admm_fast.launches.reset()
    peak_search.launches.reset()
    sm.golden_gates()
    sm.main_path()
    sm.random_gate()
    counts = {"K1": polar.launches.count, "K2": fused_admm_fast.launches.count,
              "peaks": peak_search.launches.count}
    log(f"[8 launches] main path (phases 5-7): K1 polar {counts['K1']}, "
        f"K2 fused {counts['K2']}, peak search {counts['peaks']} (each must be > 0)")
    check(min(counts.values()) > 0, "a kernel of the main path never launched")
    sm.fused_fallback()
    sm.timings()
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
    for k, v in sm.phi_route().items():
        counts[k] += v
    sm.kernels["eigh"] = sm.eigh_net()
    counts["eigh"] = sm.kernels["eigh"].pop("launches")
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
        # replaces no TPU kernel: the JAX package searches with XLA ops
        "peaks": ("peak_search", "admmnet_tpu_torch/kernels/csrc/peak_search.cu", None),
        # replaces no TPU kernel: the JAX package's eigh GLayer calls jnp.linalg.eigh
        "eigh": ("eigh_jacobi", "admmnet_tpu_torch/kernels/csrc/eigh_jacobi.cu", None),
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


def time_eigh() -> int:
    """``--time-eigh``: the eigh kernel's timing alone (``eigh_timing``,
    B = 4096, m = 101) and ptxas's report of ``csrc/eigh_jacobi.cu``, to
    compare two trees on one card as ``--time-k6`` does."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the eigh kernel's timing needs one GPU")
    from admmnet_tpu_torch.kernels import _build

    _build.lib()
    for ln in _build.build_logs.get("eigh_jacobi.cu", "").splitlines():
        if "registers" in ln or "spill" in ln:
            log(f"[28 eigh] {ROOT} ptxas eigh_jacobi.cu: {ln.strip()}")
    dev = torch.device("cuda", 0)
    eigh_timing(random_hermitian(np.random.default_rng(28), 4096, 101, dev), f"[{card()}]")
    return 0


def eigh_only() -> int:
    """``--eigh``: phase 28 alone."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the eigh phase needs one GPU")
    sm = Smoke()
    sm.device()
    log(f"[eigh] {ROOT}: {sm.eigh_net()}")
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


def peak_search_bound(B: int, cfg, Nb: int = 10, Nd: int = 10):
    """(least ms, what bounds it) of the peak search of B scenes: the
    benchmark's count of its operations and bytes (gpubench/flops/
    classical_deploy.py: two complex products on the coarse grid, two per
    refine round and peak, 8 real operations a complex multiply-add; phi
    in, the lists out) at the fp32 SIMT peak (the kernel runs every
    product, the one-pass ones too, on the SIMT cores) or at 3.35 TB/s,
    the larger."""
    import dataclasses

    from gpubench.flops.classical_deploy import peaks_bytes, peaks_flops

    return bound(peaks_flops(B, Nb, Nd, dataclasses.asdict(cfg)),
                 peaks_bytes(B, Nb * Nd, cfg.max_peaks))


def time_peaks() -> int:
    """``--time-peaks``: the peak-search kernel (``find_peaks`` on the card)
    and its plain version (``find_peaks_plain``) at B = 1 and 8192 on K2's
    phi at the detection budget with PRODUCTION_PEAKS, the median of
    PEAK_REPS back-to-back CUDA-event calls each (a call's time: at B = 1
    the host's enqueue can set it), the kernel's device time a call under
    torch.profiler, its bound, and ptxas's report of
    ``csrc/peak_search.cu`` (when this process built the library).  The
    plain version is the parent tree's path on the card, so one tree times
    both."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the peak search's timing needs one GPU")
    from admmnet_tpu_torch.core.config import (
        DETECTION_BUDGET_ITERS,
        PRODUCTION_PEAKS,
        ADMMOptions,
    )
    from admmnet_tpu_torch.data.anchor import make_anchor_batch
    from admmnet_tpu_torch.kernels import _build
    from admmnet_tpu_torch.peaks import find_peaks
    from admmnet_tpu_torch.peaks.search import find_peaks_plain
    from admmnet_tpu_torch.solver import admm_solve_fixed

    _build.lib()
    dev = torch.device("cuda", 0)
    tag = f"[{card()}]"
    for ln in _build.build_logs.get("peak_search.cu", "").splitlines():
        if "registers" in ln or "spill" in ln:
            log(f"[time peaks] ptxas peak_search.cu: {ln.strip()}")
    y, b, s = to_dev(dev, *make_anchor_batch(max(B_TIME_PEAKS), "redemod", seed=0))
    phi_all = admm_solve_fixed(y, b, s, DETECTION_BUDGET_ITERS, 1.0,
                               ADMMOptions(g_update="fused_fast"))
    cfg = PRODUCTION_PEAKS
    for B in B_TIME_PEAKS:
        phi = phi_all[:B].contiguous()
        kernel = call_ms(lambda: find_peaks(phi, 10, 10, cfg).tau, PEAK_REPS)
        plain = call_ms(lambda: find_peaks_plain(phi, 10, 10, cfg)[0], PEAK_REPS)
        prof = device_profile(lambda: find_peaks(phi, 10, 10, cfg).tau)
        dev_ms = (sum(t for name, t in prof[2] if "peak_search" in name) / 1e3
                  if prof is not None else float("nan"))
        bound_ms, by = peak_search_bound(B, cfg)
        log(f"[time peaks] {ROOT} B={B}: kernel median {np.median(kernel):.4f} ms a call "
            f"(device {dev_ms:.4f} ms; bound {bound_ms:.4f} ms, {by}, "
            f"{bound_ms / dev_ms:.1%} of it), plain median {np.median(plain):.4f} ms; kernel "
            f"calls {' '.join(f'{t:.4f}' for t in kernel)} {tag}")
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
    for name, (key, hmma, ldl, stl, bf16) in sorted(sass_counts().items()):
        log(f"[codegen {key} SASS] {demangle(name)}: {hmma} HMMA ({bf16} bf16), {ldl} LDL / "
            f"{stl} STL")
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


def phi_route_only() -> int:
    """``--phi-route``: phase 27 alone."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the phi route needs one GPU")
    from admmnet_tpu_torch.kernels import _build

    _build.lib()
    sm = Smoke()
    sm.device()
    log(f"[phi route] {ROOT}: launches {sm.phi_route()}")
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
    mode.add_argument("--time-peaks", action="store_true",
                      help="time the peak-search kernel and its plain version alone (see "
                           "time_peaks) and run nothing else")
    mode.add_argument("--profile-k2", action="store_true",
                      help="run K2's subtraction profile alone (phase 25, see k2_profile)")
    mode.add_argument("--parallel", action="store_true",
                      help="run the parallel phase alone (phase 26, see parallel_only)")
    mode.add_argument("--phi-route", action="store_true",
                      help="run the phi-regression route alone (phase 27, see phi_route_only)")
    mode.add_argument("--eigh", action="store_true",
                      help="run the eigh phase alone (phase 28, see Smoke.eigh_net)")
    mode.add_argument("--time-eigh", action="store_true",
                      help="time the eigh kernel alone, with its phase split (see time_eigh), "
                           "and run nothing else")
    args = ap.parse_args()
    sys.exit(time_cheb() if args.time_cheb else time_k6() if args.time_k6
             else time_polar() if args.time_polar else time_peaks() if args.time_peaks
             else codegen() if args.codegen
             else profile_k2() if args.profile_k2 else parallel_only() if args.parallel
             else phi_route_only() if args.phi_route
             else eigh_only() if args.eigh else time_eigh() if args.time_eigh else main())
