#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``admmnet_tpu_torch``) on one GPU.

Drives the classical detection pipeline -- anchor / random-SNR scenes ->
batched ADMM solve -> peak list -> detection score -- through the port's
public entry points on the card, after building the CUDA kernels from
``admmnet_tpu_torch/kernels/csrc`` and holding each kernel against its plain
PyTorch version.  Every phase prints one line with its numbers and the
tolerance it is held to; any failure raises (non-zero exit) before the last
line.  The last line is the JSON contract line

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

and the line before it a JSON summary of the kernels.  Run from the
repository root with ``python3 chip_smoke.py``; it needs one CUDA device
and exits non-zero without one.
"""

from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
GOLDEN_EIGH = ROOT / "results" / "r05" / "phi_eigh_2048.npz"
RANDOM_SCENES = ROOT / "tests" / "golden" / "random512_key42.npz"

ITERS = 100  # full solve budget
B_SOLVE = 2048  # anchor instances, K2 vs its plain version
B_EXACT = 512  # fused_exact instances
B_POLAR_SOLVE = 256  # per-step polar / eigh solves vs the golden
B_K1 = 512  # matrices, K1 vs its plain version
B_TIME_K2 = 8192  # timing shapes
B_TIME_K1 = 2048
F1_BAND = 0.005  # random-scene gate: F1 >= eigh control - band

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
        regs = [ln.strip() for ln in _build.build_log.splitlines()
                if "registers" in ln or "spill" in ln]
        log(f"[2 build] K1 polar.cu + K2 fused_admm_fast.cu: {secs:.1f} s "
            f"(nvcc {_build.build_seconds}) -> {_build.library_path().name}")
        for ln in regs:
            log(f"[2 build]   ptxas {ln}")

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
        worst_abs = 0.0
        for label, opts, B in (("fused_fast", self.prod, B_SOLVE),
                               ("fused_exact", self.exact, B_EXACT)):
            kw = fused_kernel_options(opts)
            yy, bb, ss = (x[:B] for x in self.anchor)
            pk = admm_solve_fused_fast(yy, bb, ss, ITERS, opts.rho, 1.0, **kw)
            pp = admm_solve_fused_fast_plain(yy, bb, ss, ITERS, opts.rho, 1.0, **kw)
            torch.cuda.synchronize()
            check(bool(torch.all(torch.isfinite(torch.view_as_real(pk)))),
                  f"K2 {label}: non-finite phi")
            e = rel_err(pk, pp)
            med, mx = float(e.median()), float(e.max())
            worst_abs = max(worst_abs, float((pk - pp).abs().max()))
            log(f"[4 K2 {label}] B={B} x {ITERS} iters: kernel vs plain per-instance "
                f"rel err median {med:.3e} (tol {K2_PLAIN_TOL['median']:g}), "
                f"max {mx:.3e} (tol {K2_PLAIN_TOL['max']:g})")
            check(med < K2_PLAIN_TOL["median"] and mx < K2_PLAIN_TOL["max"],
                  f"K2 {label} disagrees with its plain version")
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
        from admmnet_tpu_torch.data.anchor import ANCHOR_F, ANCHOR_TAU
        from admmnet_tpu_torch.peaks import find_peaks, match_peaks
        from admmnet_tpu_torch.solver import admm_solve_fixed

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main_classical.main(["--deploy", "--json", "--device", "cuda"])
        cli = json.loads(buf.getvalue().strip().splitlines()[-1])
        log(f"[6 cli --deploy] fixed anchor: F1 {cli['f1']} (need 1.0), peaks "
            f"{[[round(v, 4) for v in r[:2]] for r in cli['peaks']]}")
        check(cli["f1"] == 1.0 and cli["converged"] is None, "CLI --deploy")

        y, b, s = (x[:512] for x in self.anchor)
        for label, iters, pcfg in (("deploy", DETECTION_BUDGET_ITERS, PRODUCTION_PEAKS),
                                   ("full", ITERS, PeakSearchConfig(max_peaks=8))):
            pk = find_peaks(admm_solve_fixed(y, b, s, iters, 1.0, self.prod), 10, 10, pcfg)
            tau, f = pk.tau.cpu().numpy(), pk.f.cpu().numpy()
            st = match_peaks(tau[:, :3], f[:, :3], np.broadcast_to(ANCHOR_TAU, (512, 3)),
                             np.broadcast_to(ANCHOR_F, (512, 3)), 0.05, 0.05)
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
        from admmnet_tpu_torch.peaks import find_peaks, match_peaks
        from admmnet_tpu_torch.solver import admm_solve_fixed

        with np.load(RANDOM_SCENES) as d:
            raw = {k: d[k] for k in d.files}
        y, b, s = to_dev(self.dev, raw["y"], raw["b"], raw["sigma"])
        f1 = {}
        for label, opts, iters, pcfg in (
            ("prod", self.prod, ITERS, PeakSearchConfig(max_peaks=8)),
            ("eigh", ADMMOptions(g_update="eigh"), ITERS, PeakSearchConfig(max_peaks=8)),
            ("deploy", self.prod, DETECTION_BUDGET_ITERS, PRODUCTION_PEAKS),
        ):
            t0 = time.time()
            pk = find_peaks(admm_solve_fixed(y, b, s, iters, 1.0, opts), 10, 10, pcfg)
            st = match_peaks(pk.tau.cpu().numpy()[:, :3], pk.f.cpu().numpy()[:, :3],
                             raw["tau"], raw["f"], 0.05, 0.05)
            f1[label] = st["f1"]
            log(f"[7 random {label}] {len(raw['y'])} scenes x {iters} iters: F1 "
                f"{st['f1']:.4f}, tau RMSE {st['tau_rmse']:.5f} [{time.time() - t0:.1f} s]")
        for label in ("prod", "deploy"):
            ok = f1[label] >= f1["eigh"] - F1_BAND
            log(f"[7 random gate {label}] F1 {f1[label]:.4f} >= eigh control "
                f"{f1['eigh']:.4f} - {F1_BAND}: {ok}")
            check(ok, f"random-scene gate ({label})")

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
        log(f"[9 time K2 fused_fast] B={B_TIME_K2} x {ITERS}: kernel {k2:.1f} ms "
            f"({n_ii / k2 * 1e3:.0f} inst-iter/s), plain {k2p:.1f} ms "
            f"({n_ii / k2p * 1e3:.0f} inst-iter/s) {tag}")
        self.kernels["K2"].update(ms=k2, plain_ms=k2p)

        M = random_hermitian(np.random.default_rng(1), B_TIME_K1, 101, self.dev)
        for mode in ("accurate", "fast"):
            k1 = cuda_ms(lambda: psd_project_polar_kernel(M, mode=mode), reps=3)
            k1p = cuda_ms(lambda: psd_project_polar_plain(M, mode=mode), reps=3)
            log(f"[9 time K1 {mode}] B={B_TIME_K1} m=101: kernel {k1:.2f} ms, "
                f"plain {k1p:.2f} ms per call {tag}")
            if mode == "accurate":
                self.kernels["K1"].update(ms=k1, plain_ms=k1p)

        def deploy():
            pk = find_peaks(admm_solve_fixed(y, b, s, DETECTION_BUDGET_ITERS, 1.0, self.prod),
                            10, 10, PRODUCTION_PEAKS)
            return pk.tau

        dms = cuda_ms(deploy, reps=2)
        log(f"[9 time deploy] B={B_TIME_K2}, {DETECTION_BUDGET_ITERS} iters + "
            f"PRODUCTION_PEAKS: {dms / B_TIME_K2:.5f} ms/scene "
            f"({B_TIME_K2 / dms * 1e3:.0f} scenes/s) {tag}")


def main() -> int:
    from admmnet_tpu_torch.kernels import fused_admm_fast, polar

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's smoke test needs one GPU")
    t_start = time.time()
    sm = Smoke()
    sm.device()
    sm.build()
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
    sm.timings()
    log(f"[done] {time.time() - t_start:.1f} s")

    meta = {
        "K1": ("polar_psd", "admmnet_tpu_torch/kernels/csrc/polar.cu",
               "admmnet_tpu/kernels/polar.py:154"),
        "K2": ("fused_admm_fast", "admmnet_tpu_torch/kernels/csrc/fused_admm_fast.cu",
               "admmnet_tpu/kernels/fused_admm_fast.py:575"),
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


if __name__ == "__main__":
    sys.exit(main())
