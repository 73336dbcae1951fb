"""Classical end-to-end pipeline CLI on the port (reference main.py:8-137).

Builds the anchor scenario (data modes fresh/redemod/fixed_e), runs the
batched ADMM, peak-searches, and prints the top-L peaks sorted by height;
``--plot DIR`` writes the figures (matplotlib needed then only).

``--device cuda`` (the default) runs on the GPU and launches the CUDA
kernels; it raises when no GPU is available.  ``--device cpu`` is the
explicit route to the kernels' plain PyTorch versions.

Usage: python -m admmnet_tpu_torch.cli.main_classical [--mode fixed_e] [--deploy] [--plot out/]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--mode", default="fixed_e", choices=["fresh", "redemod", "fixed_e"])
    p.add_argument("--max-iter", type=int, default=100)
    p.add_argument("--eta", type=float, default=1e-7)
    p.add_argument("--rho", type=float, default=1.0)
    p.add_argument("--lambda-val", type=float, default=1.0)
    p.add_argument("--g-update", default="eigh",
                   choices=["eigh", "newton_schulz", "ref_identity"])
    p.add_argument("--phi-update", default="diag", choices=["diag", "ref_dense"])
    p.add_argument("--top", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--snr-w", type=float, default=20.0)
    p.add_argument("--json", action="store_true", help="machine-readable output")
    p.add_argument("--plot", default=None, help="directory for output figures")
    p.add_argument("--deploy", action="store_true",
                   help="gated deployment point: fused fixed-budget solve "
                        "(DETECTION_BUDGET_ITERS=10) + PRODUCTION_PEAKS; "
                        "overrides --max-iter/--eta/--g-update")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda launches the CUDA kernels (raises without a "
                        "GPU); cpu runs their plain PyTorch versions")
    return p


def resolve_device(name: str) -> torch.device:
    """The requested device; ``cuda`` without a GPU raises."""
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda requested but no CUDA device is available")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return torch.device(name)


def main(argv=None):
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)

    from admmnet_tpu_torch.core.config import (
        DETECTION_BUDGET_ITERS,
        PRODUCTION_PEAKS,
        ADMMOptions,
        PeakSearchConfig,
    )
    from admmnet_tpu_torch.data.anchor import load_anchor
    from admmnet_tpu_torch.peaks import find_peaks, match_peaks
    from admmnet_tpu_torch.solver import admm_solve, admm_solve_fixed

    sc = load_anchor(mode=args.mode, snr_w=args.snr_w,
                     rng=np.random.default_rng(args.seed))
    lam = args.lambda_val
    y = torch.from_numpy(np.asarray(sc.y, np.complex64)).to(dev)
    b = torch.from_numpy(np.asarray(sc.b, np.complex64)).to(dev)
    sigma = torch.tensor(np.float32(sc.sigma), device=dev)

    if args.deploy:
        opts = ADMMOptions(rho=args.rho, g_update="fused_fast",
                           phi_update=args.phi_update)
        pcfg = PRODUCTION_PEAKS
        budget = DETECTION_BUDGET_ITERS
        phi = admm_solve_fixed(y[None], b[None], sigma[None], budget, lam, opts)[0]
        # fixed-budget solve: there is no convergence measurement
        info = {"iterations": budget, "converged": None}
    else:
        opts = ADMMOptions(
            rho=args.rho, max_iter=args.max_iter, eta_abs=args.eta,
            eta_rel=args.eta, g_update=args.g_update,
            phi_update=args.phi_update,
        )
        pcfg = PeakSearchConfig()
        res = admm_solve(y, b, sigma, lam, opts)
        phi = res.phi
        info = {"iterations": int(res.iterations), "converged": bool(res.converged)}
    peaks = find_peaks(phi, sc.Nb, sc.Nd, pcfg)
    tau, f, height, valid = (x.cpu().numpy() for x in peaks)

    rows = [
        [float(tau[i]), float(f[i]), float(height[i])]
        for i in range(min(args.top, len(valid)))
        if bool(valid[i])
    ]
    stats = match_peaks(
        np.asarray([r[0] for r in rows])[None, :],
        np.asarray([r[1] for r in rows])[None, :],
        sc.tau[None, :], sc.f[None, :], 0.05, 0.05,
    )

    if args.json:
        print(json.dumps({
            "iterations": int(info["iterations"]),
            "converged": info["converged"],
            "sigma": sc.sigma,
            "ser": sc.ser,
            "peaks": rows,
            "f1": stats["f1"],
            "tau_rmse": stats["tau_rmse"],
            "f_rmse": stats["f_rmse"],
            "device": str(dev),
        }))
    else:
        print(f"device: {dev}")
        print(f"sigma: {sc.sigma:.4f}  SER: {sc.ser:.2f}%")
        conv = ("fixed budget (gated offline)" if info["converged"] is None
                else f"converged={info['converged']}")
        print(f"ADMM finished after {int(info['iterations'])} iterations ({conv})")
        print(f"top {len(rows)} peaks [tau, f, height]:")
        for i, r in enumerate(rows):
            print(f"  {i + 1}. [{r[0]:.4f}, {r[1]:+.4f}, {r[2]:.2f}]")
        print(f"truth tau={sc.tau.tolist()} f={sc.f.tolist()}")
        print(f"detection F1={stats['f1']:.3f} tau_rmse={stats['tau_rmse']:.4f} "
              f"f_rmse={stats['f_rmse']:.4f}")

    if args.plot:
        from pathlib import Path

        from admmnet_tpu_torch.utils.plotting import plot_peaks, plot_predictions_vs_truth

        d = Path(args.plot)
        d.mkdir(parents=True, exist_ok=True)
        plot_predictions_vs_truth(sc.f, sc.tau, rows, str(d / "pred_vs_truth.png"))
        plot_peaks(phi.cpu().numpy(), sc.Nb, sc.Nd, {"tau": sc.tau, "f": sc.f},
                   str(d / "peaks_surface.png"))
        print(f"plots written to {d}")


if __name__ == "__main__":
    main()
