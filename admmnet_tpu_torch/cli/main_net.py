"""Net inference pipeline CLI on the port.

Loads a trained ``PhiEstADMMNet`` checkpoint (as the JAX package writes
it), runs phi inference on the anchor scenario, peak-searches, and prints
the top-L peaks.  Same flags and JSON as ``admmnet_tpu.cli.main_net``
(``--plot DIR`` needs matplotlib), plus ``--device`` (default ``cuda``, which raises
without a GPU; ``cpu`` runs the kernels' plain PyTorch versions).

Usage: python -m admmnet_tpu_torch.cli.main_net --ckpt runs/phi10 [--mode fixed_e]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from admmnet_tpu_torch.cli.main_classical import resolve_device


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt", required=True, help="checkpoint directory")
    p.add_argument("--mode", default="fixed_e", choices=["fresh", "redemod", "fixed_e"])
    p.add_argument("--num-layers", type=int, default=10)
    p.add_argument("--g-mode", default="eigh", choices=["eigh", "chebyshev"])
    p.add_argument("--head", default="attention", choices=["attention", "spectrum"],
                   help="e2e ADMMNet peak head variant")
    p.add_argument("--top", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--json", action="store_true")
    p.add_argument("--plot", default=None, help="directory for output figures")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda launches the CUDA kernels (raises without a GPU); "
                        "cpu runs their plain PyTorch versions")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)

    from admmnet_tpu_torch.cli.eval_net import load_model
    from admmnet_tpu_torch.core.config import ModelConfig, PeakSearchConfig, ProblemSpec
    from admmnet_tpu_torch.data.anchor import load_anchor
    from admmnet_tpu_torch.peaks import find_peaks, match_peaks

    sc = load_anchor(mode=args.mode, rng=np.random.default_rng(args.seed))
    spec = ProblemSpec(Nb=sc.Nb, Nd=sc.Nd, L_max=3)
    mcfg = ModelConfig(spec=spec, num_layers=args.num_layers, g_mode=args.g_mode,
                       head=args.head)
    model = load_model(args.ckpt, mcfg, False, dev)

    y = torch.from_numpy(np.asarray(sc.y, np.complex64)[None, :]).to(dev)
    b = torch.from_numpy(np.asarray(sc.b, np.complex64)[None, :]).to(dev)
    sigma = torch.tensor([sc.sigma], dtype=torch.float32, device=dev)
    pcfg = PeakSearchConfig()
    with torch.inference_mode():
        phi = model(y, b, sigma)
        peaks = find_peaks(phi, sc.Nb, sc.Nd, pcfg)
    tau, f, height, valid = (x.cpu().numpy()[0] for x in peaks)
    rows = [[float(tau[i]), float(f[i]), float(height[i])]
            for i in range(min(args.top, pcfg.max_peaks)) if bool(valid[i])]
    stats = match_peaks(
        np.asarray([r[0] for r in rows])[None, :],
        np.asarray([r[1] for r in rows])[None, :],
        sc.tau[None, :], sc.f[None, :], 0.05, 0.05,
    )

    if args.json:
        print(json.dumps({"peaks": rows, "f1": stats["f1"], "tau_rmse": stats["tau_rmse"],
                          "f_rmse": stats["f_rmse"], "device": str(dev)}))
    else:
        print(f"device: {dev}")
        print(f"net inference ({args.num_layers} layers) peaks [tau, f, height]:")
        for i, r in enumerate(rows):
            print(f"  {i + 1}. [{r[0]:.4f}, {r[1]:+.4f}, {r[2]:.2f}]")
        print(f"truth tau={sc.tau.tolist()} f={sc.f.tolist()}")
        print(f"F1={stats['f1']:.3f}")

    if args.plot:
        from pathlib import Path

        from admmnet_tpu_torch.utils.plotting import plot_peaks, plot_predictions_vs_truth

        d = Path(args.plot)
        d.mkdir(parents=True, exist_ok=True)
        plot_predictions_vs_truth(sc.f, sc.tau, rows, str(d / "net_pred_vs_truth.png"))
        plot_peaks(phi[0].cpu().numpy(), sc.Nb, sc.Nd, {"tau": sc.tau, "f": sc.f},
                   str(d / "net_peaks_surface.png"), title=f"Net-{args.num_layers}")
        print(f"plots written to {d}")


if __name__ == "__main__":
    main()
