"""Model-quality evaluation CLI on the port.

Runs a trained net on the test split of a dataset directory.  Without
``--e2e``: a ``PhiEstADMMNet``; peak-searches both the model phi and the
dataset's classical phi labels, and reports side-by-side detection metrics
plus the phi alignment loss.  With ``--e2e``: a full ``ADMMNet``, whose
(tau, f, conf) predictions are scored by position-matched F1
(``evaluate_e2e``).  Same flags and JSON as ``admmnet_tpu.cli.eval_net``,
plus ``--device`` (default ``cuda``, which raises without a GPU; ``cpu``
runs the kernels' plain PyTorch versions).

The test split is evaluated as one batch: the net's ZLayer couples the
instances of a batch through the mean residual norm.

Usage: python -m admmnet_tpu_torch.cli.eval_net --data DIR --ckpt runs/phi10
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from admmnet_tpu_torch.cli.main_classical import resolve_device


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", required=True, help="dataset dir with phi labels")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--num-layers", type=int, default=10)
    p.add_argument("--g-mode", default="eigh", choices=["eigh", "chebyshev"])
    p.add_argument("--cheb-degree", type=int, default=48)
    p.add_argument("--cheb-precision", default="highest", choices=["highest", "default"],
                   help="Clenshaw re-projection: default re-projects every step")
    p.add_argument("--cheb-impl", default="xla", choices=["xla", "pallas"],
                   help="Clenshaw engine: torch ops (xla) or the CUDA kernel (pallas)")
    p.add_argument("--head", default="attention", choices=["attention", "spectrum"],
                   help="e2e ADMMNet peak head variant")
    p.add_argument("--limit", type=int, default=256, help="max test samples")
    p.add_argument("--tol", type=float, default=0.05, help="match tolerance")
    p.add_argument("--e2e", action="store_true",
                   help="checkpoint is a full ADMMNet (peak head): score its direct "
                        "(tau, f, conf) predictions with position-matched F1 instead "
                        "of phi peak search")
    p.add_argument("--conf-threshold", type=float, default=0.5)
    p.add_argument("--learned-sensing", action="store_true",
                   help="checkpoint has the trainable sensing matrix")
    p.add_argument("--json", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda launches the CUDA kernels (raises without a GPU); "
                        "cpu runs their plain PyTorch versions")
    return p


def load_model(ckpt_dir, cfg, e2e: bool, device) -> torch.nn.Module:
    """An ``ADMMNet`` (``e2e``) or ``PhiEstADMMNet`` with the weights of a
    checkpoint the JAX package wrote, on ``device``, in eval mode."""
    from admmnet_tpu_torch.core.convert import params_from_jax
    from admmnet_tpu_torch.models import ADMMNet, PhiEstADMMNet
    from admmnet_tpu_torch.train.checkpoint import restore_checkpoint

    restored = restore_checkpoint(ckpt_dir)
    if restored is None:
        raise SystemExit(f"no checkpoint under {ckpt_dir}")
    model = (ADMMNet if e2e else PhiEstADMMNet)(cfg)
    model.load_state_dict(params_from_jax(restored[0]["params"]["params"], cfg))
    return model.to(device).eval()


def evaluate_e2e(model, y, b, sigma, true_tau, true_f, tol: float = 0.05,
                 conf_threshold: float = 0.5):
    """Position-matched detection metrics of an end-to-end ADMMNet.

    ``y``, ``b``, ``sigma``: the scenes as tensors on the model's device,
    evaluated as ONE batch -- the ZLayer divides each residual norm by the
    batch mean, so a chunked evaluation gives other outputs; compare with
    the JAX package or a golden only on the same batch.  ``true_tau``,
    ``true_f``: (B, L) numpy.  Predictions are sorted by confidence,
    descending, and those with conf > ``conf_threshold`` are matched at
    ``tol``.  Returns (``match_peaks`` stats, dict of the sorted numpy
    ``tau``, ``f``, ``conf`` and the trunk's ``phi``).
    """
    from admmnet_tpu_torch.peaks import match_peaks

    with torch.inference_mode():
        tau, f, conf, phi = (x.cpu().numpy() for x in model(y, b, sigma))
    order = np.argsort(-conf, axis=-1)
    rows = np.arange(tau.shape[0])[:, None]
    tau, f, conf = tau[rows, order], f[rows, order], conf[rows, order]
    stats = match_peaks(tau, f, true_tau, true_f, tol, tol, pred_valid=conf > conf_threshold)
    return stats, {"tau": tau, "f": f, "conf": conf, "phi": phi}


def main(argv=None):
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)

    from admmnet_tpu_torch.core.config import ModelConfig, PeakSearchConfig, ProblemSpec
    from admmnet_tpu_torch.data.generator import DatasetGenerator
    from admmnet_tpu_torch.peaks import find_peaks, match_peaks, scale_invariant_nmse
    from admmnet_tpu_torch.train.losses import phi_alignment_loss

    gen = DatasetGenerator(data_dir=args.data)
    info = gen.dataset_config()
    spec = ProblemSpec(Nb=info["Nb"], Nd=info["Nd"], L_max=info["L_max"])
    test = gen.load_split("test")
    if not args.e2e and "phi" not in test:
        raise SystemExit("dataset has no phi labels; regenerate with --with-phi")
    n = min(args.limit, test["y"].shape[0])
    test = {k: v[:n] for k, v in test.items()}
    y, b = (torch.from_numpy(np.asarray(test[k], np.complex64)).to(dev) for k in ("y", "b"))
    sigma = torch.from_numpy(np.asarray(test["sigma"], np.float32)).to(dev)
    mcfg = ModelConfig(spec=spec, num_layers=args.num_layers, g_mode=args.g_mode,
                       head=args.head, cheb_degree=args.cheb_degree,
                       cheb_precision=args.cheb_precision, cheb_impl=args.cheb_impl,
                       learned_sensing=args.learned_sensing)
    model = load_model(args.ckpt, mcfg, args.e2e, dev)
    keys = ("f1", "precision", "recall", "tau_rmse", "f_rmse")

    if args.e2e:
        stats, _ = evaluate_e2e(model, y, b, sigma, test["tau"], test["f"], args.tol,
                                args.conf_threshold)
        out = {"samples": n, "mode": "e2e", "conf_threshold": args.conf_threshold,
               "detection": {k: stats[k] for k in keys}, "device": str(dev)}
    else:
        pcfg = PeakSearchConfig(max_peaks=8)
        phi_true = torch.from_numpy(np.asarray(test["phi"], np.complex64)).to(dev)
        with torch.inference_mode():
            phi_net = model(y, b, sigma)
            loss, parts = phi_alignment_loss(phi_net, phi_true)
            pk_net = find_peaks(phi_net, spec.Nb, spec.Nd, pcfg)
            pk_cls = find_peaks(phi_true, spec.Nb, spec.Nd, pcfg)
        L = spec.L_max
        stats = {}
        for name, pk in (("net", pk_net), ("classical", pk_cls)):
            tau, f, valid = (x.cpu().numpy()[:, :L] for x in (pk.tau, pk.f, pk.valid))
            st = match_peaks(tau, f, test["tau"], test["f"], args.tol, args.tol,
                             pred_valid=valid)
            stats[name] = {k: st[k] for k in keys}
        out = {
            "samples": n,
            "phi_alignment_loss": float(loss),
            "amplitude_loss": float(parts["amplitude_loss"]),
            "phase_loss": float(parts["phase_loss"]),
            "phi_scale_invariant_nmse": scale_invariant_nmse(phi_net.cpu().numpy(), test["phi"]),
            "net_detection": stats["net"],
            "classical_detection": stats["classical"],
            "device": str(dev),
        }
    print(json.dumps(out) if args.json else json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
