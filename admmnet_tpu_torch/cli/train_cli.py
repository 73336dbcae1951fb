"""Training CLI on the port.

Same flags, ``config.json`` and run directory as
``admmnet_tpu.cli.train_cli``, plus ``--device`` (default ``cuda``, which
raises without a GPU; ``cpu`` runs the kernels' plain PyTorch versions).
The checkpoint it writes is read by the port's and by the JAX package's
``restore_checkpoint``.

Usage:
  python -m admmnet_tpu_torch.cli.train_cli --data data/fix20 --workdir runs/x
  python -m admmnet_tpu_torch.cli.train_cli --data data/phi5k --workdir runs/phi --phi
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from admmnet_tpu_torch.cli.main_classical import resolve_device


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", required=True, help="dataset dir (generate_dataset)")
    p.add_argument("--workdir", required=True)
    p.add_argument("--phi", action="store_true", help="train PhiEstADMMNet")
    p.add_argument("--num-layers", type=int, default=10)
    p.add_argument("--cheb-impl", default="xla", choices=["xla", "pallas"],
                   help="Clenshaw engine for g_mode=chebyshev: torch ops (xla) or the "
                        "CUDA kernels K5/K6 (pallas)")
    p.add_argument("--g-mode", default="eigh", choices=["eigh", "chebyshev"],
                   help="GLayer spectral-filter evaluation")
    p.add_argument("--head", default="attention", choices=["attention", "spectrum"],
                   help="e2e peak head: attention or spectrum (differentiable spectral "
                        "search)")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--patience", type=int, default=10,
                   help="early-stop patience; set large to run through SGDR restarts")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--lr", type=float, default=None, help="default 1e-3 (e2e) / 5e-3 (phi)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--assignment", default="slot", choices=["slot", "perm"],
                   help="e2e loss target assignment (perm = set matching)")
    p.add_argument("--spectral-weight", type=float, default=None,
                   help="spectral contrast loss weight (default 0.5 with --head "
                        "spectrum, else 0)")
    p.add_argument("--init-from", default=None,
                   help="warm-start matching submodules (e.g. the trunk) from this "
                        "checkpoint dir (e2e mode only)")
    p.add_argument("--learned-sensing", action="store_true",
                   help="enable the trainable measurement/calibration matrix")
    p.add_argument("--reset-best", action="store_true",
                   help="on resume, forget the checkpoint's best val loss (curriculum "
                        "stage switch)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda trains on the GPU (raises without one)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)

    from admmnet_tpu_torch.core.config import ModelConfig, ProblemSpec, TrainConfig, to_json
    from admmnet_tpu_torch.data.generator import DatasetGenerator
    from admmnet_tpu_torch.train.trainer import train_admmnet, train_phinet

    gen = DatasetGenerator(data_dir=args.data)
    info = gen.dataset_config()
    spec = ProblemSpec(Nb=info["Nb"], Nd=info["Nd"], L_max=info["L_max"])
    train, val, test = (gen.load_split(s) for s in ("train", "val", "test"))

    mcfg = ModelConfig(spec=spec, num_layers=args.num_layers, g_mode=args.g_mode,
                       head=args.head, cheb_impl=args.cheb_impl,
                       learned_sensing=args.learned_sensing)
    lr = args.lr if args.lr is not None else (5e-3 if args.phi else 1e-3)
    sw = args.spectral_weight
    if sw is None:
        sw = 0.5 if args.head == "spectrum" else 0.0
    tcfg = TrainConfig(batch_size=args.batch_size, epochs=args.epochs, lr=lr, seed=args.seed,
                       assignment=args.assignment, spectral_weight=sw,
                       patience=args.patience, reset_best=args.reset_best)
    Path(args.workdir).mkdir(parents=True, exist_ok=True)
    (Path(args.workdir) / "config.json").write_text(json.dumps(
        {"model": json.loads(to_json(mcfg)), "train": json.loads(to_json(tcfg))}, indent=2))

    def log(msg):
        print(msg, flush=True)

    if args.phi:
        res = train_phinet(mcfg, tcfg, train, val, test, workdir=args.workdir, log_fn=log,
                           device=dev)
    else:
        res = train_admmnet(mcfg, tcfg, train, val, test, workdir=args.workdir, log_fn=log,
                            init_from=args.init_from, device=dev)
    print(f"best val loss {res.best_val_loss:.6f} after {res.epochs_run} epochs")
    if res.test_metrics:
        print("test:", json.dumps(res.test_metrics, indent=2))


if __name__ == "__main__":
    main()
