"""Dataset generation CLI on the port.

Same flags and on-disk layout as ``admmnet_tpu.cli.generate_dataset``
(``--stats-plot`` needs matplotlib), plus ``--device`` (default ``cuda``, which raises
without a GPU; ``cpu`` draws and labels on the CPU, where the fused solve
runs its plain PyTorch version).  The draws come from torch generators
seeded from ``--seed``, so the scenes differ from the JAX package's for the
same seed; their distributions are the same.

Usage:
  python -m admmnet_tpu_torch.cli.generate_dataset --out data/fix20 --fixed-snr 20
  python -m admmnet_tpu_torch.cli.generate_dataset --out data/phi5k --total 5000 --with-phi
"""

from __future__ import annotations

import argparse

from admmnet_tpu_torch.cli.main_classical import resolve_device


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--total", type=int, default=10000)
    p.add_argument("--Nb", type=int, default=10)
    p.add_argument("--Nd", type=int, default=10)
    p.add_argument("--L-max", type=int, default=3)
    p.add_argument("--snr-min", type=float, default=5.0)
    p.add_argument("--snr-max", type=float, default=25.0)
    p.add_argument("--fixed-snr", type=float, default=None,
                   help="use a single SNR (fixSNR20L3 style)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--with-phi", action="store_true",
                   help="label with classical-solver phi (batched)")
    p.add_argument("--phi-iters", type=int, default=100)
    p.add_argument("--phi-g-update", default="fused_exact",
                   help="PSD step of the labeller (fused_exact|polar|newton_schulz|eigh)")
    p.add_argument("--stats-plot", action="store_true",
                   help="write dataset_statistics.png (reference visualize_dataset_stats)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda generates and labels on the GPU (raises without one)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)

    from admmnet_tpu_torch.core.config import ADMMOptions, DataConfig, ProblemSpec
    from admmnet_tpu_torch.data.generator import DatasetGenerator

    snr = ((args.fixed_snr, args.fixed_snr) if args.fixed_snr is not None
           else (args.snr_min, args.snr_max))
    cfg = DataConfig(spec=ProblemSpec(Nb=args.Nb, Nd=args.Nd, L_max=args.L_max),
                     snr_range=snr)
    gen = DatasetGenerator(cfg, data_dir=args.out)
    gen.generate_complete_dataset(
        total_samples=args.total, seed=args.seed, with_phi=args.with_phi,
        phi_iters=args.phi_iters, phi_opts=ADMMOptions(g_update=args.phi_g_update),
        device=dev, log=lambda msg: print(msg, flush=True))
    if args.stats_plot:
        from pathlib import Path

        from admmnet_tpu_torch.utils.plotting import plot_dataset_statistics

        p = plot_dataset_statistics(gen.load_split("train"),
                                    str(Path(args.out) / "dataset_statistics.png"))
        print(f"stats figure: {p}")
    print(f"dataset written to {args.out}")


if __name__ == "__main__":
    main()
