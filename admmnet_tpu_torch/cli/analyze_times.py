"""Timing-results analysis CLI (reference results/plot_compute_time.py);
the port's copy of ``admmnet_tpu.cli.analyze_times`` (numpy only).

Loads the per-solve timing text files written by cli.bench_time, prints
mean/std/median/min/max and pairwise speedups, and renders the comparison
figures (bar, distribution CDF) with ``--plot``, which needs matplotlib
(imported only then).

Usage:
  python -m admmnet_tpu_torch.cli.analyze_times results/time/time.txt \
      results/time/time_net.txt --labels "ADMM" "Net-10" --plot results/fig
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("files", nargs="+", help="timing .txt files (s per solve)")
    p.add_argument("--labels", nargs="*", default=None)
    p.add_argument("--plot", default=None, help="output directory for figures")
    return p


def analyze(files, labels=None):
    labels = labels or [Path(f).stem for f in files]
    rows = []
    for f, lab in zip(files, labels):
        t = np.loadtxt(f)
        rows.append(
            {
                "label": lab,
                "n": int(t.size),
                "mean": float(t.mean()),
                "std": float(t.std()),
                "median": float(np.median(t)),
                "min": float(t.min()),
                "max": float(t.max()),
                "times": t,
            }
        )
    return rows


def main(argv=None):
    args = build_parser().parse_args(argv)
    rows = analyze(args.files, args.labels)

    print(f"{'label':<16}{'n':>6}{'mean(s)':>12}{'std':>12}{'median':>12}"
          f"{'min':>12}{'max':>12}")
    for r in rows:
        print(f"{r['label']:<16}{r['n']:>6}{r['mean']:>12.6f}{r['std']:>12.6f}"
              f"{r['median']:>12.6f}{r['min']:>12.6f}{r['max']:>12.6f}")
    if len(rows) > 1:
        base = rows[0]
        for r in rows[1:]:
            print(f"speedup {base['label']} / {r['label']}: "
                  f"{base['mean'] / r['mean']:.2f}x (mean), "
                  f"{base['median'] / r['median']:.2f}x (median)")

    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        d = Path(args.plot)
        d.mkdir(parents=True, exist_ok=True)

        fig, ax = plt.subplots(figsize=(7, 5))
        ax.bar([r["label"] for r in rows], [r["mean"] for r in rows],
               yerr=[r["std"] for r in rows], capsize=4)
        ax.set_ylabel("seconds per solve")
        ax.set_title("Mean compute time")
        fig.tight_layout()
        fig.savefig(d / "mean_times.png")
        plt.close(fig)

        fig, ax = plt.subplots(figsize=(7, 5))
        for r in rows:
            t = np.sort(r["times"])
            ax.plot(t, np.linspace(0, 1, t.size), label=r["label"])
        ax.set_xlabel("seconds per solve")
        ax.set_ylabel("CDF")
        ax.legend()
        ax.set_title("Compute-time distribution")
        fig.tight_layout()
        fig.savefig(d / "time_cdf.png")
        plt.close(fig)
        print(f"figures written to {d}")


if __name__ == "__main__":
    main()
