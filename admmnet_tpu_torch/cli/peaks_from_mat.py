"""MATLAB cross-validation CLI on the port (reference test_peaksearch.py:1-43).

Loads a phi vector exported from the original MATLAB implementation
(.mat, variable ``phi_ad`` by default; the reference expects
data/mat/phi_ad.mat, which is not bundled upstream either), peak-searches
it with the batched pipeline and prints the peaks sorted by height.  Same
flags as ``admmnet_tpu.cli.peaks_from_mat`` plus ``--device`` (default
``cuda``, which raises without a GPU).

Usage: python -m admmnet_tpu_torch.cli.peaks_from_mat data/mat/phi_ad.mat
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from admmnet_tpu_torch.cli.main_classical import resolve_device


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("mat_file")
    p.add_argument("--var", default="phi_ad", help=".mat variable name")
    p.add_argument("--Nb", type=int, default=10)
    p.add_argument("--Nd", type=int, default=10)
    p.add_argument("--top", type=int, default=10)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    import scipy.io as sio

    from admmnet_tpu_torch.core.config import PeakSearchConfig
    from admmnet_tpu_torch.peaks import find_peaks

    mat = sio.loadmat(args.mat_file)
    if args.var not in mat:
        raise SystemExit(f"variable {args.var!r} not in {args.mat_file}; has "
                         f"{[k for k in mat if not k.startswith('__')]}")
    phi = np.asarray(mat[args.var]).reshape(-1).astype(np.complex64)
    tau, f, height, valid = (x.cpu().numpy() for x in find_peaks(
        torch.from_numpy(phi).to(dev), args.Nb, args.Nd, PeakSearchConfig()))
    print(f"found peaks (top {args.top}) [tau, f, height]:")
    shown = 0
    for i in range(tau.shape[-1]):
        if not bool(valid[i]) or shown >= args.top:
            break
        print(f"  {shown + 1}. [{float(tau[i]):.4f}, {float(f[i]):+.4f}, {float(height[i]):.3f}]")
        shown += 1


if __name__ == "__main__":
    main()
