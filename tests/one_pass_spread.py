"""The card measurements behind the one-pass tolerances of K2 and K3 in
tests/test_torch_cuda.py and chip_smoke.py (``K2_ONE_PASS``,
``K2_ONE_PASS_TOL``).

For each configuration of tests/test_torch_cuda.py that holds K2 or K3 to
its one-pass emulation (``one_pass=True``), prints the per-instance
relative error of phi, median and max over the 64 instances: the kernel
against the emulation; the emulation against itself with its products
summed in float64 instead of float32 (the same rounded operands, so only
the order and width of the sums differ: how far a correct kernel may sit);
and the kernel against the fp32 plain version (the tier's own distance).
Then the first low step at each side (one schedule step, two iterations),
which must sit within 1e-5 at the median.  Needs a CUDA device and no JAX.

Run from the repository root: python tests/one_pass_spread.py
"""

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from test_torch_cuda import _anchor_rows  # noqa: E402

from admmnet_tpu_torch.core.config import ADMMOptions  # noqa: E402
from admmnet_tpu_torch.kernels import fused_admm_fast as kf  # noqa: E402
from admmnet_tpu_torch.kernels import polar as kp  # noqa: E402
from admmnet_tpu_torch.ops.projections import POLAR_BF16_SCHED2  # noqa: E402
from admmnet_tpu_torch.solver.admm import fused_kernel_options  # noqa: E402


def rel(a, b):
    a, b = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
    return (torch.linalg.norm(a - b, dim=-1) / torch.linalg.norm(b, dim=-1)).cpu().numpy()


def stats(e):
    return f"median {np.median(e):.3e} max {e.max():.3e}"


def emulation_f64(*args, **kw):
    """The emulation with its one-pass products summed in float64."""
    mm = kp.mm

    def mm64(a, b, split, one_pass_round=None):
        if one_pass_round is None:
            return mm(a, b, split)
        return (one_pass_round(a).double() @ one_pass_round(b).double()).float()

    kp.mm = mm64
    try:
        return kf.admm_solve_fused_fast_plain(*args, one_pass=True, **kw)
    finally:
        kp.mm = mm


def main():
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.cuda.get_device_name(0), flush=True)
    prod = fused_kernel_options(ADMMOptions(g_update="fused_fast"))
    cases = [(f"production n={n}", n, 20, 1.0, 1.0, prod) for n in (100, 119)]
    for n in (10, 16, 111, 126):
        for fold in (True, False):
            cases.append((f"edges n={n} fold_diag={fold}", n, 20, 1.3, 0.8,
                          dict(hi_steps=1, outer_iters=4, inner_iters=3, final_hi=True,
                               layout="lean", fold_diag=fold, warm_root=True)))
    for n in (100, 119):
        for layout in ("lists", "lean"):
            cases.append((f"unfolded {layout} n={n}", n, 20, 1.7, 1.0,
                          dict(hi_steps=0, outer_iters=4, inner_iters=3,
                               schedule=POLAR_BF16_SCHED2, final_hi=False, layout=layout,
                               fold_diag=False)))
    for label, n, iters, rho, lam, kw in cases:
        rows = _anchor_rows(n, dev)
        pk = kf.admm_solve_fused_fast(*rows, iters, rho, lam, **kw)
        pe = kf.admm_solve_fused_fast_plain(*rows, iters, rho, lam, one_pass=True, **kw)
        p64 = emulation_f64(*rows, iters, rho, lam, **kw)
        p32 = kf.admm_solve_fused_fast_plain(*rows, iters, rho, lam, **kw)
        print(f"{label} x {iters}: kernel vs emulation {stats(rel(pk, pe))}; emulation "
              f"float32 vs float64 sums {stats(rel(pe, p64))}; kernel vs fp32 plain "
              f"{stats(rel(pk, p32))}", flush=True)
    first = dict(hi_steps=0, outer_iters=4, inner_iters=3, schedule=(POLAR_BF16_SCHED2[0],),
                 final_hi=False, layout="lean", fold_diag=False)
    for n in (10, 16, 100, 111, 119, 126):
        rows = _anchor_rows(n, dev)
        pk = kf.admm_solve_fused_fast(*rows, 2, **first)
        pe = kf.admm_solve_fused_fast_plain(*rows, 2, one_pass=True, **first)
        print(f"first low step n={n}: kernel vs emulation {stats(rel(pk, pe))}", flush=True)


if __name__ == "__main__":
    main()
