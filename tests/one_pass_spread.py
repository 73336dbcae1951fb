"""The card measurements behind the one-pass tolerances of K2 and K3
(``K2_ONE_PASS``) and of the Clenshaw kernels' tiers (``K4_ONE_PASS``,
``K4_SPIKED_SPREAD``, ``K6_TOL``) in tests/card_checks.py, which the card
tests and chip_smoke.py hold the kernels to.

For each configuration of tests/test_torch_cuda.py that holds K2 or K3 to
its one-pass emulation (``one_pass=True``), prints the per-instance
relative error of phi, median and max over the 64 instances: the kernel
against the emulation; the emulation against itself with its products
summed in float64 instead of float32 (the same rounded operands, so only
the order and width of the sums differ: how far a correct kernel may sit);
and the kernel against the fp32 plain version (the tier's own distance).
Then the first low step at each side (one schedule step, two iterations),
which must sit within 1e-5 at the median.

For the Clenshaw kernels (``--cheb`` runs only these): K4 (and K5's
carries) against its emulation (``one_pass=True``), with and without
``final_hi``, at the GLayer's side and at the edge sides of
tests/test_torch_cuda.py, beside the emulation's float32-vs-float64
spread and the fp32 tier's distance; the first real product (degree 3);
K6 at both plane sides against its rounded split emulation
(``three_pass=True, one_pass=True``) and, with ``three_pass=False``,
against the fp32 plain version.  Needs a CUDA device and no JAX.

Run from the repository root: python tests/one_pass_spread.py [--cheb]
"""

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from test_torch_cuda import _anchor_rows, sums_in_float64  # noqa: E402

from admmnet_tpu_torch.core.config import ADMMOptions  # noqa: E402
from admmnet_tpu_torch.kernels import cheb_filter as kc  # noqa: E402
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
    return sums_in_float64(kf.admm_solve_fused_fast_plain, *args, one_pass=True, **kw)


def cheb_inputs(dev, B, m, degree, seed):
    """chip_smoke.py's cheb_inputs: random Hermitian matrices, the second
    half with a dominant eigenvalue, the last one zero (left out of the
    statistics), coefficients and a cotangent."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(B, m, m)) + 1j * rng.normal(size=(B, m, m))
    M = (X + X.conj().transpose(0, 2, 1)) / 2
    v = rng.normal(size=(B // 2, m)) + 1j * rng.normal(size=(B // 2, m))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    M[B // 2:] += 300.0 * v[:, :, None] * v.conj()[:, None, :]
    M[-1] = 0
    c = rng.normal(size=(B, degree)) * 0.3
    Y = rng.normal(size=(B, m, m)) + 1j * rng.normal(size=(B, m, m))
    return (torch.from_numpy(M.astype(np.complex64)).to(dev),
            torch.from_numpy(c.astype(np.float32)).to(dev),
            torch.from_numpy(Y.astype(np.complex64)).to(dev))


def cheb(dev):
    """The Clenshaw kernels against their emulations (module docstring)."""
    cases = [(64, 101, 48, 4), (16, 120, 48, 6)] + [(8, m, 48, 148) for m in (10, 16, 111, 126)]
    for B, m, D, seed in cases:
        M, c, _ = cheb_inputs(dev, B, m, D, seed)
        for final_hi in (False, True):
            Gr, Gi, car = kc.cheb_filter_planes(M, c, D, final_hi, carries=True)
            G = torch.complex(Gr[:, :m, :m], Gi[:, :m, :m])
            ge, ce = kc.cheb_filter_matrices_plain_with_residuals(M, c, D, True, final_hi)
            g64, c64 = sums_in_float64(kc.cheb_filter_matrices_plain_with_residuals, M, c, D,
                                       True, final_hi)
            g32 = kc.cheb_filter_matrices_plain(M, c, D)
            ek = max(float(rel(k[:-1, :m, :m], e[:-1]).max()) for k, e in zip(car, ce))
            es = max(float(rel(e[:-1], e6[:-1]).max()) for e, e6 in zip(ce, c64))
            print(f"K4 m={m} B={B} degree {D} final_hi={final_hi}: kernel vs emulation "
                  f"{stats(rel(G[:-1], ge[:-1]))}; emulation float32 vs float64 sums "
                  f"{stats(rel(ge[:-1], g64[:-1]))}; kernel vs fp32 plain "
                  f"{stats(rel(G[:-1], g32[:-1]))}; K5 carries vs emulation max {ek:.3e} "
                  f"(spread {es:.3e}); zero matrix bitwise: "
                  f"{bool(torch.equal(G[-1], ge[-1]))}", flush=True)
        M3, c3, _ = cheb_inputs(dev, B, m, 3, seed + 1)
        for final_hi in (False, True):
            G3 = kc.cheb_filter_matrices(M3, c3, 3, final_hi)
            e3 = kc.cheb_filter_matrices_plain(M3, c3, 3, True, final_hi)
            print(f"K4 first real product m={m} final_hi={final_hi}: kernel vs emulation "
                  f"{stats(rel(G3[:-1], e3[:-1]))}", flush=True)
        if m not in (101, 120):
            continue
        M, c, Y = cheb_inputs(dev, B, m, D, seed)
        _, _, car = kc.cheb_filter_planes(M, c, D, carries=True)
        crop = [x[:, :m, :m] for x in car]
        for tp in (True, False):
            Ab, cb = kc.cheb_bwd(M, c, car, Y, D, tp)
            Mb = kc.normalization_backward(M, Ab)
            ref = [kc.cheb_bwd_plain(M, c, crop, Y, D, tp, tp)]
            if tp:
                ref.append(sums_in_float64(kc.cheb_bwd_plain, M, c, crop, Y, D, True, True))
                ref.append(kc.cheb_bwd_plain(M, c, crop, Y, D, True))
            ref.append(kc.cheb_bwd_plain(M, c, crop, Y, D))
            Mr = [kc.normalization_backward(M, a) for a, _ in ref]
            line = (f"K6 m={m} B={B} three_pass={tp}: kernel vs "
                    f"{'rounded split emulation' if tp else 'fp32 plain'} Mbar "
                    f"{stats(rel(Mb[:-1], Mr[0][:-1]))} cbar {stats(rel(cb, ref[0][1]))}")
            if tp:
                line += (f"; emulation float32 vs float64 sums Mbar "
                         f"{stats(rel(Mr[0][:-1], Mr[1][:-1]))}; kernel vs fp32-residual "
                         f"split Mbar {stats(rel(Mb[:-1], Mr[2][:-1]))}; kernel vs fp32 plain "
                         f"Mbar {stats(rel(Mb[:-1], Mr[3][:-1]))} cbar "
                         f"{stats(rel(cb, ref[3][1]))}")
            print(line, flush=True)


def main():
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.cuda.get_device_name(0), flush=True)
    cheb(dev)
    if "--cheb" in sys.argv[1:]:
        return
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
