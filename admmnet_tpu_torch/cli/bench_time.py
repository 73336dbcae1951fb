"""Timing-benchmark CLI on the port (reference test/test_time_admm.py +
test_time_net.py).

Same protocol, flags and report as ``admmnet_tpu.cli.bench_time``: the
anchor scenario (``make_anchor_batch(runs, mode="redemod", seed=0)``), one
warm call, then the timed work, each call ending in a host read
(``float(...)``).  Batched (the default), all runs are one call and the
per-solve time is total / runs (amortized; ``--repeat R`` times R such
calls, prints each, and takes their mean); ``--sequential`` times one
solve at a time (latency).  The scenes are moved to the device before
timing.  A fresh net gets the port's seeded initializers (seed 0);
``--ckpt`` loads a checkpoint the JAX package or the port wrote.

``--device cuda`` (the default) runs on the GPU and launches the CUDA
kernels; it raises when no GPU is available.  ``--device cpu`` runs their
plain PyTorch versions.

Usage:
  python -m admmnet_tpu_torch.cli.bench_time --what admm --g-update fused_fast --runs 1000
  python -m admmnet_tpu_torch.cli.bench_time --what admm --g-update fused_fast --runs 8192 \\
      --repeat 3
  python -m admmnet_tpu_torch.cli.bench_time --what admm --g-update fused_fast \\
      --fused-layout lists --runs 8192 --repeat 3
  python -m admmnet_tpu_torch.cli.bench_time --what e2e --ckpt runs/train_net3_r05 \\
      --layers 3 --g-mode chebyshev --cheb-impl pallas
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from admmnet_tpu_torch.cli.main_classical import resolve_device


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--what", choices=["admm", "net", "e2e"], default="admm",
                   help="admm: classical solver; net: PhiEstADMMNet trunk forward; "
                        "e2e: full ADMMNet observation -> (tau, f, conf) peak list")
    p.add_argument("--runs", type=int, default=1000)
    p.add_argument("--iters", type=int, default=100, help="ADMM iterations")
    p.add_argument("--layers", type=int, default=10, help="net depth")
    p.add_argument("--g-update", default="newton_schulz")
    p.add_argument("--fused-layout", default=None, choices=["lean", "lists"],
                   help="the fused solve's escape hatch (the port's own flag): the lean "
                        "layout's unfolded carry or the lists layout (K3), with the lean-only "
                        "defaults off and a 4/3 cold root")
    p.add_argument("--g-mode", default="eigh", choices=["eigh", "chebyshev"],
                   help="net GLayer mode (--what net / e2e)")
    p.add_argument("--cheb-degree", type=int, default=48)
    p.add_argument("--cheb-precision", default="highest", choices=["highest", "default"])
    p.add_argument("--cheb-impl", default="xla", choices=["xla", "pallas"],
                   help="Clenshaw engine: xla (plain torch) or the Clenshaw kernel")
    p.add_argument("--head", default="spectrum", choices=["attention", "spectrum"],
                   help="peak head (--what e2e)")
    p.add_argument("--ckpt", default=None, help="net checkpoint (else fresh init)")
    p.add_argument("--sequential", action="store_true",
                   help="time one solve at a time (latency, not throughput)")
    p.add_argument("--adaptive", action="store_true",
                   help="--what admm: the adaptive early-exit solve (admm_solve, "
                        "per-instance converged mask) with its iterations-to-"
                        "convergence histogram")
    p.add_argument("--eta", type=float, default=1e-7,
                   help="eta_abs = eta_rel for --adaptive (reference 1e-7)")
    p.add_argument("--repeat", type=int, default=1,
                   help="batched: timed calls after the warm call (each ends in a "
                        "host read); the per-solve time is their mean / runs")
    p.add_argument("--out", default=None, help="output txt (one time per row)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda launches the CUDA kernels (raises without a GPU); "
                        "cpu runs their plain PyTorch versions")
    return p


def _solver_fn(args):
    """(fn(y, b, sigma) -> scalar tensor, label) of the classical solver."""
    from admmnet_tpu_torch.core.config import ADMMOptions
    from admmnet_tpu_torch.solver import admm_solve, admm_solve_fixed

    if args.adaptive:
        opts = ADMMOptions(g_update=args.g_update, max_iter=args.iters,
                           eta_abs=args.eta, eta_rel=args.eta)

        def fn(y, b, s):
            res = admm_solve(y, b, s, 1.0, opts)
            fn.last_iters = res.iterations.cpu().numpy()
            fn.last_converged = res.converged.cpu().numpy()
            return torch.sum(torch.abs(res.phi))

        fn.last_iters = None
        return fn, (f"classical ADMM adaptive (eta={args.eta:g}, max {args.iters}, "
                    f"{args.g_update})")
    opts = ADMMOptions(g_update=args.g_update)
    label = args.g_update
    if args.fused_layout is not None:
        opts = ADMMOptions(g_update=args.g_update, fused_layout=args.fused_layout,
                           fused_fold_diag=False, fused_warm_root=False, fused_proj_iters=4,
                           fused_inner_iters=3)
        label += f", {args.fused_layout} layout, unfolded, 4/3 cold root"

    def fn(y, b, s):
        return torch.sum(torch.abs(admm_solve_fixed(y, b, s, args.iters, 1.0, opts)))

    return fn, f"classical ADMM ({args.iters} iters, {label})"


def _net_fn(args, dev):
    """(fn(y, b, sigma) -> scalar tensor, label) of the net forward."""
    from admmnet_tpu_torch.core.config import ModelConfig, ProblemSpec
    from admmnet_tpu_torch.core.convert import params_from_jax
    from admmnet_tpu_torch.models import ADMMNet, PhiEstADMMNet
    from admmnet_tpu_torch.train.checkpoint import restore_checkpoint
    from admmnet_tpu_torch.train.trainer import init_model

    e2e = args.what == "e2e"
    mcfg = ModelConfig(spec=ProblemSpec(), num_layers=args.layers, g_mode=args.g_mode,
                       head=args.head, cheb_degree=args.cheb_degree,
                       cheb_precision=args.cheb_precision, cheb_impl=args.cheb_impl)
    model = init_model(ADMMNet if e2e else PhiEstADMMNet, mcfg, 0, dev)
    if args.ckpt:
        restored = restore_checkpoint(args.ckpt)
        if restored is not None:
            model.load_state_dict(params_from_jax(restored[0]["params"]["params"], mcfg))
    model.eval()

    def fn(y, b, s):
        with torch.inference_mode():
            if e2e:  # full pipeline: touch every output
                tau, f, conf, _phi = model(y, b, s)
                return torch.sum(tau) + torch.sum(f) + torch.sum(conf)
            return torch.sum(torch.abs(model(y, b, s)))

    if e2e:
        return fn, f"ADMM-Net e2e detection ({args.layers} layers, {args.head} head)"
    return fn, f"ADMM-Net forward ({args.layers} layers)"


def main(argv=None):
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)

    from admmnet_tpu_torch.data.anchor import make_anchor_batch

    y, b, sigma = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                   for a in make_anchor_batch(args.runs, mode="redemod", seed=0))
    fn, label = _solver_fn(args) if args.what == "admm" else _net_fn(args, dev)

    if args.sequential:
        float(fn(y[:1], b[:1], sigma[:1]))  # warm
        times = []
        for i in range(args.runs):
            t0 = time.perf_counter()
            float(fn(y[i:i + 1], b[i:i + 1], sigma[i:i + 1]))
            times.append(time.perf_counter() - t0)
        times = np.asarray(times)
    else:
        float(fn(y, b, sigma))  # warm
        totals = []
        for _ in range(args.repeat):
            t0 = time.perf_counter()
            float(fn(y, b, sigma))
            totals.append(time.perf_counter() - t0)
        times = np.full(args.runs, np.mean(totals) / args.runs)

    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {dev} ({name})")
    print(f"{label}: mean {times.mean():.6f}s  std {times.std():.6f}s  "
          f"median {np.median(times):.6f}s  min {times.min():.6f}s  "
          f"max {times.max():.6f}s per solve "
          f"({'sequential' if args.sequential else f'batched x{args.runs}'})")
    if not args.sequential and args.repeat > 1:
        print("timed calls: " + " ".join(f"{t:.6f}s" for t in totals))
    if args.adaptive and getattr(fn, "last_iters", None) is not None:
        it = fn.last_iters.ravel()
        conv = fn.last_converged.ravel()
        q = np.percentile(it, [50, 90, 95, 99])
        uniq, cnt = np.unique(it, return_counts=True)
        print(f"iterations-to-convergence: mean {it.mean():.2f}  "
              f"median {q[0]:.0f}  p90 {q[1]:.0f}  p95 {q[2]:.0f}  "
              f"p99 {q[3]:.0f}  max {it.max()}  "
              f"converged {conv.mean() * 100:.1f}%")
        print("iteration histogram: " + " ".join(f"{u}:{c}" for u, c in zip(uniq, cnt)))
        # the batch finishes when its last instance converges, so the
        # amortized per-solve time is an upper bound
        print(f"mask efficiency (mean/max iterations): {it.mean() / max(it.max(), 1):.3f}")
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        np.savetxt(out, times)
        print(f"written {out}")


if __name__ == "__main__":
    main()
