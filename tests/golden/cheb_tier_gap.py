"""The CPU measurements behind chip_smoke.py's learned-path tolerances at
the Clenshaw kernels' card tiers (``NET3_PHI_TOL``, ``GOLDEN_LOSS_TOL``,
``GOLDEN_PARAM_TOL``, ``PHI_GOLDEN_STEP1_TOL``) and the gradient limits of
tests/test_torch_cuda.py's ``test_cheb_filter_fn_backward_on_cuda``.

On the card K4/K5 run one-pass bf16 products and K6 the split-bf16 product
with rounded residuals (the JAX package's tiers on the TPU); the JAX
goldens were computed on a CPU, in fp32.  This script runs chip_smoke's
phases on CPU tensors twice: with the plain versions in fp32 (the port's
CPU tier) and with the card's arithmetic emulated (``card_tier``: the plain
forward with ``one_pass=True``, the plain backward with ``three_pass=True,
one_pass=True``), and prints each gate's number for both: net-3's phi on
the 512 random scenes against net3_random512_jax.npz and its F1 (phase
11), three net-3 recipe steps against net3_train_golden.msgpack (phase
15), the phi net's steps against phinet_train_golden.msgpack (phase 27),
and the reversible gradient on ``B_K56`` spiked matrices against torch
autograd through the fp32 plain forward.  The emulation also runs with its one-pass
sums in float64 (``card_tier(f64=True)``): how far two valid summation
orders of the card's arithmetic sit apart, printed last for the steps of
phases 15 and 27 (chip_smoke holds the card's steps to their emulation on
the CPU as well).  Needs no
JAX; takes a few minutes.

Run from the repository root: python tests/golden/cheb_tier_gap.py
"""

import contextlib
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from test_torch_cuda import mm_f64  # noqa: E402

from admmnet_tpu_torch.kernels import cheb_filter as kc  # noqa: E402
from admmnet_tpu_torch.kernels import polar as kp  # noqa: E402


@contextlib.contextmanager
def card_tier(f64=False):
    """chip_smoke's ``card_tier_on_cpu``; with ``f64`` the one-pass and
    split products summed in float64."""
    mm = kp.mm
    if f64:
        kp.mm = mm_f64
    try:
        with chip_smoke.card_tier_on_cpu():
            yield
    finally:
        kp.mm = mm


def gradient(fn, M, c, Y):
    """(Hermitian part of Mbar, cbar) of Re sum(fn(M, c) conj(Y))."""
    Mg, cg = M.clone().requires_grad_(True), c.clone().requires_grad_(True)
    (fn(Mg, cg, chip_smoke.CHEB_DEGREE) * Y.conj()).real.sum().backward()
    return chip_smoke.herm(Mg.grad), cg.grad


def main():
    cpu = torch.device("cpu")
    # the card test's autograd gate: the reversible gradient vs torch
    # autograd through the fp32 plain forward, the zero matrix left out
    M, c, Y = chip_smoke.cheb_inputs(np.random.default_rng(4), chip_smoke.B_K56, cpu)
    M, c, Y = M[:-1], c[:-1], Y[:-1]
    ref = gradient(kc.cheb_filter_matrices_plain, M, c, Y)
    states = {}
    for label, ctx in (("fp32 (the CPU's tier)", contextlib.nullcontext),
                       ("card tier emulated", card_tier),
                       ("card tier emulated, float64 sums", lambda: card_tier(True))):
        with ctx():
            r = chip_smoke.net3_vs_golden(cpu)
            st3, stphi = {}, {}
            losses, gold, err = chip_smoke.golden_steps(cpu, state_out=st3)
            pl, pg, perr, _ = chip_smoke.phi_golden_steps(cpu, state_out=stphi)
            states[label] = (losses, st3, pl, stphi)
            gM, gc = gradient(kc.cheb_filter_matrices, M, c, Y)
        eM = float(chip_smoke.rel_err(gM, ref[0]).max())
        ec = float(chip_smoke.rel_err(gc, ref[1]).max())
        rel = np.abs(losses - gold) / np.abs(gold)
        prel = np.abs(pl - pg) / np.abs(pg)
        print(f"{label}: net-3 phi vs golden median {r['med']:.3e} max {r['mx']:.3e}, F1 "
              f"{r['st']['f1']:.4f} (golden {r['gst']['f1']:.4f}); net-3 steps loss rel err "
              f"{' '.join(f'{e:.3e}' for e in rel)}, parameter change error {err:.3e}; phi net "
              f"steps loss rel err {' '.join(f'{e:.3e}' for e in prel)}, parameter change "
              f"error {perr:.3e}; reversible gradient vs fp32 autograd Mbar {eM:.3e} cbar "
              f"{ec:.3e}", flush=True)
    # two valid summation orders of the card's arithmetic: how far the card
    # may sit from its emulation on the CPU (chip_smoke phases 15 and 27)
    (l32, s32, p32, sp32), (l64, s64, p64, sp64) = list(states.values())[1:]
    print(f"card tier emulated, float32 vs float64 sums: net-3 steps loss rel diff "
          f"{' '.join(f'{e:.3e}' for e in np.abs(l32 - l64) / np.abs(l64))}, parameter "
          f"distance {chip_smoke.state_distance(s32, s64):.3e}; phi net steps loss rel diff "
          f"{' '.join(f'{e:.3e}' for e in np.abs(p32 - p64) / np.abs(p64))}, parameter "
          f"distance {chip_smoke.state_distance(sp32, sp64):.3e}; losses (float32 sums): "
          f"net-3 {l32.tolist()}, phi net {p32.tolist()}", flush=True)


if __name__ == "__main__":
    main()
