"""Whole fixed-iteration ADMM solve in one kernel (fused_fast / fused_exact).

Counterpart of ``admmnet_tpu/kernels/fused_admm_fast.py ::
admm_solve_fused_fast``, both layouts:

- ``layout="lean"`` (K2, ``_fused_fast_kernel_lean``): M assembled directly,
  no re-symmetrization, Z' = rho (G' - M).  With ``fold_diag`` the next
  iteration's two reads (diag(G + Z/rho), the corner row of rho G + Z) are
  taken from the symmetrized |M| product A; without it, from G and Z.
- ``layout="lists"`` (K3, ``_fused_fast_kernel``, the escape hatch): B
  materialized, M = herm(B - Z/rho), the PSD output re-symmetrized,
  Z' = Z + rho (G' - B), a cold root-finder.

``admm_solve_fused_fast`` launches the CUDA kernel of
``csrc/fused_admm_fast.cu`` (body ``csrc/fused_solve_tc.cuh``: one
thread-block cluster per instance, the working planes in the cluster's
shared memory, every product on the tensor cores) for CUDA tensors and runs
``admm_solve_fused_fast_plain`` for CPU tensors; the plain version is the
kernel's dataflow in batched torch ops (carried rows, bracket, split
products), not the per-step scan path of ``solver.admm``.  The kernel keeps
Z in registers: of G it keeps the diagonal and row n, which is all the
next iteration reads.  Only the (B, n) rows go in and phi comes out.

``ablate`` (profiling only: any value but ``"none"`` returns a wrong phi by
design) removes one component of the unfolded lean iteration, as the JAX
kernel's variants do, so that a subtraction profile can time it
(``chip_smoke.py --profile-k2``): ``"corner"`` (the corner-row reads: the
previous phi stands in for them), ``"diag"`` (the diagonal read: t = phi),
``"h"`` (the H-projection: h = t), ``"norm"`` (the Frobenius scaling: 1/64),
``"assemble"`` (M = G/2 - Z/rho), ``"zupd"`` (Z' = G') and ``"finals"`` (the
closing |M| products: G' is the sign iterate).  The phi output then reads
phi + 0 G'[n, :], the final G' row, which keeps the chain live and carries a
non-finite value through as JAX's debug output does.

Precision rule, the JAX package's: a schedule step is "hi" iff
``all_hi or s >= nsteps - hi_steps``, the closing products iff
``final_hi``; a hi product is fp32, or the 3-pass split-bf16 product when
``three_pass``; every other product is one-pass: each operand (an operand
sum of the Karatsuba form is formed in fp32 first) is rounded, and the
exact products are summed in fp32.  The iterate is re-projected onto the
Hermitian subspace after a step iff it is not hi or ``three_pass``.  The
tier follows the device, as ``jax.lax.Precision.DEFAULT`` does in JAX: on
the CPU, where DEFAULT is fp32 in JAX, the plain version computes every
product that is not split in IEEE fp32; on the card, fp32 products run in
3xTF32 on the tensor cores (fp32-faithful), split products as four TF32
products, and one-pass products as one TF32 ``mma.sync`` m16n8k8 each,
the operands rounded to tf32 (ties away from zero; a square's in the
4-multiplication form, which rounds the operands of the Hermitian square's
three products).  DEFAULT rounds to bf16 on the MXU; a bf16 kernel sat up
to 7.9e-2 per instance from its emulation after 100 iterations, as two
summation orders of the emulation itself do (PERF.md, section 6), beyond
the JAX package's 0.05 band for the fast mode's phi, so K2 and K3 round to
tf32.
``one_pass=True`` makes the plain version round the low products'
operands as the card does: the reference the kernel is held to, which no
caller on the main path sets.  The kernel runs ``three_pass`` only with
every product hi (fused_exact: ``all_hi`` and ``final_hi``), and the
ablate variants without three_pass, in the card's tier.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from admmnet_tpu_torch.kernels import _build
from admmnet_tpu_torch.kernels.polar import (
    abs_product,
    frobenius_inv,
    padded_side,
    sign_schedule,
    tf32_rna,
)
from admmnet_tpu_torch.ops.projections import POLAR_BF16_POLISH, POLAR_BF16_SCHEDULE
from admmnet_tpu_torch.utils.profiling import LaunchCounter

BIG = 3e37  # "no bracket yet": the next clamp falls back to the global one
NORM_ABLATED_INV = 1.0 / 64.0  # ablate="norm": the fixed Frobenius scaling

launches = LaunchCounter("K2")  # layout="lean"
lists_launches = LaunchCounter("K3")  # layout="lists"


def full_schedule(schedule, hi_steps: int, all_hi: bool):
    """The schedule the kernel runs: the polish step is appended when
    hi_steps >= 1 and not all_hi."""
    return tuple(schedule) + (
        (POLAR_BF16_POLISH,) if (hi_steps >= 1 and not all_hi) else ()
    )


ABLATE = ("none", "corner", "diag", "h", "norm", "assemble", "zupd", "finals")


def check_variant(layout: str, ablate: str, fold_diag: bool, warm_root: bool,
                  all_hi: bool, three_pass: bool) -> None:
    """The JAX wrapper's argument guards, with its messages, and the names
    of the profiling variants (``ABLATE``)."""
    if ablate not in ABLATE:
        raise ValueError(f"unknown ablate {ablate!r}; expected one of {ABLATE}")
    if layout not in ("lean", "lists"):
        raise ValueError(f"unknown layout {layout!r}")
    if ablate != "none" and layout != "lean":
        raise ValueError("ablate profiling is lean-layout only")
    if ablate != "none" and fold_diag:
        raise ValueError("ablate profiling assumes the unfolded carry layout")
    if (fold_diag or warm_root or all_hi or three_pass) and layout != "lean":
        raise ValueError(
            "fold_diag/warm_root/all_hi/three_pass are lean-layout options"
        )


def solve_inputs(y, b, sigma, rho):
    """Rows of the kernel: Re/Im of y/b, w = |b|^2/(1 + rho|b|^2) and
    A = 2 sqrt(n) sigma + sigma^2, all float32."""
    n = y.shape[-1]
    b_sq = torch.abs(b) ** 2
    w = (b_sq / (1.0 + rho * b_sq)).to(torch.float32)
    yob = y / b
    sigma = torch.broadcast_to(
        torch.as_tensor(sigma, dtype=torch.float32, device=y.device), y.shape[:1]
    )
    A = 2.0 * math.sqrt(float(n)) * sigma + sigma**2
    return (yob.real.to(torch.float32).contiguous(),
            yob.imag.to(torch.float32).contiguous(), w.contiguous(),
            A.contiguous())


def check_rows(y: torch.Tensor, b: torch.Tensor) -> None:
    if y.dim() != 2 or b.shape != y.shape:
        raise ValueError(f"expected y, b of shape (B, n), got {tuple(y.shape)}, "
                         f"{tuple(b.shape)}")
    if y.dtype != torch.complex64 or b.dtype != torch.complex64:
        raise TypeError("expected complex64 y and b")
    if y.device != b.device:
        raise ValueError("y and b on different devices")


# ---- plain version ----------------------------------------------------------


def _prox_h(t, mu, A, inner_iters):
    """prox of mu*A*||.||_inf at t - mu: clamp at the Newton waterline."""
    n = t.shape[-1]
    v = t - mu
    av = torch.abs(v)
    r = mu * A
    total = torch.sum(av, dim=-1, keepdim=True)
    tau = torch.clamp_min((total - r) / n, 0.0)
    for _ in range(inner_iters):
        s = torch.sum(torch.clamp_min(av - tau, 0.0), dim=-1, keepdim=True)
        cnt = torch.clamp_min(
            torch.sum((av > tau).to(torch.float32), dim=-1, keepdim=True), 1.0
        )
        tau = tau + (s - r) / cnt
    h = torch.minimum(torch.maximum(v, -tau), tau)
    return torch.where(total <= r, torch.zeros_like(h), h)


def project_sum_inf_block(t, A, outer_iters, inner_iters, bracket=None):
    """Projection of (B, n) rows onto {A ||h||_inf + sum h <= 1}; A (B, 1).

    ``bracket``: the (lo, hi) pair of (B, 1) carried across iterations;
    returns (h, (lo_next, hi_next)) when given, else h.
    """
    def f_of(h):
        return A * torch.amax(torch.abs(h), dim=-1, keepdim=True) + torch.sum(
            h, dim=-1, keepdim=True
        )

    feasible = f_of(t) <= 1.0
    glob_hi = torch.clamp_min(0.5 * torch.sum(t * t, dim=-1, keepdim=True) + 1.0, 1.0)
    if bracket is None:
        lo, hi = torch.zeros_like(glob_hi), glob_hi
    else:
        lo = torch.minimum(torch.clamp_min(bracket[0], 0.0), glob_hi)
        hi = torch.minimum(torch.maximum(bracket[1], lo), glob_hi)
    for _ in range(outer_iters):
        mu = 0.5 * (lo + hi)
        viol = f_of(_prox_h(t, mu, A, inner_iters)) > 1.0
        lo, hi = torch.where(viol, mu, lo), torch.where(viol, hi, mu)
    h = torch.where(feasible, t, _prox_h(t, hi, A, inner_iters))
    if bracket is None:
        return h
    w = torch.maximum(hi - lo, 0.05 * hi + 1e-2)
    lo_n = torch.where(feasible, 0.0, torch.clamp_min(lo - w, 0.0))
    hi_n = torch.where(feasible, BIG, hi + w)
    return h, (lo_n, hi_n)


def one_pass_products(nsteps: int, hi_steps: int, all_hi: bool, final_hi: bool) -> int:
    """Useful real products per iteration that the card runs one-pass, for a
    full schedule of nsteps: 9 a low step (the Hermitian squares' 3 each,
    the Karatsuba product's 3) and the 3 closing ones when final_hi is off.
    The kernel issues 11 a low step: its squares take the 4-multiplication
    form."""
    low = 0 if all_hi else max(nsteps - hi_steps, 0)
    return 9 * low + (0 if final_hi else 3)


def solve_plain(y, b, sigma, num_iters, rho, lambda_val, project, *, schedule,
                hi_steps, final_hi, layout, fold_diag, all_hi, three_pass,
                ablate="none", one_pass=False):
    """The fused kernels' iteration in torch ops; phi (B, n) complex64.

    ``project(t, A)`` is the H-projection of (B, n) rows (A: (B, 1));
    ``schedule`` is the full schedule the kernel runs.  Shared by K2, K3
    and K7 (``kernels.fused_admm``), which differ in the projection and the
    knobs.  ``ablate``: K2's profiling variants (unfolded lean layout).
    ``one_pass``: the low and (final_hi off) closing products as the card
    computes them (module docstring).
    """
    B, n = y.shape
    m = n + 1
    dev = y.device
    yob_r, yob_i, w, A = solve_inputs(y, b, sigma, rho)
    A = A[:, None]
    rho1 = rho == 1.0
    lists = layout == "lists"
    lam_inv_sq = float(1.0 / lambda_val**2)
    final_split = final_hi and three_pass
    rnd = tf32_rna if one_pass else None
    final_rnd = None if final_hi else rnd
    idx = torch.arange(n, device=dev)

    def zscale(z):
        return z if rho1 else z / rho

    def tr(x):
        return x.transpose(-1, -2)

    Zr = torch.zeros((B, m, m), dtype=torch.float32, device=dev)
    Zi = torch.zeros_like(Zr)
    Gr = torch.zeros_like(Zr)  # unfolded carry
    Gi = torch.zeros_like(Zr)
    adiag = torch.zeros((B, m), dtype=torch.float32, device=dev)  # folded carry
    arow_r = torch.zeros_like(adiag)
    arow_i = torch.zeros_like(adiag)
    phi_r = phi_i = torch.zeros((B, n), dtype=torch.float32, device=dev)
    for _ in range(num_iters):
        if fold_diag:
            ar = arow_r[:, :n] if rho1 else rho * arow_r[:, :n]
            ai = arow_i[:, :n] if rho1 else rho * arow_i[:, :n]
            phi_r = w * (yob_r + ar)
            phi_i = w * (yob_i - ai)
            t = adiag[:, :n]
        else:
            if ablate == "corner":  # the previous phi stands in for the rows
                g_r, g_i, z_r, z_i = phi_r, phi_i, phi_r, phi_i
            else:
                # corner column by the Hermitian row read: g = conj(G[n, :])
                g_r, g_i = Gr[:, n, :n], -Gi[:, n, :n]
                z_r, z_i = Zr[:, n, :n], -Zi[:, n, :n]
            phi_r = w * (yob_r + (g_r if rho1 else rho * g_r) + z_r)
            phi_i = w * (yob_i + (g_i if rho1 else rho * g_i) + z_i)
            if ablate == "diag":
                t = phi_r
            else:
                t = (torch.diagonal(Gr, dim1=-2, dim2=-1)
                     + zscale(torch.diagonal(Zr, dim1=-2, dim2=-1)))[:, :n]
        h = t if ablate == "h" else project(t, A)
        # B = [[diag h, phi], [phi^H, 1/lambda^2]]
        Br = torch.zeros_like(Zr)
        Bi = torch.zeros_like(Zr)
        Br[:, idx, idx] = h
        Br[:, n, :n] = phi_r
        Br[:, :n, n] = phi_r
        Br[:, n, n] = lam_inv_sq
        Bi[:, n, :n] = -phi_i
        Bi[:, :n, n] = phi_i
        if ablate == "assemble":
            Mr = 0.5 * Gr - zscale(Zr)
            Mi = 0.5 * Gi - zscale(Zi)
        else:
            Mr = Br - zscale(Zr)
            Mi = Bi - zscale(Zi)
        if lists:
            Mr = 0.5 * (Mr + tr(Mr))
            Mi = 0.5 * (Mi - tr(Mi))
        inv = NORM_ABLATED_INV if ablate == "norm" else frobenius_inv(Mr, Mi)
        Xr, Xi = sign_schedule(Mr * inv, Mi * inv, schedule, hi_steps, all_hi,
                               three_pass, one_pass_round=rnd)
        if ablate == "finals":  # G' is the sign iterate
            Pr, Pi = Xr, Xi
        else:
            Ar, Ai = abs_product(Xr, Xi, Mr, Mi, final_split, final_rnd)
            Pr = 0.5 * (Mr + Ar)
            Pi = 0.5 * (Mi + Ai)
        if lists:
            Pr = 0.5 * (Pr + tr(Pr))
            Pi = 0.5 * (Pi - tr(Pi))
            Zr = Zr + rho * (Pr - Br)
            Zi = Zi + rho * (Pi - Bi)
        elif ablate == "zupd":
            Zr, Zi = Pr, Pi
        else:
            Zr = Pr - Mr if rho1 else rho * (Pr - Mr)
            Zi = Pi - Mi if rho1 else rho * (Pi - Mi)
        if fold_diag:
            adiag = torch.diagonal(Ar, dim1=-2, dim2=-1)
            arow_r = Ar[:, n, :]
            arow_i = Ai[:, n, :]
        else:
            Gr, Gi = Pr, Pi
    if ablate != "none":  # the debug output keeps the final G' row live
        phi_r = phi_r + 0.0 * Gr[:, n, :n]
    return torch.complex(phi_r, phi_i)


def admm_solve_fused_fast_plain(
    y, b, sigma, num_iters, rho=1.0, lambda_val=1.0, *, hi_steps=0,
    outer_iters=6, inner_iters=5, schedule=POLAR_BF16_SCHEDULE, final_hi=True,
    layout="lean", ablate="none", loop_unroll=1, fold_diag=False, warm_root=False,
    all_hi=False, three_pass=False, one_pass=False,
):
    """The kernel's computation in torch ops; phi (B, n) complex64.
    ``loop_unroll`` changes no arithmetic and is ignored; ``one_pass``: the
    card's one-pass products (module docstring)."""
    del loop_unroll
    check_variant(layout, ablate, fold_diag, warm_root, all_hi, three_pass)
    B = y.shape[0]
    bracket = [torch.zeros((B, 1), dtype=torch.float32, device=y.device),
               torch.full((B, 1), BIG, dtype=torch.float32, device=y.device)]

    def project(t, A):
        if not warm_root:
            return project_sum_inf_block(t, A, outer_iters, inner_iters)
        h, bracket[:] = project_sum_inf_block(t, A, outer_iters, inner_iters, bracket)
        return h

    return solve_plain(
        y, b, sigma, num_iters, rho, lambda_val, project,
        schedule=full_schedule(schedule, hi_steps, all_hi), hi_steps=hi_steps,
        final_hi=final_hi, layout=layout, fold_diag=fold_diag, all_hi=all_hi,
        three_pass=three_pass, ablate=ablate, one_pass=one_pass,
    )


# ---- the kernel -------------------------------------------------------------


def admm_solve_fused_fast(
    y: torch.Tensor,
    b: torch.Tensor,
    sigma,
    num_iters: int = 100,
    rho: float = 1.0,
    lambda_val: float = 1.0,
    *,
    kblk: int = 16,
    hi_steps: int = 0,
    outer_iters: int = 6,
    inner_iters: int = 5,
    schedule=POLAR_BF16_SCHEDULE,
    final_hi: bool = True,
    layout: str = "lean",
    ablate: str = "none",
    loop_unroll: int = 1,
    fold_diag: bool = False,
    warm_root: bool = False,
    all_hi: bool = False,
    three_pass: bool = False,
) -> torch.Tensor:
    """Fixed-iteration solve of (B, n) complex64 instances; phi (B, n).

    CUDA tensors launch the kernel (one thread-block cluster per instance,
    the whole loop inside it, its low products one-pass); CPU tensors run
    ``admm_solve_fused_fast_plain`` (fp32 products).
    ``kblk`` (the TPU kernel's instance interleave) and ``loop_unroll`` (a
    Mosaic loop-unroll factor, no arithmetic) have no effect on Hopper.
    The argument guards are the JAX wrapper's; ``ablate`` selects a
    profiling variant (module docstring), an instantiation of its own.
    """
    del kblk, loop_unroll  # one cluster per instance, loop not unrolled
    check_variant(layout, ablate, fold_diag, warm_root, all_hi, three_pass)
    check_rows(y, b)
    B, n = y.shape
    P = padded_side(n + 1)
    kw = dict(hi_steps=hi_steps, outer_iters=outer_iters, inner_iters=inner_iters,
              schedule=schedule, final_hi=final_hi, layout=layout, ablate=ablate,
              fold_diag=fold_diag, warm_root=warm_root, all_hi=all_hi,
              three_pass=three_pass)
    if y.device.type == "cpu":
        return admm_solve_fused_fast_plain(y, b, sigma, num_iters, rho, lambda_val, **kw)
    if ablate != "none" and three_pass:
        raise ValueError("the kernel runs the ablate variants without three_pass")
    sched = full_schedule(schedule, hi_steps, all_hi)
    if three_pass and one_pass_products(len(sched), hi_steps, all_hi, final_hi):
        raise ValueError("the kernel runs three_pass only with every product hi "
                         "(all_hi or hi_steps covering the schedule, and final_hi)")
    yob_r, yob_i, w, A = solve_inputs(y, b, sigma, rho)
    phi_r = torch.empty((B, n), dtype=torch.float32, device=y.device)
    phi_i = torch.empty_like(phi_r)
    if B == 0:
        return torch.complex(phi_r, phi_i)
    coeffs = np.ascontiguousarray(sched, dtype=np.float32)
    lists = layout == "lists"
    _build.launch(
        "fused_admm_fast_launch", lists_launches if lists else launches,
        yob_r=yob_r, yob_i=yob_i, w=w, A=A, phi_r=phi_r, phi_i=phi_i, B=B, n=n, P=P,
        num_iters=int(num_iters), rho=float(rho), lam_inv_sq=float(1.0 / lambda_val**2),
        coeffs=coeffs.ctypes.data, nsteps=len(sched), hi_steps=int(hi_steps),
        outer_iters=int(outer_iters), inner_iters=int(inner_iters), final_hi=int(final_hi),
        warm_root=int(warm_root), all_hi=int(all_hi), three_pass=int(three_pass),
        fold_diag=int(fold_diag), lists=int(lists), ablate=ABLATE.index(ablate))
    return torch.complex(phi_r, phi_i)
