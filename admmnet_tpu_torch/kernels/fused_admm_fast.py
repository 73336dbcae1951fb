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
``csrc/fused_admm_fast.cu`` for CUDA tensors and runs
``admm_solve_fused_fast_plain`` for CPU tensors; the plain version is the
kernel's dataflow in batched torch ops (carried rows, bracket, split
products), not the per-step scan path of ``solver.admm``.  The kernel keeps
only Z as planes: of G it keeps the diagonal and row n, which is all the
next iteration reads.

Precision rule (kernel and plain version alike): a schedule step is "hi"
iff ``all_hi or s >= nsteps - hi_steps``, the closing products iff
``final_hi``; a hi product is the 3-pass split-bf16 product when
``three_pass``, every other product is IEEE fp32; the iterate is
re-projected onto the Hermitian subspace after a step iff it is not hi or
``three_pass``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from admmnet_tpu_torch.kernels.polar import (
    LaunchCounter,
    abs_product,
    frobenius_inv,
    padded_side,
    sign_schedule,
)
from admmnet_tpu_torch.ops.projections import POLAR_BF16_POLISH, POLAR_BF16_SCHEDULE

SCRATCH_PLANES = 11
BIG = 3e37  # "no bracket yet": the next clamp falls back to the global one

launches = LaunchCounter()  # K2: layout="lean"
lists_launches = LaunchCounter()  # K3: layout="lists"


def full_schedule(schedule, hi_steps: int, all_hi: bool):
    """The schedule the kernel runs: the polish step is appended when
    hi_steps >= 1 and not all_hi."""
    return tuple(schedule) + (
        (POLAR_BF16_POLISH,) if (hi_steps >= 1 and not all_hi) else ()
    )


def check_variant(layout: str, ablate: str, fold_diag: bool, warm_root: bool,
                  all_hi: bool, three_pass: bool) -> None:
    """The JAX wrapper's argument guards, with its messages; the profiling
    variants (``ablate``) are not ported."""
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
    if ablate != "none":
        raise NotImplementedError("ablate profiling variants are not ported")


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


def check_launch(y: torch.Tensor, b: torch.Tensor, sigma) -> None:
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    if not (y.is_contiguous() and b.is_contiguous()):
        raise ValueError("expected contiguous y and b")
    if isinstance(sigma, torch.Tensor) and sigma.device != y.device:
        raise ValueError("sigma on another device than y")


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


def solve_plain(y, b, sigma, num_iters, rho, lambda_val, project, *, schedule,
                hi_steps, final_hi, layout, fold_diag, all_hi, three_pass):
    """The fused kernels' iteration in torch ops; phi (B, n) complex64.

    ``project(t, A)`` is the H-projection of (B, n) rows (A: (B, 1));
    ``schedule`` is the full schedule the kernel runs.  Shared by K2, K3
    and K7 (``kernels.fused_admm``), which differ in the projection and the
    knobs.
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
            # corner column by the Hermitian row read: g = conj(G[n, :])
            g_r, g_i = Gr[:, n, :n], -Gi[:, n, :n]
            z_r, z_i = Zr[:, n, :n], -Zi[:, n, :n]
            phi_r = w * (yob_r + (g_r if rho1 else rho * g_r) + z_r)
            phi_i = w * (yob_i + (g_i if rho1 else rho * g_i) + z_i)
            t = (torch.diagonal(Gr, dim1=-2, dim2=-1)
                 + zscale(torch.diagonal(Zr, dim1=-2, dim2=-1)))[:, :n]
        h = project(t, A)
        # B = [[diag h, phi], [phi^H, 1/lambda^2]]
        Br = torch.zeros_like(Zr)
        Bi = torch.zeros_like(Zr)
        Br[:, idx, idx] = h
        Br[:, n, :n] = phi_r
        Br[:, :n, n] = phi_r
        Br[:, n, n] = lam_inv_sq
        Bi[:, n, :n] = -phi_i
        Bi[:, :n, n] = phi_i
        Mr = Br - zscale(Zr)
        Mi = Bi - zscale(Zi)
        if lists:
            Mr = 0.5 * (Mr + tr(Mr))
            Mi = 0.5 * (Mi - tr(Mi))
        inv = frobenius_inv(Mr, Mi)
        Xr, Xi = sign_schedule(Mr * inv, Mi * inv, schedule, hi_steps, all_hi,
                               three_pass)
        Ar, Ai = abs_product(Xr, Xi, Mr, Mi, final_split)
        Pr = 0.5 * (Mr + Ar)
        Pi = 0.5 * (Mi + Ai)
        if lists:
            Pr = 0.5 * (Pr + tr(Pr))
            Pi = 0.5 * (Pi - tr(Pi))
            Zr = Zr + rho * (Pr - Br)
            Zi = Zi + rho * (Pi - Bi)
        else:
            Zr = Pr - Mr if rho1 else rho * (Pr - Mr)
            Zi = Pi - Mi if rho1 else rho * (Pi - Mi)
        if fold_diag:
            adiag = torch.diagonal(Ar, dim1=-2, dim2=-1)
            arow_r = Ar[:, n, :]
            arow_i = Ai[:, n, :]
        else:
            Gr, Gi = Pr, Pi
    return torch.complex(phi_r, phi_i)


def admm_solve_fused_fast_plain(
    y, b, sigma, num_iters, rho=1.0, lambda_val=1.0, *, hi_steps=0,
    outer_iters=6, inner_iters=5, schedule=POLAR_BF16_SCHEDULE, final_hi=True,
    layout="lean", loop_unroll=1, fold_diag=False, warm_root=False, all_hi=False,
    three_pass=False,
):
    """The kernel's computation in torch ops; phi (B, n) complex64.
    ``loop_unroll`` changes no arithmetic and is ignored."""
    del loop_unroll
    check_variant(layout, "none", fold_diag, warm_root, all_hi, three_pass)
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
        three_pass=three_pass,
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

    CUDA tensors launch the kernel (one thread block per instance, the
    whole loop inside it); CPU tensors run ``admm_solve_fused_fast_plain``.
    ``kblk`` (the TPU kernel's instance interleave) and ``loop_unroll`` (a
    Mosaic loop-unroll factor, no arithmetic) have no effect on Hopper.
    The argument guards are the JAX wrapper's; ``ablate`` (profiling
    variants) raises NotImplementedError.
    """
    del kblk, loop_unroll  # one thread block per instance, loop not unrolled
    check_variant(layout, ablate, fold_diag, warm_root, all_hi, three_pass)
    check_rows(y, b)
    B, n = y.shape
    P = padded_side(n + 1)
    kw = dict(hi_steps=hi_steps, outer_iters=outer_iters, inner_iters=inner_iters,
              schedule=schedule, final_hi=final_hi, layout=layout,
              fold_diag=fold_diag, warm_root=warm_root, all_hi=all_hi,
              three_pass=three_pass)
    if y.device.type == "cpu":
        return admm_solve_fused_fast_plain(y, b, sigma, num_iters, rho, lambda_val, **kw)
    check_launch(y, b, sigma)
    from admmnet_tpu_torch.kernels import _build

    sched = full_schedule(schedule, hi_steps, all_hi)
    yob_r, yob_i, w, A = solve_inputs(y, b, sigma, rho)
    phi_r = torch.empty((B, n), dtype=torch.float32, device=y.device)
    phi_i = torch.empty_like(phi_r)
    if B == 0:
        return torch.complex(phi_r, phi_i)
    scratch = torch.empty((B, SCRATCH_PLANES, P, P), dtype=torch.float32,
                          device=y.device)
    coeffs = np.ascontiguousarray(sched, dtype=np.float32)
    lists = layout == "lists"
    lib = _build.lib()
    with torch.cuda.device(y.device):
        err = lib.fused_admm_fast_launch(
            yob_r.data_ptr(), yob_i.data_ptr(), w.data_ptr(), A.data_ptr(),
            phi_r.data_ptr(), phi_i.data_ptr(), scratch.data_ptr(),
            B, n, P, int(num_iters), float(rho), float(1.0 / lambda_val**2),
            coeffs.ctypes.data, len(sched), int(hi_steps), int(outer_iters),
            int(inner_iters), int(final_hi), int(warm_root), int(all_hi),
            int(three_pass), int(fold_diag), int(lists),
            torch.cuda.current_stream(y.device).cuda_stream,
        )
    _build.check(err, "fused_admm_fast_launch")
    (lists_launches if lists else launches).count += 1
    return torch.complex(phi_r, phi_i)
