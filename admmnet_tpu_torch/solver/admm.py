"""Batched classical ANM-DUMV ADMM solver.

The iteration, per active instance:

  phi   <- (D^-1 + rho I)^-1 (D_b^-1 y + rho g + zeta)        [diagonal]
  h     <- Proj_{A||h||_inf + sum(h) <= 1} Re diag(G_hat + Z_hat/rho)
  B     <- [[diag(h), phi], [phi^H, 1/lambda^2]]
  G     <- PSD-step(B - Z/rho)
  Z     <- Z + rho (G - B)

``admm_solve_fixed`` runs a fixed number of iterations.  Its ``fused_fast``
and ``fused_exact`` modes run the whole solve in the fused kernel
(``kernels.fused_admm_fast``) up to a lifted side n + 1 of 128; above it
they warn and take the loop below with ``polar_fast`` or ``polar``, as the
JAX package does; ``polar`` and ``polar_fast`` run a Python
loop whose G-step is the polar kernel (``kernels.polar``); ``eigh``,
``newton_schulz`` and ``ref_identity`` are plain torch.  Every mode runs on
the device of its inputs: a CUDA input launches the kernels, a CPU input
runs their plain versions.

``admm_solve`` is the masked per-instance convergence loop: converged
instances freeze while the rest iterate, and the loop exits (one host sync
per iteration) when all have converged or ``max_iter`` is reached.
Stopping after >= min_iter iterations when
  ||G - B||_F        <= eta_abs sqrt(n+1) + eta_rel max(||G||_F, ||B||_F)
  rho ||h - h_prev|| <= eta_abs sqrt(n)   + eta_rel ||Z||_F
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import NamedTuple, Optional

import torch

from admmnet_tpu_torch.core.config import ADMMOptions
from admmnet_tpu_torch.kernels.fused_admm_fast import admm_solve_fused_fast
from admmnet_tpu_torch.kernels.polar import MAX_SIDE, psd_project_polar_kernel
from admmnet_tpu_torch.ops.atoms import COMPLEX
from admmnet_tpu_torch.ops.linalg import (
    assemble_lifted,
    fro_norm,
    hermitianize,
    lifted_corner_vec,
    lifted_topleft,
    vec_norm,
)
from admmnet_tpu_torch.ops.projections import (
    POLAR_BF16_SCHED2,
    POLAR_BF16_SCHED3,
    POLAR_BF16_SCHEDULE,
    POLAR_QUINTIC5_SCHEDULE,
    POLAR_QUINTIC_SCHEDULE,
    project_sum_inf,
    psd_project_eigh,
    psd_project_newton_schulz,
    psd_project_polar,
)
from admmnet_tpu_torch.utils import profiling


class ADMMResult(NamedTuple):
    phi: torch.Tensor  # (..., n) complex: dual polynomial coefficients
    iterations: torch.Tensor  # (...,) int32: per-instance iterations used
    converged: torch.Tensor  # (...,) bool
    r_pri: torch.Tensor  # (...,) final primal residual
    r_dual: torch.Tensor  # (...,) final dual residual


def _phi_update_diag(y, b, g, zeta, rho):
    """(D^-1 + rho I)^-1 (y/b + rho g + zeta) elementwise, D = diag(|b|^2)."""
    b_sq = torch.abs(b) ** 2
    weight = (b_sq / (1.0 + rho * b_sq)).to(COMPLEX)
    return weight * (y / b + rho * g + zeta)


def _phi_update_ref_dense(y, b, g, zeta, rho):
    """The reference's D^-1 + rho*11^T solve, by Sherman-Morrison:
    (D^-1 + rho 11^T)^-1 v = D v - rho (1^T D v) D1 / (1 + rho tr D)."""
    d = (torch.abs(b) ** 2).to(COMPLEX)
    v = y / b + rho * g + zeta
    dv = d * v
    corr = rho * torch.sum(dv, dim=-1, keepdim=True) / (
        1.0 + rho * torch.sum(d, dim=-1, keepdim=True)
    )
    return dv - corr * d


def _g_step(M, opts: ADMMOptions):
    """PSD step of one iteration; the fused modes' per-step math is
    polar_fast's (fused_fast) or polar's (fused_exact)."""
    g = opts.g_update
    if g == "eigh":
        return psd_project_eigh(M)
    if g in ("polar", "polar_fast", "fused_exact", "fused_fast"):
        fast = g in ("polar_fast", "fused_fast")
        if M.shape[-1] > MAX_SIDE:
            # beyond the kernel's plane size, as in the JAX package: the
            # plain schedule (complex products, no re-projection)
            return psd_project_polar(
                M, POLAR_BF16_SCHEDULE if fast else POLAR_QUINTIC_SCHEDULE
            )
        if fast:
            return psd_project_polar_kernel(
                M.contiguous(), mode="fast", hi_steps=opts.polar_fast_hi_steps,
                bf16_store=opts.polar_bf16_store,
            )
        return psd_project_polar_kernel(M.contiguous(), mode="accurate")
    if g == "newton_schulz":
        return psd_project_newton_schulz(M, opts.newton_schulz_iters)
    # "ref_identity": the reference's SVD step is the identity on a
    # Hermitian matrix; keep the symmetrization.
    return M


def _constraint_weight(sigma, batch, n, device):
    sigma = torch.broadcast_to(
        torch.as_tensor(sigma, dtype=torch.float32, device=device), batch
    )
    return 2.0 * math.sqrt(float(n)) * sigma + sigma**2


def _iteration(y, b, A, lam_inv_sq, G, Z, opts):
    rho = opts.rho
    g = lifted_corner_vec(G)
    zeta = lifted_corner_vec(Z)
    if opts.phi_update == "diag":
        phi = _phi_update_diag(y, b, g, zeta, rho)
    else:
        phi = _phi_update_ref_dense(y, b, g, zeta, rho)
    t = torch.real(
        torch.diagonal(lifted_topleft(G), dim1=-2, dim2=-1)
        + torch.diagonal(lifted_topleft(Z), dim1=-2, dim2=-1) / rho
    )
    h = project_sum_inf(t, A)
    B = assemble_lifted(h, phi, lam_inv_sq)
    G_new = _g_step(hermitianize(B - Z / rho), opts)
    Z_new = Z + rho * (G_new - B)
    return phi, h, G_new, Z_new, B


def admm_solve(y, b, sigma, lambda_val: float = 1.0,
               opts: ADMMOptions = ADMMOptions()) -> ADMMResult:
    """Solve batched instances; early-exits when all converge.

    y, b: (..., n) complex observations / demodulated symbols; sigma:
    (...,) noise-level bound; lambda_val: ANM weight.
    """
    y = torch.as_tensor(y).to(COMPLEX)
    b = torch.as_tensor(b).to(COMPLEX).to(y.device)
    batch = y.shape[:-1]
    n = y.shape[-1]
    dev = y.device
    A = _constraint_weight(sigma, batch, n, dev)
    lam_inv_sq = 1.0 / (lambda_val**2)

    phi = torch.zeros((*batch, n), dtype=COMPLEX, device=dev)
    h = torch.zeros((*batch, n), dtype=torch.float32, device=dev)
    G = torch.zeros((*batch, n + 1, n + 1), dtype=COMPLEX, device=dev)
    Z = torch.zeros_like(G)
    iterations = torch.zeros(batch, dtype=torch.int32, device=dev)
    converged = torch.zeros(batch, dtype=torch.bool, device=dev)
    r_pri = torch.full(batch, math.inf, dtype=torch.float32, device=dev)
    r_dual = torch.full(batch, math.inf, dtype=torch.float32, device=dev)

    def masked(mask, new, old):
        return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - mask.dim())),
                           new, old)

    it = 0
    while it < opts.max_iter and not bool(torch.all(converged)):
        it += 1  # 1-based like the reference loop
        phi_n, h_n, G_n, Z_n, B = _iteration(y, b, A, lam_inv_sq, G, Z, opts)
        rp = fro_norm(G_n - B)
        eta_pri = opts.eta_abs * math.sqrt(n + 1.0) + opts.eta_rel * torch.maximum(
            fro_norm(G_n), fro_norm(B)
        )
        rd = opts.rho * vec_norm(h_n - h)
        eta_dual = opts.eta_abs * math.sqrt(float(n)) + opts.eta_rel * fro_norm(Z_n)
        active = ~converged
        min_ok = (it >= opts.min_iter if opts.use_min_iter else True) and it > 1
        newly = active & min_ok & (rp <= eta_pri) & (rd <= eta_dual)
        phi = masked(active, phi_n, phi)
        h = masked(active, h_n, h)
        G = masked(active, G_n, G)
        Z = masked(active, Z_n, Z)
        iterations = torch.where(active, torch.full_like(iterations, it), iterations)
        converged = converged | newly
        r_pri = torch.where(active, rp, r_pri)
        r_dual = torch.where(active, rd, r_dual)
    return ADMMResult(phi=phi, iterations=iterations, converged=converged,
                      r_pri=r_pri, r_dual=r_dual)


def fused_kernel_options(opts: ADMMOptions) -> dict:
    """The fused kernel's knobs for a fused_fast / fused_exact option set,
    mapped exactly as the JAX dispatch maps them (fused_exact: the lean
    layout and no unroll knob)."""
    if opts.g_update == "fused_exact":
        sched = {"quintic5": POLAR_QUINTIC5_SCHEDULE,
                 "quintic7": POLAR_QUINTIC_SCHEDULE}[opts.fused_exact_schedule]
        return dict(
            hi_steps=0, outer_iters=opts.fused_exact_proj_iters,
            inner_iters=opts.fused_exact_inner_iters, schedule=sched,
            final_hi=True, layout="lean", fold_diag=opts.fused_fold_diag,
            warm_root=opts.fused_exact_warm_root, all_hi=True,
            three_pass=opts.fused_exact_three_pass,
        )
    sched = {"full": POLAR_BF16_SCHEDULE, "sched3": POLAR_BF16_SCHED3,
             "sched2": POLAR_BF16_SCHED2}[opts.fused_schedule]
    return dict(
        hi_steps=opts.polar_fast_hi_steps, outer_iters=opts.fused_proj_iters,
        inner_iters=opts.fused_inner_iters, schedule=sched,
        final_hi=opts.fused_final_hi, layout=opts.fused_layout,
        loop_unroll=opts.fused_unroll, fold_diag=opts.fused_fold_diag,
        warm_root=opts.fused_warm_root,
    )


def admm_solve_fixed(y, b, sigma, num_iters: int, lambda_val: float = 1.0,
                     opts: Optional[ADMMOptions] = None) -> torch.Tensor:
    """Run exactly ``num_iters`` iterations (no convergence checks); phi.

    ``fused_fast`` / ``fused_exact`` run the fused solve on the batch
    flattened to one axis (the JAX package falls back to the loop for a
    batch of rank > 1 instead; the port's kernel takes any flattened
    batch).  At a lifted side n + 1 above 128, or with
    ``phi_update="ref_dense"`` (the fused solve implements ``"diag"``),
    they warn and run the loop with ``g_update="polar_fast"`` (``"polar"``
    for fused_exact), as the JAX package does off the TPU; the kernel's
    planes hold at most 128.
    """
    with profiling.span("solver.solve"):
        opts = opts or ADMMOptions()
        y = torch.as_tensor(y).to(COMPLEX)
        b = torch.as_tensor(b).to(COMPLEX).to(y.device)
        batch = y.shape[:-1]
        n = y.shape[-1]
        dev = y.device

        if opts.g_update in ("fused_fast", "fused_exact") and (
                n + 1 > MAX_SIDE or opts.phi_update != "diag"):
            fallback = "polar" if opts.g_update == "fused_exact" else "polar_fast"
            reason = (f"lifted size {n + 1} > {MAX_SIDE}" if n + 1 > MAX_SIDE else
                      f"phi_update={opts.phi_update!r} (the fused solve implements 'diag')")
            warnings.warn(
                f"g_update={opts.g_update!r} falling back to the scan path with "
                f"g_update={fallback!r}: {reason}",
                stacklevel=2,
            )
            opts = dataclasses.replace(opts, g_update=fallback)

        if opts.g_update in ("fused_fast", "fused_exact"):
            yb = y.reshape(-1, n).contiguous()
            bb = torch.broadcast_to(b, y.shape).reshape(-1, n).contiguous()
            s = torch.broadcast_to(
                torch.as_tensor(sigma, dtype=torch.float32, device=dev), batch
            ).reshape(-1)
            out = admm_solve_fused_fast(yb, bb, s, num_iters, opts.rho, lambda_val,
                                        kblk=opts.fused_kblk, **fused_kernel_options(opts))
            return out.reshape(*batch, n)

        A = _constraint_weight(sigma, batch, n, dev)
        lam_inv_sq = 1.0 / (lambda_val**2)
        phi = torch.zeros((*batch, n), dtype=COMPLEX, device=dev)
        G = torch.zeros((*batch, n + 1, n + 1), dtype=COMPLEX, device=dev)
        Z = torch.zeros_like(G)
        for _ in range(num_iters):
            phi, _, G, Z, _ = _iteration(y, b, A, lam_inv_sq, G, Z, opts)
        return phi

