"""First-generation whole fixed-iteration ADMM solve in one kernel (K7).

Counterpart of ``admmnet_tpu/kernels/fused_admm.py :: admm_solve_fused``:
the per-step ``g_update="polar"`` solve with the whole loop inside one
kernel.  Per iteration: the corner reads and the phi row update,
t = diag(G + Z/rho), the nested-bisection H-projection
(``project_sum_inf_nested``: bisection on the multiplier mu, inside it a
bisection onto the l1 ball with a final rescale to the radius), B,
M = herm(B - Z/rho), the quintic-7 sign schedule with every product fp32
and no per-step re-projection, the symmetrized |M| product and P, and
Z' = Z + rho (G' - B).

``admm_solve_fused`` launches the CUDA kernel of ``csrc/fused_admm.cu`` for
CUDA tensors and runs ``admm_solve_fused_plain`` for CPU tensors.  The
iteration is the lists layout of ``kernels.fused_admm_fast`` with another
H-projection, so both plain versions share ``fused_admm_fast.solve_plain``.
On the card the solve runs on K1's body (``csrc/polar_cta.cuh``): one
thread block per instance (a cluster of two at P = 128) with the sign
iterate in shared memory and every product in 3xTF32 on the tensor cores
(fp32-faithful), Z in a two-plane scratch per instance.
"""

from __future__ import annotations

import numpy as np
import torch

from admmnet_tpu_torch.kernels import _build
from admmnet_tpu_torch.kernels.fused_admm_fast import check_rows, solve_inputs, solve_plain
from admmnet_tpu_torch.kernels.polar import padded_side
from admmnet_tpu_torch.ops.projections import POLAR_QUINTIC_SCHEDULE, project_l1_ball
from admmnet_tpu_torch.utils.profiling import LaunchCounter

Z_PLANES = 2  # the kernel's per-instance scratch: Z's real and imaginary planes
launches = LaunchCounter("K7")


def project_sum_inf_nested(t, A, outer_iters, inner_iters):
    """Projection of (B, n) rows onto {A ||h||_inf + sum h <= 1}; A (B, 1).

    The dataflow of the JAX kernel's ``_project_sum_inf_row``: bisection on
    mu over [0, max(1, |t|^2/2 + 1)], h(mu) = v - Proj_{l1 ball of radius
    mu A}(v) with v = t - mu, the l1 projection itself a bisection on the
    soft threshold (``ops.projections.project_l1_ball``); then h(hi), and t
    where t is feasible.
    """
    def f_of(h):
        return A * torch.amax(torch.abs(h), dim=-1, keepdim=True) + torch.sum(
            h, dim=-1, keepdim=True
        )

    def h_of(mu):
        v = t - mu
        return v - project_l1_ball(v, (mu * A)[:, 0], inner_iters)

    feasible = f_of(t) <= 1.0
    lo = torch.zeros_like(A)
    hi = torch.clamp_min(0.5 * torch.sum(t * t, dim=-1, keepdim=True) + 1.0, 1.0)
    for _ in range(outer_iters):
        mu = 0.5 * (lo + hi)
        viol = f_of(h_of(mu)) > 1.0
        lo, hi = torch.where(viol, mu, lo), torch.where(viol, hi, mu)
    return torch.where(feasible, t, h_of(hi))


def admm_solve_fused_plain(y, b, sigma, num_iters=100, rho=1.0, lambda_val=1.0,
                           outer_iters=32, inner_iters=32):
    """The kernel's computation in torch ops; phi (B, n) complex64."""
    return solve_plain(
        y, b, sigma, num_iters, rho, lambda_val,
        lambda t, A: project_sum_inf_nested(t, A, outer_iters, inner_iters),
        schedule=POLAR_QUINTIC_SCHEDULE, hi_steps=0, final_hi=True, layout="lists",
        fold_diag=False, all_hi=True, three_pass=False,
    )


def admm_solve_fused(
    y: torch.Tensor,
    b: torch.Tensor,
    sigma,
    num_iters: int = 100,
    rho: float = 1.0,
    lambda_val: float = 1.0,
    outer_iters: int = 32,
    inner_iters: int = 32,
) -> torch.Tensor:
    """Fixed-iteration solve of (B, n) complex64 instances; phi (B, n).

    Equivalent to ``admm_solve_fixed(..., ADMMOptions(g_update="polar"))``
    with the whole loop inside one kernel.  CUDA tensors launch the kernel
    (one thread block per instance, or a cluster of two at P = 128); CPU
    tensors run ``admm_solve_fused_plain``.
    """
    check_rows(y, b)
    B, n = y.shape
    P = padded_side(n + 1)
    if y.device.type == "cpu":
        return admm_solve_fused_plain(y, b, sigma, num_iters, rho, lambda_val,
                                      outer_iters, inner_iters)
    yob_r, yob_i, w, A = solve_inputs(y, b, sigma, rho)
    phi_r = torch.empty((B, n), dtype=torch.float32, device=y.device)
    phi_i = torch.empty_like(phi_r)
    if B == 0:
        return torch.complex(phi_r, phi_i)
    zscratch = torch.empty((B, Z_PLANES, P, P), dtype=torch.float32, device=y.device)
    coeffs = np.ascontiguousarray(POLAR_QUINTIC_SCHEDULE, dtype=np.float32)
    _build.launch(
        "fused_admm_launch", launches, yob_r=yob_r, yob_i=yob_i, w=w, A=A,
        phi_r=phi_r, phi_i=phi_i, zscratch=zscratch, B=B, n=n, P=P, num_iters=int(num_iters),
        rho=float(rho), lam_inv_sq=float(1.0 / lambda_val**2), coeffs=coeffs.ctypes.data,
        nsteps=len(POLAR_QUINTIC_SCHEDULE), outer_iters=int(outer_iters),
        inner_iters=int(inner_iters))
    return torch.complex(phi_r, phi_i)
