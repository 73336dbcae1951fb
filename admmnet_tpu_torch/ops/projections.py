"""Vectorized Euclidean projections of the classical solver.

- ``project_sum_inf``: exact projection onto {h real : A*||h||_inf + sum(h) <= 1}
  by bisection on the dual scalar mu with a Newton-waterline prox inside.
- ``psd_project_eigh``: projection onto the Hermitian PSD cone via
  eigendecomposition and eigenvalue clamp.
- ``psd_project_newton_schulz`` / ``psd_project_polar``: matmul-only
  approximations P(M) = (M + |M|)/2 with |M| = sign(M) M, the sign taken by a
  cubic Newton-Schulz iteration or a fitted minimax polynomial schedule.

Derivation of project_sum_inf: minimize 1/2||h-t||^2 s.t. f(h) <= 1 with
f(h) = A*||h||_inf + 1^T h, A > 0.  If f(t) <= 1 return t.  Else for dual
mu >= 0 the Lagrangian minimizer is h(mu) = prox_{mu*A*||.||_inf}(t - mu*1);
f(h(mu)) is nonincreasing in mu and f(h(mu)) <= ||t||^2/(2*mu), so
mu_hi = max(1, ||t||^2/2 + 1) brackets the root f(h(mu)) = 1; bisect.

All matrix products here are float32 (complex64): on the card the callers
set ``torch.backends.cuda.matmul.allow_tf32 = False``.
"""

from __future__ import annotations

import torch


def project_l1_ball(v: torch.Tensor, radius, iters: int = 32) -> torch.Tensor:
    """Euclidean projection of real v (..., n) onto {x : ||x||_1 <= radius}.

    ``radius`` broadcasts over the leading dims, shape (...,) or scalar;
    must be >= 0.  Bisection on the soft-threshold tau.
    """
    radius = torch.broadcast_to(
        torch.as_tensor(radius, dtype=v.dtype, device=v.device), v.shape[:-1]
    )[..., None]
    av = torch.abs(v)
    l1 = torch.sum(av, dim=-1, keepdim=True)
    inside = l1 <= radius
    lo = torch.zeros_like(radius)
    hi = torch.amax(av, dim=-1, keepdim=True)
    for _ in range(iters):
        tau = 0.5 * (lo + hi)
        s = torch.sum(torch.clamp_min(av - tau, 0.0), dim=-1, keepdim=True)
        too_big = s > radius
        lo, hi = torch.where(too_big, tau, lo), torch.where(too_big, hi, tau)
    tau = 0.5 * (lo + hi)
    # rescale exactly onto the sphere to kill the residual bisection error
    x = torch.clamp_min(av - tau, 0.0)
    xs = torch.sum(x, dim=-1, keepdim=True)
    x = x * torch.where(xs > 0, radius / torch.clamp_min(xs, 1e-30), 0.0)
    return torch.where(inside, v, torch.sign(v) * x)


def _prox_scaled_inf(v: torch.Tensor, scale, inner_iters: int) -> torch.Tensor:
    """prox_{scale*||.||_inf}(v): clamp at the l1-waterline tau solving
    sum max(|v| - tau, 0) = scale, found by monotone Newton from below
    (s(tau) is convex piecewise linear with slope -count(|v| > tau))."""
    scale = torch.broadcast_to(
        torch.as_tensor(scale, dtype=v.dtype, device=v.device), v.shape[:-1]
    )[..., None]
    av = torch.abs(v)
    n = v.shape[-1]
    total = torch.sum(av, dim=-1, keepdim=True)
    tau = torch.clamp_min((total - scale) / n, 0.0)
    for _ in range(inner_iters):
        s = torch.sum(torch.clamp_min(av - tau, 0.0), dim=-1, keepdim=True)
        cnt = torch.clamp_min(
            torch.sum((av > tau).to(v.dtype), dim=-1, keepdim=True), 1.0
        )
        tau = tau + (s - scale) / cnt
    # scale >= ||v||_1: the l1-projection returns v itself, so the prox is 0
    clipped = torch.minimum(torch.maximum(v, -tau), tau)
    return torch.where(total <= scale, torch.zeros_like(v), clipped)


def project_sum_inf(
    t: torch.Tensor, A, outer_iters: int = 32, inner_iters: int = 8
) -> torch.Tensor:
    """Exact projection of real t (..., n) onto {h : A*||h||_inf + sum(h) <= 1}.

    ``A`` is the constraint weight 2*sqrt(MN)*sigma + sigma^2; scalar or
    batched (...,).
    """
    A = torch.broadcast_to(
        torch.as_tensor(A, dtype=t.dtype, device=t.device), t.shape[:-1]
    )

    def f_of(h):
        return A * torch.amax(torch.abs(h), dim=-1) + torch.sum(h, dim=-1)

    def h_of(mu):
        return _prox_scaled_inf(t - mu[..., None], mu * A, inner_iters)

    feasible = f_of(t) <= 1.0
    hi = torch.clamp_min(0.5 * torch.sum(t * t, dim=-1) + 1.0, 1.0)
    lo = torch.zeros_like(hi)
    for _ in range(outer_iters):
        mu = 0.5 * (lo + hi)
        viol = f_of(h_of(mu)) > 1.0
        lo, hi = torch.where(viol, mu, lo), torch.where(viol, hi, mu)
    return torch.where(feasible[..., None], t, h_of(hi))


def hermitian_eigh(M: torch.Tensor):
    """Batched eigendecomposition of (..., m, m) after Hermitian
    symmetrization, computed in double precision: cuSOLVER's single-precision
    Hermitian eigensolver failed to converge on an iterate of the anchor
    eigh solve (H100), its double-precision one does not.  Returns float64
    eigenvalues and complex128 eigenvectors."""
    Mh = 0.5 * (M + torch.conj(M.transpose(-1, -2)))
    return torch.linalg.eigh(Mh.to(torch.complex128))


def psd_project_eigh(M: torch.Tensor) -> torch.Tensor:
    """Exact projection of Hermitian (..., m, m) onto the PSD cone."""
    w, V = hermitian_eigh(M)
    w = torch.clamp_min(w, 0.0)
    P = (V * w.to(V.dtype)[..., None, :]) @ torch.conj(V.transpose(-1, -2))
    return P.to(M.dtype)


def _frobenius_scale(M: torch.Tensor) -> torch.Tensor:
    normF = torch.sqrt(torch.sum(torch.abs(M) ** 2, dim=(-1, -2), keepdim=True))
    return torch.clamp_min(normF, 1e-30).to(M.dtype)


def _matrix_abs_newton_schulz(M: torch.Tensor, iters: int) -> torch.Tensor:
    """|M| for Hermitian M via the Newton-Schulz matrix sign
    X <- 1.5 X - 0.5 X^3 on the Frobenius-scaled matrix."""
    X = M / _frobenius_scale(M)
    for _ in range(iters):
        X = 1.5 * X - 0.5 * (X @ (X @ X))
    return (X @ M + M @ X) * 0.5


def psd_project_newton_schulz(M: torch.Tensor, iters: int = 24) -> torch.Tensor:
    """Approximate PSD projection P(M) ~ (M + |M|)/2, matmul-only."""
    P = 0.5 * (M + _matrix_abs_newton_schulz(M, iters))
    return 0.5 * (P + torch.conj(P.transpose(-1, -2)))


# Greedy minimax quintic schedule for the matrix sign, fitted offline by
# per-step LP: step k applies p_k(x) = a x + b x^3 + c x^5.  Composed error
# |p(x) - 1| < 1e-9 on [1e-3, 1]; |M|-weighted error max |x (p(x)-1)| < 8e-5.
POLAR_QUINTIC_SCHEDULE = (
    (8.470329, -25.108079, 18.629279),
    (4.182834, -3.108701, 0.580607),
    (3.961857, -2.954063, 0.562976),
    (3.286584, -2.464719, 0.507358),
    (2.273748, -1.644659, 0.416191),
    (1.888716, -1.265157, 0.376519),
    (1.874984, -1.249968, 0.374983),
)

# Shortened quintic schedule at write-off floor l0=1e-2: |p-1| < 1.3e-6 on
# [1e-2, 1], |M|-weighted error 9.4e-4 on [0, 1].
POLAR_QUINTIC5_SCHEDULE = (
    (8.093369, -23.620432, 17.446153),
    (3.636586, -2.721927, 0.536546),
    (2.661300, -1.977155, 0.452616),
    (1.956172, -1.337508, 0.383853),
    (1.875144, -1.250140, 0.374996),
)

# Box-constrained two-phase schedule: steps 1-4 grow the smallest eigenvalue
# without overshoot on [0, 1.02u], steps 5-6 are minimax polish.  Exact
# arithmetic: |p-1| < 1e-5 on [3e-3, 1], p([0,1]) within [0, ~1].
POLAR_BF16_SCHEDULE = (
    (4.203834, -11.937382, 8.504934),
    (4.101730, -11.104443, 7.628472),
    (3.953683, -10.006929, 6.734898),
    (3.400460, -6.548496, 3.994283),
    (2.316193, -2.250782, 0.931482),
    (1.858068, -1.215865, 0.357804),
)

# Optional polish step, appended when hi_steps=1 is requested.
POLAR_BF16_POLISH = (1.866601, -1.233157, 0.366556)

# Shortened detection-grade schedules of the fused whole-solve kernel: the
# same two-phase fit at a larger eigenvalue write-off l0.
POLAR_BF16_SCHED3 = (  # l0=8e-2: |p-1|<1.3e-3 on [l0,1], max|x(p-1)|=1.1e-2
    (3.903078, -9.676286, 6.609491),
    (3.375574, -5.406171, 3.036886),
    (1.871320, -1.227411, 0.356540),
)
POLAR_BF16_SCHED2 = (  # l0=3e-1: |p-1|<1.4e-3 on [l0,1], max|x(p-1)|=4.2e-2
    (3.443876, -5.718143, 3.322709),
    (1.871813, -1.227907, 0.356561),
)


def _matrix_abs_polar(M: torch.Tensor, schedule=POLAR_QUINTIC_SCHEDULE) -> torch.Tensor:
    """|M| for Hermitian M via a fitted quintic sign schedule."""
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    X = M / _frobenius_scale(M)
    for a, b, c in schedule:
        X2 = X @ X
        X4 = X2 @ X2
        X = X @ (a * eye + b * X2 + c * X4)
    return (X @ M + M @ X) * 0.5


def psd_project_polar(M: torch.Tensor, schedule=POLAR_QUINTIC_SCHEDULE) -> torch.Tensor:
    """PSD projection via a minimax quintic sign schedule (complex matmuls)."""
    P = 0.5 * (M + _matrix_abs_polar(M, schedule))
    return 0.5 * (P + torch.conj(P.transpose(-1, -2)))
