"""Numpy reimplementation of the REFERENCE solver's exact semantics.

Not part of the device compute path: this is the golden oracle the solver's
ref-compat mode is tested against (complex128, explicit matrix inverses, a
deliberately different code path from solver/admm.py).  The JAX package's
module unchanged (numpy / scipy only).

Reference semantics captured (all verified against reference admm.py):

1. phi-update (admm.py:77-79): ``np.linalg.inv(np.diag(b*conj(b))) +
   rho*np.ones(n)`` BROADCASTS the vector over the matrix, i.e. the solve
   matrix is ``D^{-1} + rho*ones((n,n))`` = D^{-1} + rho*11^T, not
   D^{-1} + rho*I.  ``phi_mode="dense"`` reproduces this; ``"diag"`` is the
   intended update (what the learned PhiLayer implements,
   admm_net.py:94-103).

2. G-update (admm.py:151-179): SVD, zero negative singular values, rebuild.
   For a Hermitian input M = U diag(w) U^H the SVD is (U, |w|, sign(w)U^H);
   singular values are never negative, so the step reconstructs M exactly --
   the reference never projects onto the PSD cone.  ``g_svd_update``
   implements the literal SVD recipe so tests can confirm the identity.

3. H-update (admm.py:117-148): projection of Re diag(G_hat + Z_hat/rho) onto
   {h: A||h||_inf + sum(h) <= 1} (ECOS in the reference).  On the reference
   trajectory the input is always the zero vector (G_hat's diagonal is
   H_{k-1} which stays 0, Z stays 0 -- consequences of quirk 2), and the
   projection of 0 is 0.  For generality the oracle falls back to a scipy
   QP when the input is nonzero.

4. Stopping (admm.py:94-112): checked only for iter > 1 and, with the
   min-iter guard (admm.py:6,95-96), iter >= min_iter.  On the degenerate
   trajectory both residuals are exactly 0, so the solver always exits at
   ``min_iter`` (5) when the guard is on.
"""

from __future__ import annotations

import numpy as np


def g_svd_update(H, phi, lambda_val, Z, rho):
    """Literal SVD-based G step (reference admm.py:151-179 semantics)."""
    n = H.shape[0]
    M = np.zeros((n + 1, n + 1), dtype=complex)
    M[:n, :n] = H
    M[:n, n] = phi
    M[n, :n] = np.conj(phi)
    M[n, n] = 1.0 / (lambda_val**2)
    M = M - Z / rho
    U, s, Vh = np.linalg.svd(M)
    s = np.where(s < 0, 0.0, s)  # no-op for any matrix; kept for fidelity
    return (U * s[None, :]) @ Vh


def h_projection(t, A):
    """Projection onto {h: A*||h||_inf + sum(h) <= 1} (oracle path)."""
    if A * np.max(np.abs(t), initial=0.0) + np.sum(t) <= 1.0:
        return t.copy()
    from scipy.optimize import LinearConstraint, minimize

    n = t.shape[0]
    I = np.eye(n)
    ones = np.ones((n, 1))
    Amat = np.vstack(
        [
            np.hstack([-I, ones]),
            np.hstack([I, ones]),
            np.hstack([-np.ones((1, n)), -A * np.ones((1, 1))]),
        ]
    )
    cons = LinearConstraint(
        Amat,
        np.concatenate([np.zeros(2 * n), [-1.0]]),
        np.full(2 * n + 1, np.inf),
    )
    res = minimize(
        lambda x: 0.5 * np.sum((x[:n] - t) ** 2),
        np.zeros(n + 1),
        jac=lambda x: np.concatenate([x[:n] - t, [0.0]]),
        constraints=[cons],
        method="trust-constr",
        options={"maxiter": 2000},
    )
    return res.x[:n]


def reference_admm(
    y,
    b,
    lambda_val=1.0,
    sigma=1.0,
    rho=1.0,
    max_iter=100,
    eta_abs=1e-7,
    eta_rel=1e-7,
    use_min_iter=True,
    min_iter=5,
    phi_mode="dense",
):
    """Run the reference algorithm's exact semantics in float64 numpy.

    Returns (phi, iter_count).  ``phi_mode``: "dense" reproduces the
    admm.py:78 broadcast; "diag" is the intended diagonal solve.
    """
    y = np.asarray(y, complex).ravel()
    b = np.asarray(b, complex).ravel()
    n = y.shape[0]
    A = 2.0 * np.sqrt(n) * sigma + sigma**2

    G = np.zeros((n + 1, n + 1), dtype=complex)
    Z = np.zeros((n + 1, n + 1), dtype=complex)
    h = np.zeros(n)
    phi = np.zeros(n, dtype=complex)

    if phi_mode == "dense":
        solve_mat = np.linalg.inv(np.diag(1.0 / (b * np.conj(b))) + rho * np.ones((n, n)))
    else:
        solve_mat = np.diag((b * np.conj(b)) / (1.0 + rho * b * np.conj(b)))

    iter_count = 0
    for iter_count in range(1, max_iter + 1):
        h_prev = h.copy()
        g = G[:n, n]
        zeta = Z[:n, n]

        phi = solve_mat @ (y / b + rho * g + zeta)

        t = np.real(np.diag(G[:n, :n] + Z[:n, :n] / rho))
        h = h_projection(t, A)

        G = g_svd_update(np.diag(h), phi, lambda_val, Z, rho)

        B = np.zeros((n + 1, n + 1), dtype=complex)
        B[:n, :n] = np.diag(h)
        B[:n, n] = phi
        B[n, :n] = np.conj(phi)
        B[n, n] = 1.0 / (lambda_val**2)
        Z = Z + rho * (G - B)

        if use_min_iter and iter_count < min_iter:
            continue
        if iter_count > 1:
            eta_pri = eta_abs * np.sqrt(n + 1.0) + eta_rel * max(
                np.linalg.norm(G, "fro"), np.linalg.norm(B, "fro")
            )
            eta_dual = eta_abs * np.sqrt(n) + eta_rel * np.linalg.norm(Z, "fro")
            r_pri = np.linalg.norm(G - B, "fro")
            r_dual = np.linalg.norm(rho * np.diag(h - h_prev), "fro")
            if r_pri <= eta_pri and r_dual <= eta_dual:
                break
    return phi, iter_count
