"""Peak-detection scoring: precision/recall/F1 and localization RMSE.

Host-side numpy (evaluation, not a device hot path): the JAX package's
module unchanged.  The detection protocol generalizes the reference's
count-based statistics (train.py:381-392) to a location-aware greedy
matching: a prediction is a true positive only if it falls within tolerance
of an unmatched ground-truth target.  The reference's count-only variant is
available via ``tol=None``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def phi_nmse(phi_hat, phi_ref) -> float:
    """||phi_hat - phi_ref||^2 / ||phi_ref||^2 over all elements."""
    phi_hat = np.asarray(phi_hat)
    phi_ref = np.asarray(phi_ref)
    return float(
        np.sum(np.abs(phi_hat - phi_ref) ** 2) / np.sum(np.abs(phi_ref) ** 2)
    )


def scale_invariant_nmse(phi_hat, phi_ref) -> float:
    """min_c ||c*phi_hat - phi_ref||^2 / ||phi_ref||^2 (peak positions are
    invariant to complex scaling of phi, so this is the fair spectrum
    comparison).

    Accumulates in float64: the ``1 - |ip|^2/(na*nb)`` subtraction saturates
    to exactly 0.0 below ~1e-7 in complex64, which overstated near-exact
    agreement (e.g. the polar-vs-eigh pin is ~1.5e-6, not 0)."""
    a = np.asarray(phi_hat).ravel().astype(np.complex128)
    b = np.asarray(phi_ref).ravel().astype(np.complex128)
    ip = np.vdot(a, b)
    na = np.vdot(a, a).real
    nb = np.vdot(b, b).real
    if na == 0:
        return 1.0
    return float(1.0 - np.abs(ip) ** 2 / (na * nb))


def match_peaks(
    pred_tau,
    pred_f,
    true_tau,
    true_f,
    tol_tau: Optional[float] = 0.05,
    tol_f: Optional[float] = 0.05,
    pred_valid=None,
) -> Dict[str, float]:
    """Greedy location-aware matching over a batch.

    pred_*: (B, K) predictions sorted by confidence/height desc;
    true_*: (B, L) ground truth;
    pred_valid: optional (B, K) bool mask of real predictions.

    Returns dict with precision/recall/f1/tp/fp/fn/tau_rmse/f_rmse (RMSE over
    matched pairs).
    """
    pred_tau = np.atleast_2d(np.asarray(pred_tau))
    pred_f = np.atleast_2d(np.asarray(pred_f))
    true_tau = np.atleast_2d(np.asarray(true_tau))
    true_f = np.atleast_2d(np.asarray(true_f))
    if pred_valid is None:
        pred_valid = np.ones(pred_tau.shape, bool)
    pred_valid = np.atleast_2d(np.asarray(pred_valid))

    tp = fp = fn = 0
    tau_err2, f_err2 = [], []
    for i in range(pred_tau.shape[0]):
        preds = [
            (pred_tau[i, j], pred_f[i, j])
            for j in range(pred_tau.shape[1])
            if pred_valid[i, j]
        ]
        used = np.zeros(len(preds), bool)
        for l in range(true_tau.shape[1]):
            tt, tf = true_tau[i, l], true_f[i, l]
            best, best_d = -1, np.inf
            for j, (pt, pf) in enumerate(preds):
                if used[j]:
                    continue
                dt, df = abs(pt - tt), abs(pf - tf)
                if tol_tau is not None and (dt > tol_tau or df > tol_f):
                    continue
                d = dt**2 + df**2
                if d < best_d:
                    best, best_d = j, d
            if best >= 0:
                used[best] = True
                tp += 1
                tau_err2.append((preds[best][0] - tt) ** 2)
                f_err2.append((preds[best][1] - tf) ** 2)
            else:
                fn += 1
        fp += int(np.sum(~used))

    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    f1 = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
    return {
        "tp": tp,
        "fp": fp,
        "fn": fn,
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "tau_rmse": float(np.sqrt(np.mean(tau_err2))) if tau_err2 else float("nan"),
        "f_rmse": float(np.sqrt(np.mean(f_err2))) if f_err2 else float("nan"),
    }
