"""Plain reference of the classical deployment: the fixed-budget ANM-ADMM
solve and the coarse-to-fine peak search, written from the algorithm the
configuration states, in complex64 torch operations with the one-pass
products at the tier it names (``reference.rounding``).

Per instance, with w = |b|^2 / (1 + rho |b|^2), A = 2 sqrt(n) sigma +
sigma^2 and the lifted side m = n + 1, each iteration is

  phi <- w (y / b + rho G[:n, n] + Z[:n, n])
  h   <- Proj_{A ||h||_inf + sum h <= 1} Re diag(G + Z / rho)[:n]
  M   <- [[diag h, phi], [phi^H, 1 / lambda^2]] - Z / rho
  G   <- (M + |M|) / 2,  |M| = herm(S M), S the sign schedule on M / ||M||_F
  Z   <- rho (G - M)

The projection is a bisection on the prox's multiplier with ``proj_iters``
steps of ``inner_iters`` Newton steps each, its bracket carried from one
iteration to the next (``warm_root``).  Every product of the sign schedule
and the closing |M| product is one-pass at the solve's tier, and the
iterate is re-projected onto the Hermitian matrices after each step.
The peak search evaluates |<phi, a(tau, f)>|^2 on the coarse separable
grid, keeps the ``max_peaks`` highest 8-neighbour local maxima and zooms
``refine_iters`` rounds of a P x P local grid, its two products one-pass
at the refine's tier.

Imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from gpubench.reference.rounding import cmm, rounder

BIG = 3e37  # "no bracket yet"


def _herm(X: torch.Tensor) -> torch.Tensor:
    return 0.5 * (X + torch.conj(X.transpose(-1, -2)))


def _prox_h(t, mu, A, inner_iters):
    n = t.shape[-1]
    v = t - mu
    av = torch.abs(v)
    r = mu * A
    total = torch.sum(av, dim=-1, keepdim=True)
    tau = torch.clamp_min((total - r) / n, 0.0)
    for _ in range(inner_iters):
        s = torch.sum(torch.clamp_min(av - tau, 0.0), dim=-1, keepdim=True)
        cnt = torch.clamp_min(torch.sum((av > tau).to(torch.float32), dim=-1, keepdim=True),
                              1.0)
        tau = tau + (s - r) / cnt
    h = torch.minimum(torch.maximum(v, -tau), tau)
    return torch.where(total <= r, torch.zeros_like(h), h)


def project_h(t, A, outer_iters, inner_iters, bracket):
    """(h, next bracket) of rows t (B, n) onto {A ||h||_inf + sum h <= 1}."""
    def f_of(h):
        return A * torch.amax(torch.abs(h), dim=-1, keepdim=True) + torch.sum(
            h, dim=-1, keepdim=True)

    feasible = f_of(t) <= 1.0
    glob_hi = torch.clamp_min(0.5 * torch.sum(t * t, dim=-1, keepdim=True) + 1.0, 1.0)
    lo = torch.minimum(torch.clamp_min(bracket[0], 0.0), glob_hi)
    hi = torch.minimum(torch.maximum(bracket[1], lo), glob_hi)
    for _ in range(outer_iters):
        mu = 0.5 * (lo + hi)
        viol = f_of(_prox_h(t, mu, A, inner_iters)) > 1.0
        lo, hi = torch.where(viol, mu, lo), torch.where(viol, hi, mu)
    h = torch.where(feasible, t, _prox_h(t, hi, A, inner_iters))
    w = torch.maximum(hi - lo, 0.05 * hi + 1e-2)
    lo_n = torch.where(feasible, 0.0, torch.clamp_min(lo - w, 0.0))
    hi_n = torch.where(feasible, BIG, hi + w)
    return h, (lo_n, hi_n)


def matrix_abs(M: torch.Tensor, schedule, rnd) -> torch.Tensor:
    """|M| of Hermitian M through the sign schedule, every product one-pass."""
    s = torch.sqrt(torch.sum(torch.abs(M) ** 2, dim=(-1, -2), keepdim=True))
    X = M / torch.clamp_min(s, 1e-30)
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    for a, b, c in schedule:
        X2 = cmm(X, X, rnd)
        X4 = cmm(X2, X2, rnd)
        X = _herm(cmm(X, a * eye + b * X2 + c * X4, rnd))
    return _herm(cmm(X, M, rnd))


def solve(y, b, sigma, solver: dict, tier: str) -> torch.Tensor:
    """phi (B, n) complex64 after ``solver["iters"]`` iterations."""
    rnd = rounder(tier)
    rho, lam = float(solver["rho"]), float(solver["lambda"])
    B, n = y.shape
    dev = y.device
    b_sq = torch.abs(b) ** 2
    w = (b_sq / (1.0 + rho * b_sq)).to(torch.complex64)
    yob = y / b
    A = (2.0 * math.sqrt(float(n)) * sigma + sigma**2).to(torch.float32)[:, None]
    idx = torch.arange(n, device=dev)
    G = torch.zeros((B, n + 1, n + 1), dtype=torch.complex64, device=dev)
    Z = torch.zeros_like(G)
    bracket = (torch.zeros((B, 1), device=dev), torch.full((B, 1), BIG, device=dev))
    phi = torch.zeros((B, n), dtype=torch.complex64, device=dev)
    for _ in range(int(solver["iters"])):
        phi = w * (yob + rho * G[:, :n, n] + Z[:, :n, n])
        t = torch.real(torch.diagonal(G, dim1=-2, dim2=-1)
                       + torch.diagonal(Z, dim1=-2, dim2=-1) / rho)[:, :n]
        h, bracket = project_h(t, A, solver["proj_iters"], solver["inner_iters"], bracket)
        Bm = torch.zeros_like(G)
        Bm[:, idx, idx] = h.to(torch.complex64)
        Bm[:, :n, n] = phi
        Bm[:, n, :n] = torch.conj(phi)
        Bm[:, n, n] = 1.0 / lam**2
        M = Bm - Z / rho
        G = 0.5 * (M + matrix_abs(M, solver["schedule"], rnd))
        Z = rho * (G - M)
    return phi


# ---- peak search ---------------------------------------------------------------


def steering(x: torch.Tensor, length: int) -> torch.Tensor:
    """exp(2j pi x [0..length-1]), (..., length) complex64."""
    k = torch.arange(length, dtype=torch.float32, device=x.device)
    return torch.exp(2j * math.pi * x[..., None] * k).to(torch.complex64)


def coarse_axes(pk: dict):
    taus = np.arange(pk["delay_min"], pk["delay_max"], pk["delay_step"], dtype=np.float32)
    if taus.size and abs((taus[-1] - pk["delay_min"]) % 1.0) < 1e-9:
        taus = taus[:-1]
    fs = np.arange(pk["doppler_min"], pk["doppler_max"], pk["doppler_step"], dtype=np.float32)
    return taus, fs


def find_peaks(phi: torch.Tensor, Nb: int, Nd: int, pk: dict, tier: str):
    """(tau, f, height, valid), each (B, max_peaks), sorted by height;
    padding entries have height -inf and valid False."""
    rnd = rounder(tier)
    B = phi.shape[0]
    K, P = pk["max_peaks"], pk["refine_points"]
    dev = phi.device
    taus_np, fs_np = coarse_axes(pk)
    nx = taus_np.size
    taus_ax = torch.from_numpy(taus_np).to(dev)
    fs_ax = torch.from_numpy(fs_np).to(dev)
    Phi = torch.conj(phi).reshape(B, Nb, Nd)
    Z = torch.abs(steering(fs_ax, Nb) @ Phi @ torch.conj(steering(taus_ax, Nd)).T) ** 2
    pooled = F.max_pool2d(Z[:, None], kernel_size=3, stride=1, padding=1)[:, 0]
    scores = torch.where(Z >= pooled, Z, -torch.inf).reshape(B, -1)
    vals, idx = torch.topk(scores, K, dim=-1)
    valid = torch.isfinite(vals)
    tau = torch.where(valid, taus_ax[idx % nx], pk["delay_min"])
    f = torch.where(valid, fs_ax[idx // nx], pk["doppler_min"])
    rel = torch.linspace(-1.0, 1.0, P, dtype=torch.float32, device=dev)
    half_t, half_f = pk["delay_step"], pk["doppler_step"]
    Phi4 = Phi[:, None]
    height = None
    for _ in range(pk["refine_iters"]):
        taus = torch.clamp(tau[..., None] + half_t * rel, pk["delay_min"], pk["delay_max"] - 1e-6)
        fs = torch.clamp(f[..., None] + half_f * rel, pk["doppler_min"],
                         pk["doppler_max"] - 1e-6)
        SPhi = cmm(steering(fs, Nb), Phi4, rnd)
        Zl = torch.abs(cmm(SPhi, torch.conj(steering(taus, Nd)).transpose(-1, -2), rnd)) ** 2
        flat = Zl.reshape(B, K, P * P)
        i = torch.argmax(flat, dim=-1)
        height = torch.gather(flat, -1, i[..., None])[..., 0]
        f = torch.gather(fs, -1, (i // P)[..., None])[..., 0]
        tau = torch.gather(taus, -1, (i % P)[..., None])[..., 0]
        half_t *= pk["reduce_factor"]
        half_f *= pk["reduce_factor"]
    height = torch.where(valid, height, -torch.inf)
    order = torch.argsort(-height, dim=-1, stable=True)
    return tuple(torch.gather(x, -1, order) for x in (tau, f, height, valid))


def spectrum_at(phi: torch.Tensor, tau: torch.Tensor, f: torch.Tensor, Nb: int,
                Nd: int) -> torch.Tensor:
    """|<phi, a(tau, f)>|^2 in float64 at points tau, f (B, K)."""
    phi = phi.to(torch.complex128).reshape(phi.shape[0], 1, Nb, Nd)
    m = torch.arange(Nb, dtype=torch.float64, device=phi.device)
    k = torch.arange(Nd, dtype=torch.float64, device=phi.device)
    s = torch.exp(2j * math.pi * f.to(torch.float64)[..., None] * m)  # (B, K, Nb)
    dc = torch.exp(-2j * math.pi * tau.to(torch.float64)[..., None] * k)  # (B, K, Nd)
    t = torch.einsum("bmd,bkd->bkm", torch.conj(phi)[:, 0], dc)
    return torch.abs(torch.sum(s * t, dim=-1)) ** 2


def run_solve(y, b, sigma, config: dict, tier: str, block: int = 2048) -> torch.Tensor:
    """The reference (or, at a lower tier, the control) solve over rows in
    blocks: phi."""
    return torch.cat([solve(y[s:s + block], b[s:s + block], sigma[s:s + block],
                            config["solver"], tier) for s in range(0, y.shape[0], block)])


def run_peaks(phi, config: dict, tier: str, block: int = 8192):
    """The reference (or control) peak search over rows in blocks."""
    spec = config["spec"]
    out = [find_peaks(phi[s:s + block], spec["Nb"], spec["Nd"], config["peaks"], tier)
           for s in range(0, phi.shape[0], block)]
    return tuple(torch.cat(p) for p in zip(*out))


def phi_gaps(phi, phi_ref):
    """Per scene: ||phi - phi_ref|| over the larger of ||phi_ref|| and the
    median scene's, so that a scene whose phi is all but zero is not read
    as a relative error of order one."""
    norms = torch.linalg.vector_norm(phi_ref, dim=-1)
    scale = torch.clamp_min(torch.maximum(norms, torch.median(norms)), 1e-30)
    return (torch.linalg.vector_norm(phi.to(phi_ref.device) - phi_ref, dim=-1) / scale).to(
        torch.float64)


def peak_gaps(phi, peaks, peaks_ref, Nb: int, Nd: int, radius: float):
    """Per scene: the peak list's widest gap from the reference search's on
    the same phi, relative to the larger of the reference's highest peak
    and the median scene's:

    - every reported peak is real: its height against the spectrum of phi
      at its point (float64);
    - no reference peak above the list's cut-off is missed: each reference
      peak's height against the highest spectrum at a reported point
      within ``radius`` of it, or against the list's lowest height when
      the list is full (a peak below it was cut, as the reference would
      cut it).

    A near tie in the coarse grid may give one list two points on one peak
    or swap the peaks of two ranks; neither reads as a gap."""
    tau, f, h, valid = (x.to(phi.device) for x in peaks)
    tau_r, f_r, h_r, valid_r = peaks_ref
    z = torch.where(valid, spectrum_at(phi, tau, f, Nb, Nd), 0.0)
    hp = torch.where(valid, h.to(torch.float64), 0.0)
    hr = torch.where(valid_r, h_r.to(torch.float64), 0.0)
    top = torch.clamp_min(torch.maximum(hr[:, 0], torch.median(hr[:, 0])), 1e-30)
    real = torch.amax(torch.abs(hp - z), dim=-1)
    dist = torch.maximum(torch.abs(tau[:, :, None] - tau_r[:, None, :]),
                         torch.abs(f[:, :, None] - f_r[:, None, :]))  # (B, K, K')
    near = (dist < radius) & valid[:, :, None]
    z_near = torch.amax(torch.where(near, z[:, :, None], 0.0), dim=1)  # (B, K')
    cutoff = torch.where(valid.all(dim=-1), hp[:, -1], 0.0)[:, None]
    miss = torch.amax(torch.clamp_min(hr - torch.maximum(z_near, cutoff), 0.0), dim=-1)
    return torch.maximum(real, miss) / top
