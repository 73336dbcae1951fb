"""Plain reference of the learned deployment: ADMM-Net's unrolled trunk and
its spectrum peak head, written from the network's equations, with the
weights given as a state_dict (``gpubench.weights``), in complex64 torch
operations; the Chebyshev GLayer's Clenshaw products one-pass at the tier
the configuration names (``reference.rounding``).

Per depth k (G = Z = 0 at the start, eps the configuration's epsilon):

  Phi: phi = w (y / (b + eps) + rho g + zeta), w = (|b|^2 + eps) /
       (1 + rho (|b|^2 + eps)), g, zeta the last columns of G and Z
  H:   t = Re diag(G + Z / (rho + eps))[:n], t' = t + 0.1 tanh(MLP(t)),
       h = t' min(1, sigmoid(w_p) / (A ||t'||_inf + sum t' + eps))
  G:   M = herm([[diag h, phi], [phi^H, 1 / (lambda^2 + eps)]] - Z / (rho + eps)),
       G = herm(r sum_j c_j T_j(M / r)), r = ||M||_F, c the Chebyshev
       coefficients of x -> f(r x) / r, f(w) = softplus(w - sigmoid(thr))
       sigmoid(MLP(|w|)), evaluated by Clenshaw
  Z:   R = G - [[diag h, phi], [phi^H, 1 / (lambda^2 + eps)]],
       Z = Z + rho (0.5 + 1.5 sigmoid(MLP(k / 10, rho, ||R|| / mean ||R||))) R

with rho, lambda = softplus of each layer's parameters; the last depth runs
its Phi step only.  The ZLayer's mean is over the whole batch.  The head
evaluates |<phi, a(tau, f)>|^2 on the coarse grid, takes the L_max highest
cells among the local maxima (the others demoted by twice the maximum),
zooms with hard-argmax rounds, finishes with a soft-argmax and rates each
peak from scale-invariant statistics.

Imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from gpubench.reference.classical_deploy import phi_gaps
from gpubench.reference.rounding import cmm, rounder

CLENSHAW_BLOCK = 1024  # matrices per Clenshaw block


def softplus(x):
    return torch.log1p(torch.exp(-torch.abs(x))) + torch.relu(x)


def dense(p, name, x):
    return x @ p[name + ".weight"].T + p[name + ".bias"]


def herm(X):
    return 0.5 * (X + torch.conj(X.transpose(-1, -2)))


def lifted(h, phi, c):
    B, n = phi.shape
    out = torch.zeros((B, n + 1, n + 1), dtype=torch.complex64, device=phi.device)
    idx = torch.arange(n, device=phi.device)
    out[:, idx, idx] = h.to(torch.complex64)
    out[:, :n, n] = phi
    out[:, n, :n] = torch.conj(phi)
    out[:, n, n] = c.to(torch.complex64)
    return out


def chebyshev_coefficients(r, f, degree: int):
    """(B, degree) coefficients of x -> f(r x) / r (c_0 halved), r (B,)."""
    j = np.arange(degree)
    x = torch.from_numpy(np.cos(np.pi * (j + 0.5) / degree)).to(torch.float32).to(r.device)
    C = (2.0 / degree) * np.cos(np.arange(degree)[:, None] * np.pi * (j + 0.5) / degree)
    C[0] *= 0.5
    C = torch.from_numpy(C.astype(np.float32)).to(r.device)
    g = f(r[:, None] * x) / r[:, None]
    return g @ C.T


def clenshaw(A, c, rnd):
    """herm(sum_j c_j T_j(A)) by Clenshaw, A (B, m, m), c (B, degree)."""
    degree = c.shape[-1]
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    b1 = torch.zeros_like(A)
    b2 = torch.zeros_like(A)
    for j in range(degree - 1, 0, -1):
        b0 = herm(c[:, j, None, None] * eye + 2.0 * cmm(A, b1, rnd) - b2)
        b1, b2 = b0, b1
    return herm(c[:, 0, None, None] * eye + cmm(A, b1, rnd) - b2)


def corner(p, pre, model):
    """1 / (lambda^2 + eps) of a layer, its gradient stopped under
    ``ref_stop_gradients``."""
    lam_inv = 1.0 / (softplus(p[pre + "lambda"]) ** 2 + model["epsilon"])
    return lam_inv.detach() if model["ref_stop_gradients"] else lam_inv


def glayer(p, k, phi, h, Z, model, rnd, g_hook=None):
    eps = model["epsilon"]
    pre = f"trunk.g_{k}."
    rho = softplus(p[pre + "rho"])
    M = herm(lifted(h, phi, corner(p, pre, model)) - Z / (rho + eps))

    def filt(w):
        s = torch.relu(dense(p, pre + "value_hidden", torch.abs(w)[..., None]))
        s = torch.sigmoid(dense(p, pre + "value_out", s))[..., 0]
        return softplus(w - torch.sigmoid(p[pre + "threshold"])) * s

    out = []
    for s in range(0, M.shape[0], CLENSHAW_BLOCK):
        Mb = M[s:s + CLENSHAW_BLOCK]
        r = torch.clamp_min(torch.sqrt(torch.sum(torch.abs(Mb) ** 2, dim=(-1, -2))), 1e-20)
        c = chebyshev_coefficients(r, filt, model["cheb_degree"])
        cl = clenshaw(Mb / r[:, None, None], c, rnd)
        if g_hook is not None:
            cl = g_hook(cl)
        out.append(herm(cl * r[:, None, None]))
    return torch.cat(out)


def trunk(y, b, sigma, p, config: dict, cheb_tier: str, rnd=None, g_hook=None):
    """phi (B, n) of the trunk; ``rnd`` (a rounding function) overrides
    the tier's, as the training reference's straight-through one does;
    ``g_hook`` is applied to each Clenshaw evaluation's output (a planted
    fault of its backward)."""
    model = config["model"]
    eps = model["epsilon"]
    rnd = rnd or rounder(cheb_tier)
    B, n = y.shape
    G = torch.zeros((B, n + 1, n + 1), dtype=torch.complex64, device=y.device)
    Z = torch.zeros_like(G)
    phi = None
    for k in range(model["num_layers"]):
        rho = softplus(p[f"trunk.phi_{k}.rho"])
        b_sq = torch.abs(b) ** 2 + eps
        w = (b_sq / (1.0 + rho * b_sq)).to(torch.complex64)
        phi = w * (y / (b + eps) + rho * G[:, :n, n] + Z[:, :n, n])
        if k == model["num_layers"] - 1:
            break
        pre = f"trunk.h_{k}."
        rho_h = softplus(p[pre + "rho"])
        t = torch.diagonal(G[:, :n, :n] + Z[:, :n, :n] / (rho_h + eps), dim1=-2, dim2=-1).real
        A = 2.0 * math.sqrt(float(n)) * sigma + sigma**2
        t = t + 0.1 * torch.tanh(dense(p, pre + "correction_out",
                                       torch.relu(dense(p, pre + "correction_hidden", t))))
        constraint = A * torch.amax(torch.abs(t), dim=-1) + torch.sum(t, dim=-1)
        scale = torch.clamp(torch.sigmoid(p[pre + "projection_weight"]) / (constraint + eps),
                            max=1.0)
        h = t * scale[:, None]
        G = glayer(p, k, phi, h, Z, model, rnd, g_hook)
        pre = f"trunk.z_{k}."
        rho_z = softplus(p[pre + "rho"])
        R = G - lifted(h, phi, corner(p, pre, model))
        res = torch.sqrt(torch.sum(torch.abs(R) ** 2, dim=(-1, -2)))
        rho_feat = torch.broadcast_to(rho_z, res.shape)
        if model["ref_stop_gradients"]:
            rho_feat = rho_feat.detach()
        feats = torch.stack([torch.full_like(res, k / 10.0), rho_feat,
                             res / (torch.mean(res) + eps)], dim=-1)
        s = torch.sigmoid(dense(p, pre + "scale_out",
                                torch.relu(dense(p, pre + "scale_hidden", feats))))[..., 0]
        Z = Z + (rho_z * (0.5 + 1.5 * s)).to(torch.complex64)[:, None, None] * R
    return phi


def steering(x, length):
    k = torch.arange(length, dtype=torch.float32, device=x.device)
    return torch.exp(2j * math.pi * x[..., None] * k).to(torch.complex64)


def head(phi, p, config: dict, tier: str):
    """(tau, f, conf), each (B, L_max)."""
    model, spec = config["model"], config["spec"]
    rnd = rounder(tier)
    M, N, K = spec["Nb"], spec["Nd"], spec["L_max"]
    P, step = model["head_refine_points"], model["head_grid_step"]
    B, n = phi.shape
    dev = phi.device
    taus = np.arange(0.0, 1.0, step, dtype=np.float32)
    if taus.size and abs(taus[-1] % 1.0) < 1e-9:
        taus = taus[:-1]
    taus_ax = torch.from_numpy(taus).to(dev)
    fs_ax = torch.from_numpy(np.arange(-0.5, 0.5, step, dtype=np.float32)).to(dev)
    nx = taus_ax.numel()
    Phi = torch.conj(phi).reshape(B, M, N)
    Z = torch.abs(cmm(cmm(steering(fs_ax, M).expand(B, -1, -1), Phi, rnd),
                      torch.conj(steering(taus_ax, N)).T.expand(B, -1, -1), rnd)) ** 2
    zmax = torch.amax(Z, dim=(-2, -1), keepdim=True)
    pooled = F.max_pool2d(Z[:, None], kernel_size=3, stride=1, padding=1)[:, 0]
    idx = torch.topk(torch.where(Z >= pooled, Z, Z - 2.0 * zmax).reshape(B, -1), K, dim=-1).indices
    tau, f = taus_ax[idx % nx], fs_ax[idx // nx]
    Phi4 = Phi[:, None]
    rel = torch.linspace(-1.0, 1.0, P, dtype=torch.float32, device=dev)
    half = step
    height = None
    rounds = model["head_refine_rounds"]
    for r in range(rounds):
        ts = torch.clamp(tau[..., None] + half * rel, 0.0, 1.0 - 1e-6)
        fs = torch.clamp(f[..., None] + half * rel, -0.5, 0.5 - 1e-6)
        flat = (torch.abs(cmm(cmm(steering(fs, M), Phi4, rnd),
                              torch.conj(steering(ts, N)).transpose(-1, -2), rnd)) ** 2
                ).reshape(B, K, P * P)
        if r < rounds - 1:
            i = torch.argmax(flat, dim=-1, keepdim=True)
            f = torch.gather(fs, -1, i // P)[..., 0]
            tau = torch.gather(ts, -1, i % P)[..., 0]
        else:
            norm = torch.amax(flat, dim=-1, keepdim=True).detach()
            w = torch.softmax(softplus(p["peak_head.softargmax_beta"]) * flat / (norm + 1e-20),
                              dim=-1)
            wg = w.reshape(B, K, P, P)
            f = torch.sum(torch.sum(wg, dim=-1) * fs, dim=-1)
            tau = torch.sum(torch.sum(wg, dim=-2) * ts, dim=-1)
            height = torch.sum(w * flat, dim=-1)
        half *= model["head_reduce_factor"]
    e = torch.sum(torch.abs(phi) ** 2, dim=-1, keepdim=True)
    h_rel = height / (e * n + 1e-20)
    h_top = height / (height[..., :1] + 1e-20)
    rank = torch.broadcast_to(torch.arange(K, dtype=torch.float32, device=dev) / K, height.shape)
    feats = torch.stack([h_rel, torch.sqrt(h_rel + 1e-20), h_top, rank], dim=-1)
    conf = torch.sigmoid(dense(p, "peak_head.conf_out",
                               torch.relu(dense(p, "peak_head.conf_hidden", feats))))[..., 0]
    return tau, f, conf


def gaps(phi, out, phi_ref, out_ref):
    """Per scene: phi's distance from the reference trunk's (``phi_gaps``), and
    the head's widest gap in tau, f or confidence from the reference head's
    on the same phi."""
    phi_gap = phi_gaps(phi, phi_ref)
    head_gap = torch.stack([torch.amax(torch.abs(a.to(phi.device) - r), dim=-1)
                            for a, r in zip(out, out_ref)]).amax(0)
    return phi_gap, head_gap.to(torch.float64)
