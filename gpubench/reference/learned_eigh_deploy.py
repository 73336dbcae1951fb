"""Plain reference of upstream's published ADMM-Net deployment: ten unrolled
layers whose G step is an exact Hermitian eigendecomposition, and the
cross-attention peak head, written from the network's equations, with the
weights given as a state_dict (``gpubench.attention_weights``), in
complex64 torch operations with TF32 off.

Per depth k the Phi, H and Z steps are those of ``reference.learned_deploy``
(the same equations, written out again here with the eigh G step), and

  G: M = herm([[diag h, phi], [phi^H, 1 / (lambda^2 + eps)]] - Z / (rho + eps)),
     M = V diag(w) V^H (``torch.linalg.eigh`` in complex128), V detached,
     G = herm(V diag(f(w)) V^H), f(w) = softplus(w - sigmoid(thr))
     sigmoid(MLP(|w|)) on the float32 eigenvalues, the rebuild a float32
     product;

the last depth runs its Phi step only, and the ZLayer's mean is over the
whole batch.  The head: x = [Re phi, Im phi] through two relu Dense layers;
the learnable (tau, f) grid projected by a Dense layer gives the keys and
values of one query x, in 4 heads of hidden / 4: logits q . k / sqrt(hidden
/ 4), a softmax over the grid, the heads' outputs concatenated and
projected; x plus that through three relu Dense layers (hidden to hidden /
8); per target t, feat = x + t / L_max, tau = sigmoid(MLP_t(feat)), f =
tanh(MLP'_t(feat)), conf = sigmoid(MLP_conf(feat)) with the confidence MLP
shared.

The eigensolves (9 a depth's batch) run on the host's LAPACK in complex128,
in blocks of ``EIGH_BLOCK`` matrices over a pool of threads, one LAPACK
thread each: on the card, ``torch.linalg.eigh`` of a batch of sides above 32
solves one matrix at a time.  Tiers, by the names a configuration gives
them (``reference.rounding``): ``eigh`` rounds M's operands before the
solve, ``rebuild`` the rebuild's, ``head`` every product of the head.

``fault`` plants one of the faults the comparison must catch, in the
reference's place of the program: ``"eigenvalues_reversed"`` (the filter
applied to the eigenvalues in the other order), ``"v_unconjugated"`` (G =
V diag(f(w)) V^T) or ``"softmax_heads"`` (the attention's softmax over the
heads instead of the grid).

Imports nothing of the program.
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor

import torch

from gpubench.reference.learned_deploy import corner, dense, herm, lifted, softplus
from gpubench.reference.rounding import cmm, round_complex, rounder

EIGH_BLOCK = 64  # matrices a LAPACK call


def _eigh_block(H):
    return torch.linalg.eigh(H)


def eigh_c128(M: torch.Tensor):
    """(w float64, V complex128) of the Hermitian (B, m, m) M, on the host."""
    H = M.detach().to("cpu").to(torch.complex128)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
            parts = list(pool.map(_eigh_block, torch.split(H, EIGH_BLOCK)))
    finally:
        torch.set_num_threads(threads)
    return torch.cat([w for w, _ in parts]), torch.cat([V for _, V in parts])


def glayer(p, k, phi, h, Z, model, tiers: dict, fault=None):
    eps = model["epsilon"]
    pre = f"trunk.g_{k}."
    rho = softplus(p[pre + "rho"])
    M = herm(lifted(h, phi, corner(p, pre, model)) - Z / (rho + eps))
    w, V = eigh_c128(round_complex(M, rounder(tiers["eigh"])))
    w = w.to(torch.float32).to(M.device)
    V = V.to(torch.complex64).to(M.device)
    if fault == "eigenvalues_reversed":
        w = torch.flip(w, dims=(-1,))
    s = torch.relu(dense(p, pre + "value_hidden", torch.abs(w)[..., None]))
    s = torch.sigmoid(dense(p, pre + "value_out", s))[..., 0]
    fw = softplus(w - torch.sigmoid(p[pre + "threshold"])) * s
    Vh = V.transpose(-1, -2) if fault == "v_unconjugated" else torch.conj(V.transpose(-1, -2))
    return herm(cmm(V * fw.to(torch.complex64)[..., None, :], Vh, rounder(tiers["rebuild"])))


def trunk(y, b, sigma, p, config: dict, tiers: dict, fault=None):
    """phi (B, n) of the trunk at ``tiers`` (``eigh``, ``rebuild``)."""
    model = config["model"]
    eps = model["epsilon"]
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
        G = glayer(p, k, phi, h, Z, model, tiers, fault)
        pre = f"trunk.z_{k}."
        rho_z = softplus(p[pre + "rho"])
        R = G - lifted(h, phi, corner(p, pre, model))
        res = torch.sqrt(torch.sum(torch.abs(R) ** 2, dim=(-1, -2)))
        feats = torch.stack([torch.full_like(res, k / 10.0), torch.broadcast_to(rho_z, res.shape),
                             res / (torch.mean(res) + eps)], dim=-1)
        s = torch.sigmoid(dense(p, pre + "scale_out",
                                torch.relu(dense(p, pre + "scale_hidden", feats))))[..., 0]
        Z = Z + (rho_z * (0.5 + 1.5 * s)).to(torch.complex64)[:, None, None] * R
    return phi


def _mm(a, b, rnd):
    return a @ b if rnd is None else rnd(a.contiguous()) @ rnd(b.contiguous())


def _dense(p, name, x, rnd):
    return _mm(x, p[name + ".weight"].T, rnd) + p[name + ".bias"]


def head(phi, p, config: dict, tier: str, fault=None):
    """(tau, f, conf), each (B, L_max), of the attention head."""
    model, spec = config["model"], config["spec"]
    rnd = rounder(tier)
    L = spec["L_max"]
    H = model["num_heads"]
    pre = "peak_head."
    x = torch.cat([phi.real, phi.imag], dim=-1)
    x = torch.relu(_dense(p, pre + "feat1", x, rnd))
    x = torch.relu(_dense(p, pre + "feat2", x, rnd))
    pos = _dense(p, pre + "position_projection", p[pre + "position_grid"], rnd)  # (n, hidden)
    B, hidden = x.shape
    D = hidden // H
    q = _dense(p, pre + "attention.query", x, rnd).reshape(B, H, D) / math.sqrt(D)
    k = _dense(p, pre + "attention.key", pos, rnd).reshape(-1, H, D).permute(1, 2, 0)
    v = _dense(p, pre + "attention.value", pos, rnd).reshape(-1, H, D).permute(1, 0, 2)
    logits = _mm(q.permute(1, 0, 2), k, rnd)  # (H, B, n)
    wts = torch.softmax(logits, dim=0 if fault == "softmax_heads" else -1)
    o = _mm(wts, v, rnd).permute(1, 0, 2).reshape(B, hidden)  # (B, H * D)
    x = x + _dense(p, pre + "attention.out", o, rnd)
    for i in range(3):
        x = torch.relu(_dense(p, pre + f"peak{i}", x, rnd))
    taus, fs, confs = [], [], []
    for t in range(L):
        feat = x + t / L
        taus.append(torch.sigmoid(_dense(p, pre + f"tau{t}_out", torch.relu(
            _dense(p, pre + f"tau{t}_hidden", feat, rnd)), rnd)))
        fs.append(torch.tanh(_dense(p, pre + f"f{t}_out", torch.relu(
            _dense(p, pre + f"f{t}_hidden", feat, rnd)), rnd)))
        confs.append(torch.sigmoid(_dense(p, pre + "conf_out", torch.relu(
            _dense(p, pre + "conf_hidden", feat, rnd)), rnd)))
    return torch.cat(taus, dim=-1), torch.cat(fs, dim=-1), torch.cat(confs, dim=-1)
