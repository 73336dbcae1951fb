"""Plain reference of upstream's training step for its published ADMM-Net
(E-J408/admm-net ``train.py:13-450``): ``ADMMNet`` (``admm_net.py:724-816``)
under autograd, ``BasicANMLoss`` (``loss.py:33-60``) with slot pairing,
the gradient clipped to global norm 1 and AdamW in two parameter groups
under cosine warm restarts, in float32 torch operations with TF32 off,
written from the recipe the configuration states.

- trunk: ``reference.learned_eigh_deploy``'s equations.  Each GLayer's
  eigendecomposition is that module's ``eigh_c128`` (complex128 LAPACK on
  the host, cast back to float32 w and complex64 V); V is detached, so the
  gradient reaches M through the eigenvalues alone: M_bar = V diag(w_bar)
  V^H, ``torch.linalg.eigh``'s backward when V carries none
  (``admm_net.py:301-308``);
- head: the deploy reference's attention head in training mode: the
  attention weights through dropout at rate 0.1, one keep mask over the
  grid shared by the batch and the heads (``u < 0.9``, u = ``torch.rand``
  of the grid's size from a generator seeded with ``dropout_seed`` on the
  batch's device, one draw a step), the kept weights scaled by 1 / 0.9;
- loss: slot i pairs with target i: the batch mean of mse(tau) + mse(f) +
  0.1 mse(conf, 1) over the real targets (sum conf^2 where there are
  none), plus 1e-4 mean ||phi||;
- clip and AdamW (betas 0.9, 0.999, eps 1e-8, decoupled weight decay, the
  trunk's parameters at ``admm_lr_scale`` times the rate): as
  ``reference.learned_train``; a parameter the loss misses gets a zero
  gradient.

Departures from upstream, each the port's documented choice: the
eigensolve in complex128, rounded to complex64, where upstream's
``torch.linalg.eigh`` runs in its input's complex64; the dropout mask is
flax's (the JAX package's head: one mask over the grid), where upstream's
``nn.MultiheadAttention`` drops each weight on its own; the rate follows
the cosine at every update (``learned_train.sgdr``, optax's schedule),
where upstream steps torch's ``CosineAnnealingWarmRestarts`` (T_0 = 10,
T_mult = 2).

Tiers, by the names a configuration gives them (``reference.rounding``):
``eigh`` rounds M's operands before the solve, ``rebuild`` the rebuild's
product, ``head`` every product of the head, each straight through (the
gradient passes unrounded); ``backward`` rounds the operands of M_bar's
product and the gradient entering the rebuild's.

Imports nothing of the program.
"""

from __future__ import annotations

import math

import torch

from gpubench.reference import learned_train as train_ref
from gpubench.reference.learned_deploy import corner, dense, herm, lifted, softplus
from gpubench.reference.learned_eigh_deploy import _dense, _mm, eigh_c128
from gpubench.reference.rounding import cmm, round_complex, rounder

DROPOUT = 0.1


class _EighEigenvalues(torch.autograd.Function):
    """(w, V) of herm(M) by ``eigh_c128``, V detached; the backward
    ``scale`` V diag(w_bar) V^H, its operands rounded by ``rnd``."""

    @staticmethod
    def forward(ctx, M, rnd_in, rnd_bwd, scale: float):
        w, V = eigh_c128(round_complex(M.detach(), rnd_in))
        w = w.to(torch.float32).to(M.device)
        V = V.to(torch.complex64).to(M.device)
        ctx.mark_non_differentiable(V)
        ctx.save_for_backward(V)
        ctx.rnd, ctx.scale = rnd_bwd, scale
        return w, V

    @staticmethod
    def backward(ctx, w_bar, _):
        (V,) = ctx.saved_tensors
        M_bar = cmm(V * w_bar.to(V.dtype)[..., None, :], torch.conj(V.transpose(-1, -2)),
                    ctx.rnd)
        return ctx.scale * M_bar, None, None, None


def _straight(rnd):
    """Complex operand rounding straight through (identity without one)."""
    if rnd is None:
        return lambda z: z
    return lambda z: z + (round_complex(z.detach(), rnd) - z.detach())


def glayer(p, k, phi, h, Z, model, tiers: dict, eigh_grad: float = 1.0):
    eps = model["epsilon"]
    pre = f"trunk.g_{k}."
    rho = softplus(p[pre + "rho"])
    M = herm(lifted(h, phi, corner(p, pre, model)) - Z / (rho + eps))
    bwd = rounder(tiers["backward"])
    w, V = _EighEigenvalues.apply(M, rounder(tiers["eigh"]), bwd, eigh_grad)
    s = torch.relu(dense(p, pre + "value_hidden", torch.abs(w)[..., None]))
    s = torch.sigmoid(dense(p, pre + "value_out", s))[..., 0]
    fw = softplus(w - torch.sigmoid(p[pre + "threshold"])) * s
    left = V * fw.to(torch.complex64)[..., None, :]
    if bwd is not None:
        left = train_ref._RoundGrad.apply(left, bwd)
    rb = _straight(rounder(tiers["rebuild"]))
    return herm(rb(left) @ rb(torch.conj(V.transpose(-1, -2))))


def trunk(y, b, sigma, p, config: dict, tiers: dict, eigh_grad: float = 1.0):
    """phi (B, n) of the trunk at ``tiers``, differentiable."""
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
        G = glayer(p, k, phi, h, Z, model, tiers, eigh_grad)
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


def head(phi, p, config: dict, tier: str, keep=None):
    """(tau, f, conf), each (B, L_max), of the attention head; ``keep`` the
    dropout's keep mask over the grid (None: no dropout)."""
    model, spec = config["model"], config["spec"]
    rnd = train_ref.straight_through(rounder(tier))
    L = spec["L_max"]
    H = model["num_heads"]
    pre = "peak_head."
    x = torch.cat([phi.real, phi.imag], dim=-1)
    x = torch.relu(_dense(p, pre + "feat1", x, rnd))
    x = torch.relu(_dense(p, pre + "feat2", x, rnd))
    pos = _dense(p, pre + "position_projection", p[pre + "position_grid"], rnd)
    B, hidden = x.shape
    D = hidden // H
    q = _dense(p, pre + "attention.query", x, rnd).reshape(B, H, D) / math.sqrt(D)
    k = _dense(p, pre + "attention.key", pos, rnd).reshape(-1, H, D).permute(1, 2, 0)
    v = _dense(p, pre + "attention.value", pos, rnd).reshape(-1, H, D).permute(1, 0, 2)
    wts = torch.softmax(_mm(q.permute(1, 0, 2), k, rnd), dim=-1)  # (H, B, n)
    if keep is not None:
        wts = wts * (keep.to(wts.dtype) / (1.0 - DROPOUT))
    o = _mm(wts, v, rnd).permute(1, 0, 2).reshape(B, hidden)
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


def loss(tau, f, conf, phi, batch):
    """``BasicANMLoss`` with slot pairing."""
    K = tau.shape[-1]
    L = batch["L_true"].to(torch.int64)
    mask = (torch.arange(K, device=tau.device)[None, :] < L[:, None]).to(tau.dtype)
    cnt = torch.clamp_min(L.to(tau.dtype), 1.0)

    def mse(pred, true):
        return torch.sum(mask * (pred - true) ** 2, dim=-1) / cnt

    per = mse(tau, batch["tau"]) + mse(f, batch["f"]) + 0.1 * mse(conf, torch.ones_like(conf))
    param = torch.mean(torch.where(L > 0, per, torch.sum(conf**2, dim=-1)))
    return param + 1e-4 * torch.mean(torch.sqrt(torch.sum(torch.abs(phi) ** 2, dim=-1)))


def run_steps(params0: dict, batches, config: dict, steps_per_epoch: int, tiers: dict,
              dropout_seed: int, half_batch: bool = False, skip_update: bool = False,
              eigh_grad: float = 1.0):
    """``len(batches)`` steps from ``params0`` (float32 tensors on the
    device), as ``learned_train.run_steps``: each step's loss, the first
    step's phi, the first clipped gradient and the parameters after the
    last step.  ``half_batch``, ``skip_update`` and ``eigh_grad`` (each
    M_bar scaled: 0 a zeroed, -1 a negated eigh backward) plant the faults
    a benchmark run must catch."""
    train = config["train"]
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params0.items()}
    groups = [{"params": [v for k, v in p.items() if k.startswith("trunk.")],
               "scale": train["admm_lr_scale"]},
              {"params": [v for k, v in p.items() if not k.startswith("trunk.")], "scale": 1.0}]
    opt = torch.optim.AdamW(groups, lr=train["lr"], betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=train["weight_decay"])
    device = params0[next(iter(params0))].device
    gen = torch.Generator(device=device).manual_seed(int(dropout_seed))
    grid = params0["peak_head.position_grid"].shape[0]
    losses, first_phi, first_grad = [], None, None
    for step, batch in enumerate(batches):
        keep = torch.rand(grid, generator=gen, device=device) < 1.0 - DROPOUT
        if half_batch:
            batch = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        opt.zero_grad(set_to_none=True)
        phi = trunk(batch["y"], batch["b"], batch["sigma"], p, config, tiers, eigh_grad)
        if first_phi is None:
            first_phi = phi.detach().clone()
        tau, f, conf = head(phi, p, config, tiers["head"], keep)
        total = loss(tau, f, conf, phi, batch)
        total.backward()
        grads = [v.grad if v.grad is not None else torch.zeros_like(v) for v in p.values()]
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        for v, g in zip(p.values(), grads):
            v.grad = g if norm < train["grad_clip"] else g / norm * train["grad_clip"]
        if first_grad is None:
            first_grad = {k: v.grad.detach().clone() for k, v in p.items()}
        lr = train_ref.sgdr(step, train["lr"], steps_per_epoch, train["epochs"],
                            train["sgdr_t0"], train["sgdr_t_mult"], train["lr_min"])
        for g in opt.param_groups:
            g["lr"] = g["scale"] * lr
        if not skip_update:
            opt.step()
        losses.append(float(total.detach()))
    return losses, first_phi, first_grad, {k: v.detach().clone() for k, v in p.items()}
