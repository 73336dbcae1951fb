"""Plain reference of the learned training step: the net-3 forward of
``reference.learned_deploy`` under autograd, the end-to-end loss, the
global-norm clip and AdamW, written from the recipe the configuration
states.

- loss: the best over the L_max! assignments of prediction slots to
  targets of mse(tau) + mse(f) + 0.1 mse(conf, 1), plus 1e-4 mean ||phi||,
  plus ``spectral_weight`` times -mean log(|<phi, a(tau_l, f_l)>|^2 /
  (||phi||^2 n) + 1e-4) over the true targets;
- the gradient clipped by its global norm c: unchanged below c, else
  scaled to norm c; a parameter the loss misses gets a zero gradient;
- AdamW (betas 0.9, 0.999, eps 1e-8, decoupled weight decay), the trunk's
  parameters at ``admm_lr_scale`` times the rate; the rate is SGDR's cosine
  at the number of updates made before each one.

The Clenshaw products are one-pass at the forward tier, their operands
rounded straight through (the gradient passes unrounded); ``bwd_tier``
rounds the gradient that enters each Clenshaw product's backward (None:
float32, as the split-bf16 backward the configuration states is
float32-faithful).  Imports nothing of the program.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from gpubench.reference import learned_deploy as net
from gpubench.reference.rounding import rounder


class _RoundGrad(torch.autograd.Function):
    """Identity forward; the incoming gradient rounded by ``rnd`` backward."""

    @staticmethod
    def forward(ctx, x, rnd):
        ctx.rnd = rnd
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if g.is_complex():
            g = torch.complex(ctx.rnd(g.real.contiguous()), ctx.rnd(g.imag.contiguous()))
        else:
            g = ctx.rnd(g.contiguous())
        return g, None


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the incoming gradient times ``scale`` backward."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def straight_through(rnd):
    if rnd is None:
        return None
    return lambda x: x + (rnd(x) - x).detach()


def clenshaw_rounding(fwd_tier: str, bwd_tier):
    """The rounding function of the Clenshaw products' operands: forward at
    ``fwd_tier`` straight through, and with ``bwd_tier`` the gradients
    entering the products rounded too."""
    fwd = straight_through(rounder(fwd_tier)) or (lambda x: x)
    bwd = rounder(bwd_tier) if bwd_tier else None
    if bwd is None:
        return fwd
    return lambda x: _RoundGrad.apply(fwd(x), bwd)


def sgdr(step: int, base_lr: float, steps_per_epoch: int, total_epochs: int, t0: int,
         t_mult: int, eta_min: float) -> float:
    """Cosine warm restarts: cycle k spans t0 t_mult^k epochs, in float32."""
    starts, lengths = [], []
    start, cycle = 0, t0
    while start < total_epochs:
        starts.append(start * steps_per_epoch)
        lengths.append(max(1, cycle * steps_per_epoch))
        start += cycle
        cycle *= t_mult
    k = 0
    while k + 1 < len(starts) and step >= starts[k + 1]:
        k += 1
    count = np.float32(min(max(step - starts[k], 0), lengths[k]))
    cosine = np.float32(0.5) * (np.float32(1.0) + np.cos(
        np.float32(math.pi) * count / np.float32(lengths[k]), dtype=np.float32))
    alpha = np.float32(eta_min / base_lr)
    return float(np.float32(base_lr) * ((np.float32(1.0) - alpha) * cosine + alpha))


def spectrum_at(phi, tau, f, Nb: int, Nd: int):
    Phi = torch.conj(phi).reshape(phi.shape[0], Nb, Nd)
    S = net.steering(f, Nb)
    Dc = torch.conj(net.steering(tau, Nd))
    return torch.abs(torch.einsum("bpm,bmk,bpk->bp", S, Phi, Dc)) ** 2


def loss(tau, f, conf, phi, batch, config: dict):
    spec, train = config["spec"], config["train"]
    K = tau.shape[-1]
    L = batch["L_true"].to(torch.int64)
    mask = (torch.arange(K, device=tau.device)[None, :] < L[:, None]).to(tau.dtype)
    cnt = torch.clamp_min(L.to(tau.dtype), 1.0)
    perms = torch.tensor(list(itertools.permutations(range(K))), device=tau.device)

    def mse(pred, true):
        return torch.sum(mask[:, None, :] * (pred[:, perms] - true[:, None, :]) ** 2,
                         dim=-1) / cnt[:, None]

    per_perm = (mse(tau, batch["tau"]) + mse(f, batch["f"])
                + 0.1 * mse(conf, torch.ones_like(batch["tau"])))
    param = torch.mean(torch.where(L > 0, torch.amin(per_perm, dim=-1),
                                   torch.sum(conf**2, dim=-1)))
    total = param + 1e-4 * torch.mean(torch.sqrt(torch.sum(torch.abs(phi) ** 2, dim=-1)))
    w = train["spectral_weight"]
    if w > 0:
        n = spec["Nb"] * spec["Nd"]
        z = spectrum_at(phi, batch["tau"], batch["f"], spec["Nb"], spec["Nd"])
        e = torch.sum(torch.abs(phi) ** 2, dim=-1, keepdim=True)
        per = torch.sum(mask * -torch.log(z / (e * n + 1e-20) + 1e-4), dim=-1) / cnt
        total = total + w * torch.mean(torch.where(L > 0, per, torch.zeros_like(per)))
    return total


def run_steps(params0: dict, batches, config: dict, steps_per_epoch: int, fwd_tier: str,
              bwd_tier=None, half_batch: bool = False, skip_update: bool = False,
              glayer_grad: float = 1.0):
    """``len(batches)`` steps from ``params0`` (float32 tensors on the
    device): each step's loss, the first step's phi, the first step's
    clipped gradient and the parameters after the last step (dicts by
    name).  ``half_batch``, ``skip_update`` and ``glayer_grad`` (the
    gradient leaving each Clenshaw evaluation's output scaled: 0 a zeroed,
    -1 a negated backward) plant the faults a benchmark run must catch."""
    train = config["train"]
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params0.items()}
    groups = [{"params": [v for k, v in p.items() if k.startswith("trunk.")],
               "scale": train["admm_lr_scale"]},
              {"params": [v for k, v in p.items() if not k.startswith("trunk.")], "scale": 1.0}]
    opt = torch.optim.AdamW(groups, lr=train["lr"], betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=train["weight_decay"])
    rnd = clenshaw_rounding(fwd_tier, bwd_tier)
    g_hook = None if glayer_grad == 1.0 else (lambda x: _ScaleGrad.apply(x, glayer_grad))
    losses, first_phi, first_grad = [], None, None
    for step, batch in enumerate(batches):
        if half_batch:
            batch = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        opt.zero_grad(set_to_none=True)
        phi = net.trunk(batch["y"], batch["b"], batch["sigma"], p, config, fwd_tier, rnd=rnd,
                        g_hook=g_hook)
        if first_phi is None:
            first_phi = phi.detach().clone()
        tau, f, conf = net.head(phi, p, config, config["tiers"]["head"])
        total = loss(tau, f, conf, phi, batch, config)
        total.backward()
        grads = [v.grad if v.grad is not None else torch.zeros_like(v) for v in p.values()]
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        for v, g in zip(p.values(), grads):
            v.grad = g if norm < train["grad_clip"] else g / norm * train["grad_clip"]
        if first_grad is None:
            first_grad = {k: v.grad.detach().clone() for k, v in p.items()}
        lr = sgdr(step, train["lr"], steps_per_epoch, train["epochs"], train["sgdr_t0"],
                  train["sgdr_t_mult"], train["lr_min"])
        for g in opt.param_groups:
            g["lr"] = g["scale"] * lr
        if not skip_update:
            opt.step()
        losses.append(float(total.detach()))
    return losses, first_phi, first_grad, {k: v.detach().clone() for k, v in p.items()}


def _norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v)) for k, v in tree.items()}


def steady_leaves(grad: dict, grad_above: dict, grad_below: dict) -> list:
    """The leaves compared, by a rule on the reference's first gradient:
    at least a thousandth of the median leaf's (the others move by weight
    decay and round-off alone), and steady under a change of the
    reference's own precision: within 2% of ``grad_above`` (the Clenshaw
    products in float32) and within 20% of ``grad_below`` (a tier below the
    configuration's).  Most of the trunk's leaf gradients are remainders of
    cancelling terms that move by far more than that with the rounding."""
    n = _norms(grad)
    med = float(np.median(list(n.values())))
    return [k for k, g in n.items()
            if g >= 1e-3 * med
            and float(torch.linalg.vector_norm(grad[k] - grad_above[k])) <= 0.02 * g
            and float(torch.linalg.vector_norm(grad[k] - grad_below[k])) <= 0.2 * g]


def leaf_gap(x: dict, ref: dict, keep: list) -> float:
    """The worst of the ``keep`` leaves: |norm of x's leaf - norm of the
    reference's| over the larger of the reference's leaf norm and the
    median of the kept leaves' (some are all but zero)."""
    nx, nr = _norms({k: x[k] for k in keep}), _norms({k: ref[k] for k in keep})
    med = float(np.median(list(nr.values())))
    return max((abs(nx[k] - nr[k]) / max(nr[k], med) for k in keep), default=float("nan"))
