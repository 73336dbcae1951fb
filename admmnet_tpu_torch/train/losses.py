"""Training losses of the learned nets, batched.  Counterparts of
``admmnet_tpu/train/losses.py``:

- ``basic_parameter_loss``: slot i pairs with target i;
- ``permutation_matched_parameter_loss``: the minimum over all L_max!
  assignments of prediction slots to targets;
- ``spectral_contrast_loss``: -mean log(alignment of phi with the true
  atoms + eps), which carries gradient into the trunk under the spectrum
  head;
- ``basic_anm_loss``: a parameter loss + lambda_reg * mean ||phi|| (+ the
  spectral term);
- ``phi_alignment_loss``: amplitude MSE + wrapped-phase MSE.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, Tuple

import torch

from admmnet_tpu_torch.peaks.spectrum import spectrum_at


def _target_mask(L_true: torch.Tensor, L_max: int, dtype):
    """(mask (B, L_max) of the real targets, their count clamped to >= 1)."""
    L = L_true.to(torch.int64)
    mask = (torch.arange(L_max, device=L.device)[None, :] < L[:, None]).to(dtype)
    return mask, torch.clamp_min(L.to(dtype), 1.0)


def basic_parameter_loss(tau_pred, f_pred, confidences, tau_true, f_true, L_true):
    """Mean over the batch of: mse(tau) + mse(f) + 0.1 mse(conf, 1) over the
    real targets when L > 0, else sum(conf^2)."""
    mask, cnt = _target_mask(L_true, tau_pred.shape[-1], tau_pred.dtype)
    tau_mse = torch.sum(mask * (tau_pred - tau_true) ** 2, dim=-1) / cnt
    f_mse = torch.sum(mask * (f_pred - f_true) ** 2, dim=-1) / cnt
    conf_mse = torch.sum(mask * (confidences - 1.0) ** 2, dim=-1) / cnt
    with_targets = tau_mse + f_mse + 0.1 * conf_mse
    no_targets = torch.sum(confidences**2, dim=-1)
    return torch.mean(torch.where(L_true > 0, with_targets, no_targets))


def permutation_matched_parameter_loss(tau_pred, f_pred, confidences, tau_true, f_true,
                                       L_true):
    """``basic_parameter_loss`` under the best of the L_max! assignments of
    prediction slots to targets (exact set matching)."""
    L_max = tau_pred.shape[-1]
    mask, cnt = _target_mask(L_true, L_max, tau_pred.dtype)
    perms = torch.tensor(list(itertools.permutations(range(L_max))),
                         device=tau_pred.device)  # (P, L_max)
    mask, cnt = mask[:, None, :], cnt[:, None]

    def mse(pred, true):  # (B, P) over the permuted predictions
        return torch.sum(mask * (pred[:, perms] - true[:, None, :]) ** 2, dim=-1) / cnt

    ones = torch.ones_like(tau_true)
    per_perm = (mse(tau_pred, tau_true) + mse(f_pred, f_true)
                + 0.1 * mse(confidences, ones))
    with_targets = torch.amin(per_perm, dim=-1)
    no_targets = torch.sum(confidences**2, dim=-1)
    return torch.mean(torch.where(L_true > 0, with_targets, no_targets))


def spectral_contrast_loss(phi, tau_true, f_true, L_true, Nb: int, Nd: int,
                           log_eps: float = 1e-4):
    """-mean over the real targets of log(z / (||phi||^2 n) + eps), z the
    spectrum |<phi, a(tau, f)>|^2 at the true positions."""
    n = Nb * Nd
    z = spectrum_at(phi, tau_true, f_true, Nb, Nd)  # (B, L_max)
    e = torch.sum(torch.abs(phi) ** 2, dim=-1, keepdim=True)
    align = z / (e * n + 1e-20)
    mask, cnt = _target_mask(L_true, tau_true.shape[-1], align.dtype)
    per_sample = torch.sum(mask * -torch.log(align + log_eps), dim=-1) / cnt
    return torch.mean(torch.where(L_true > 0, per_sample, torch.zeros_like(per_sample)))


def basic_anm_loss(tau_pred, f_pred, confidences, phi, tau_true, f_true, L_true,
                   lambda_reg: float = 1e-4, assignment: str = "slot",
                   spectral_weight: float = 0.0, spec=None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Parameter loss (``assignment`` "slot" or "perm") + lambda_reg *
    mean ||phi||, plus ``spectral_weight * spectral_contrast_loss`` when
    the weight is positive (``spec``: the ProblemSpec)."""
    param_fn = (permutation_matched_parameter_loss if assignment == "perm"
                else basic_parameter_loss)
    param = param_fn(tau_pred, f_pred, confidences, tau_true, f_true, L_true)
    reg = lambda_reg * torch.mean(torch.sqrt(torch.sum(torch.abs(phi) ** 2, dim=-1)))
    total = param + reg
    parts = {"total_loss": total, "param_loss": param, "reg_loss": reg}
    if spectral_weight > 0.0:
        spectral = spectral_contrast_loss(phi, tau_true, f_true, L_true, spec.Nb, spec.Nd)
        total = total + spectral_weight * spectral
        parts["spectral_loss"] = spectral
        parts["total_loss"] = total
    return total, parts


def phi_alignment_loss(phi_pred: torch.Tensor, phi_true: torch.Tensor,
                       amplitude_weight: float = 1.0, phase_weight: float = 0.5,
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Amplitude MSE + wrapped-phase MSE."""
    amp = torch.mean((torch.abs(phi_pred) - torch.abs(phi_true)) ** 2)
    dphase = torch.angle(phi_pred) - torch.angle(phi_true)
    dphase = torch.remainder(dphase + math.pi, 2.0 * math.pi) - math.pi
    phase = torch.mean(dphase**2)
    total = amplitude_weight * amp + phase_weight * phase
    return total, {"total_loss": total, "amplitude_loss": amp, "phase_loss": phase}
