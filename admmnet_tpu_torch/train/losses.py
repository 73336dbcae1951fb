"""Losses of the learned net: only the phi alignment loss, which the
evaluation CLI reports."""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


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
