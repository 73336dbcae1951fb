"""Batched 2-D dual-polynomial spectrum evaluation.

z(tau, f) = |<phi, a(tau, f)>|^2 with a = kron(s(f), conj(d(tau))).  The
atom is separable, so the whole grid is a 2-D non-uniform DFT of conj(phi)
reshaped to (Nb, Nd): S(f) @ conj(Phi) @ conj(D(tau))^T, two small complex
products shared across the instance batch (complex64, fp32 accumulation).
"""

from __future__ import annotations

import torch

from admmnet_tpu_torch.ops.atoms import delay_steering, doppler_steering


def spectrum_grid(phi: torch.Tensor, taus, fs, Nb: int, Nd: int) -> torch.Tensor:
    """Spectrum on the separable grid fs x taus.

    phi: (..., Nb*Nd) complex; taus: (nx,); fs: (ny,).
    Returns (..., ny, nx) real, indexed [doppler, delay].
    """
    Phi = torch.conj(phi).reshape(*phi.shape[:-1], Nb, Nd)
    S = doppler_steering(torch.as_tensor(fs, device=phi.device), Nb)  # (ny, Nb)
    Dc = torch.conj(delay_steering(torch.as_tensor(taus, device=phi.device), Nd))
    inner = S @ Phi @ Dc.transpose(-1, -2)
    return torch.abs(inner) ** 2


def spectrum_at(phi: torch.Tensor, taus, fs, Nb: int, Nd: int) -> torch.Tensor:
    """Spectrum at paired points: taus, fs of shape (..., P) broadcastable
    against phi's batch dims.  Returns (..., P) real."""
    Phi = torch.conj(phi).reshape(*phi.shape[:-1], Nb, Nd)
    S = doppler_steering(torch.as_tensor(fs, device=phi.device), Nb)  # (..., P, Nb)
    Dc = torch.conj(delay_steering(torch.as_tensor(taus, device=phi.device), Nd))
    inner = torch.einsum("...pm,...mk,...pk->...p", S, Phi, Dc)
    return torch.abs(inner) ** 2
