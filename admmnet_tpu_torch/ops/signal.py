"""PSK modulation / demodulation and AWGN, batched, with an explicit
``torch.Generator`` for the noise.

Counterparts of ``admmnet_tpu/ops/signal.py``.  The port's generator does
not give JAX's random bits: tests feed both packages the same noise or
compare distributions.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from admmnet_tpu_torch.ops.atoms import COMPLEX


def pskmod(data: torch.Tensor, order: int, phase_offset: float = 0.0) -> torch.Tensor:
    """M-ary PSK modulation: ints [0, M) -> unit-modulus complex symbols."""
    angle = 2.0 * math.pi * data.to(torch.float32) / order + phase_offset
    return torch.polar(torch.ones_like(angle), angle).to(COMPLEX)


def pskdemod(sig: torch.Tensor, order: int, phase_offset: float = 0.0) -> torch.Tensor:
    """M-ary PSK hard demodulation to ints [0, M): shift the decision
    boundary by pi/M, wrap to [0, 2 pi), quantize."""
    angles = torch.angle(sig) - phase_offset
    angles = torch.remainder(angles + math.pi / order, 2.0 * math.pi)
    return torch.remainder(torch.floor(angles * order / (2.0 * math.pi)).to(torch.int32), order)


def complex_normal(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """N(0, 1) + j N(0, 1) samples (real part drawn first), complex64."""
    re = torch.randn(shape, generator=generator, device=device)
    im = torch.randn(shape, generator=generator, device=device)
    return torch.complex(re, im)


def awgn(sig: torch.Tensor, snr_db, generator: Optional[torch.Generator] = None,
         axis: int = -1, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Add complex AWGN at the given per-signal SNR (dB): noise power =
    mean |sig|^2 / 10^(snr/10), split evenly between real and imaginary
    parts.  ``snr_db`` may be batched (broadcast against sig without the
    ``axis`` dim).  ``noise``: unit complex normal draws to use instead of
    drawing from ``generator``."""
    sig_power = torch.mean(torch.abs(sig) ** 2, dim=axis, keepdim=True)
    snr_lin = 10.0 ** (torch.as_tensor(snr_db, dtype=torch.float32, device=sig.device) / 10.0)
    noise_power = sig_power / torch.unsqueeze(snr_lin, axis)
    if noise is None:
        noise = complex_normal(sig.shape, generator, sig.device)
    return sig + torch.sqrt(noise_power / 2.0).to(COMPLEX) * noise.to(COMPLEX)
