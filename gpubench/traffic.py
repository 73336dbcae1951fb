"""The benchmark's one scene generator, driven by a traffic file's parameters.

A frozen copy of the port's synthetic OFDM-ISAC draws (``data/generator``'s
``draw_batch`` and ``scenes_from_draws`` with the ``ops.atoms`` and
``ops.signal`` helpers they call), so that a change to the program cannot
change the traffic.  Per scene:

- tau ~ U(tau_range), f ~ U(f_range), L_max targets;
- complex gains C = gain_std (N(0, 1) + j N(0, 1));
- PSK symbols with demodulation errors at SNR_e = snr_demod dB (awgn, hard
  decision); b the demodulated symbols, e = sig - b;
- y = (b + e) Psi + w at SNR_w ~ U(snr_db) dB per scene (a fixed SNR when
  both ends are equal);
- sigma = ||e / b|| + 1.

The draws come from one ``torch.Generator`` on the device, seeded with the
run's seed, in a few large calls: the same seed gives the same scenes.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

COMPLEX = torch.complex64


def _uniform(shape, lo, hi, generator, device):
    return lo + (hi - lo) * torch.rand(shape, generator=generator, device=device)


def complex_normal(shape, generator, device) -> torch.Tensor:
    re = torch.randn(shape, generator=generator, device=device)
    im = torch.randn(shape, generator=generator, device=device)
    return torch.complex(re, im)


def pskmod(data: torch.Tensor, order: int, phase_offset: float) -> torch.Tensor:
    angle = 2.0 * math.pi * data.to(torch.float32) / order + phase_offset
    return torch.polar(torch.ones_like(angle), angle).to(COMPLEX)


def pskdemod(sig: torch.Tensor, order: int, phase_offset: float) -> torch.Tensor:
    angles = torch.angle(sig) - phase_offset
    angles = torch.remainder(angles + math.pi / order, 2.0 * math.pi)
    return torch.remainder(torch.floor(angles * order / (2.0 * math.pi)).to(torch.int32), order)


def awgn(sig: torch.Tensor, snr_db: float, noise: torch.Tensor) -> torch.Tensor:
    """sig plus the unit complex normal ``noise`` scaled to ``snr_db``."""
    sig_power = torch.mean(torch.abs(sig) ** 2, dim=-1, keepdim=True)
    noise_power = sig_power / (10.0 ** (snr_db / 10.0))
    return sig + torch.sqrt(noise_power / 2.0).to(COMPLEX) * noise.to(COMPLEX)


def atom(tau: torch.Tensor, f: torch.Tensor, Nb: int, Nd: int) -> torch.Tensor:
    """kron(s(f), conj(d(tau))), index m * Nd + k: exp(2j pi (f m - tau k))."""
    m = torch.arange(Nb, dtype=torch.float32, device=f.device)
    k = torch.arange(Nd, dtype=torch.float32, device=tau.device)
    s = torch.exp(2j * math.pi * f[..., None] * m).to(COMPLEX)
    d_conj = torch.conj(torch.exp(2j * math.pi * tau[..., None] * k).to(COMPLEX))
    out = s[..., :, None] * d_conj[..., None, :]
    return out.reshape(*out.shape[:-2], Nb * Nd)


def scenes(data: dict, spec: dict, count: int, generator: torch.Generator,
           device) -> Dict[str, torch.Tensor]:
    """``count`` scenes drawn from ``generator``: y, b (complex64, (count, n)),
    sigma, tau, f and L_true.  ``data`` holds the distribution's parameters
    (a configuration's ``data`` with the traffic's ``snr_db``), ``spec`` the
    sizes Nb, Nd, L_max."""
    Nb, Nd, L = spec["Nb"], spec["Nd"], spec["L_max"]
    n = Nb * Nd
    order = data["psk_order"]
    offset = math.pi / order
    tau = _uniform((count, L), *data["tau_range"], generator, device)
    f = _uniform((count, L), *data["f_range"], generator, device)
    C = data["gain_std"] * complex_normal((count, L), generator, device)
    symbols = torch.randint(0, order, (count, n), generator=generator, device=device)
    demod_noise = complex_normal((count, n), generator, device)
    snr_w = _uniform((count,), *data["snr_db"], generator, device)
    w = math.sqrt(0.5) * complex_normal((count, n), generator, device)

    Psi = torch.sum(C[..., None] * atom(tau, f, Nb, Nd), dim=-2)
    sig = pskmod(symbols, order, offset)
    b = pskmod(pskdemod(awgn(sig, data["snr_demod"], demod_noise), order, offset), order,
               offset)
    e = sig - b
    real_y = (b + e) * Psi
    w_var = torch.sum(torch.abs(real_y) ** 2, dim=-1, keepdim=True) / (
        10.0 ** (snr_w[:, None] / 10.0) * n)
    y = real_y + torch.sqrt(w_var).to(COMPLEX) * w.to(COMPLEX)
    sigma = torch.sqrt(torch.sum(torch.abs(e / b) ** 2, dim=-1)) + 1.0
    return {"y": y, "b": b, "sigma": sigma, "tau": tau, "f": f,
            "L_true": torch.full((count,), L, dtype=torch.int32, device=device)}
