"""Atom / steering-vector factory for the joint delay-Doppler dictionary.

Spectrum evaluation over a grid of candidate (tau, f) points is a dense
complex product of steering matrices; the atom layout is
``kron(s(f), conj(d(tau)))`` with index ``m * Nd + k``.
"""

from __future__ import annotations

import math

import torch

COMPLEX = torch.complex64


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def vander_vec(start: float, stop: float, length: int) -> torch.Tensor:
    """Unit-modulus Vandermonde-style vector exp(2j*pi*linspace(start, stop)),
    flat (length,)."""
    fre = torch.linspace(start, stop, length, dtype=torch.float32)
    return torch.exp(2j * math.pi * fre).to(COMPLEX)


def doppler_steering(f, Nb: int) -> torch.Tensor:
    """s(f) = exp(2j*pi*f*[0..Nb-1]); f scalar or batched (...,) -> (..., Nb)."""
    f = _f32(f)
    m = torch.arange(Nb, dtype=torch.float32, device=f.device)
    return torch.exp(2j * math.pi * f[..., None] * m).to(COMPLEX)


def delay_steering(tau, Nd: int) -> torch.Tensor:
    """d(tau) = exp(2j*pi*tau*[0..Nd-1]); returns (..., Nd)."""
    tau = _f32(tau)
    k = torch.arange(Nd, dtype=torch.float32, device=tau.device)
    return torch.exp(2j * math.pi * tau[..., None] * k).to(COMPLEX)


def atom(tau, f, Nb: int, Nd: int) -> torch.Tensor:
    """Flattened atom a(tau, f) = kron(s(f), conj(d(tau))), shape (..., Nb*Nd).

    a[..., m*Nd + k] = exp(2j*pi*(f*m - tau*k)).
    """
    s = doppler_steering(f, Nb)  # (..., Nb)
    d_conj = torch.conj(delay_steering(tau, Nd))  # (..., Nd)
    out = s[..., :, None] * d_conj[..., None, :]  # (..., Nb, Nd)
    return out.reshape(*out.shape[:-2], Nb * Nd)


def khatri_rao(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Column-wise Kronecker product: (m, n) x (p, n) -> (m*p, n)."""
    m, n = A.shape
    p, n2 = B.shape
    if n != n2:
        raise ValueError(f"column mismatch {n} vs {n2}")
    return (A[:, None, :] * B[None, :, :]).reshape(m * p, n)


def atom_matrix(taus, fs, Nb: int, Nd: int) -> torch.Tensor:
    """Dictionary matrix over paired (tau, f) points: (n_points, Nb*Nd);
    row i is atom(taus[i], fs[i])."""
    return atom(taus, fs, Nb, Nd)


def target_signal(taus, fs, gains, Nb: int, Nd: int) -> torch.Tensor:
    """Superposition Psi = sum_l gains[l] * a(tau_l, f_l), shape (..., Nb*Nd).

    taus/fs/gains may be (..., L); the leading dims broadcast.
    """
    a = atom(taus, fs, Nb, Nd)  # (..., L, n)
    g = torch.as_tensor(gains).to(COMPLEX)
    return torch.sum(g[..., None] * a, dim=-2)
