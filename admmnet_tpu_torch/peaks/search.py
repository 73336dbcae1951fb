"""Vectorized coarse-to-fine 2-D peak search.

- the coarse sweep is the separable spectrum (``peaks.spectrum``);
- local maxima are a 3x3 max-pool equality with -inf padding
  (``F.max_pool2d`` pads implicitly with -inf), borders allowed;
- the data-dependent peak count becomes a fixed ``max_peaks`` top-K with a
  validity mask (padded entries carry height -inf);
- refinement runs ``refine_iters`` rounds of a P x P local-grid argmax per
  peak, all peaks and instances at once; round r has half-width
  step * reduce_factor^r.  Results are sorted by height, descending.

On the card ``find_peaks`` runs the whole search as one hand-written kernel
per batch (``kernels/peak_search.py``: one thread block a scene, the grid
in shared memory), with the coarse axes, their steering and the refine's
offsets built once per configuration, sizes and device
(``search_constants``).  On the CPU it runs the plain version below, in
batched torch ops, which the tests hold to the JAX package.

``refine_precision`` follows the JAX package's precision rule, with the
tier following the device as ``jax.lax.Precision.DEFAULT`` does in JAX:
"default" on the card evaluates each of the two refine products (S Phi,
then that times Dc^T) one-pass, as the MXU does: the real and imaginary
parts of both operands rounded to nearest-even bf16, the exact products
summed in float32 (the kernel's arithmetic; ``refine_product`` with
``one_pass=True`` is the same in torch ops).  "highest", and either on the
CPU, where DEFAULT is float32 in JAX, is float32.  Ties in the top-K may be
ordered differently from ``lax.top_k``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from admmnet_tpu_torch.core.config import PeakSearchConfig
from admmnet_tpu_torch.kernels.peak_search import peak_search
from admmnet_tpu_torch.ops.atoms import delay_steering, doppler_steering
from admmnet_tpu_torch.ops.linalg import complex_matmul
from admmnet_tpu_torch.peaks.spectrum import spectrum_grid
from admmnet_tpu_torch.utils import profiling


class PeakResult(NamedTuple):
    tau: torch.Tensor  # (..., K) delay estimates
    f: torch.Tensor  # (..., K) doppler estimates
    height: torch.Tensor  # (..., K) spectrum heights, -inf for padding
    valid: torch.Tensor  # (..., K) bool


def _coarse_axes(cfg: PeakSearchConfig):
    taus = np.arange(cfg.delay_min, cfg.delay_max, cfg.delay_step, dtype=np.float32)
    # exclude the aliasing endpoint tau = delay_max (= delay_min mod 1)
    if taus.size and abs((taus[-1] - cfg.delay_min) % 1.0) < 1e-9:
        taus = taus[:-1]
    fs = np.arange(cfg.doppler_min, cfg.doppler_max, cfg.doppler_step, dtype=np.float32)
    return taus, fs


class SearchConstants(NamedTuple):
    """What the kernel's search reads beside phi, for one configuration,
    Nb, Nd and device."""

    taus: torch.Tensor  # (nx,) coarse delay axis, ``_coarse_axes``'
    fs: torch.Tensor  # (ny,) coarse doppler axis
    S: torch.Tensor  # (ny, Nb) doppler steering of fs
    DcT: torch.Tensor  # (Nd, nx) conjugated delay steering of taus, transposed
    rel: torch.Tensor  # (refine_points,) the refine's linspace(-1, 1, P)


@functools.lru_cache(maxsize=32)
def search_constants(cfg: PeakSearchConfig, Nb: int, Nd: int,
                     device: torch.device) -> SearchConstants:
    """The coarse grid and the refine's offsets, built on ``device`` by the
    same calls as the plain version's, once per (cfg, Nb, Nd, device)."""
    taus_np, fs_np = _coarse_axes(cfg)
    taus = torch.from_numpy(taus_np).to(device)
    fs = torch.from_numpy(fs_np).to(device)
    return SearchConstants(
        taus=taus, fs=fs, S=doppler_steering(fs, Nb),
        DcT=torch.conj(delay_steering(taus, Nd)).T.contiguous(),
        rel=torch.linspace(-1.0, 1.0, cfg.refine_points, dtype=torch.float32, device=device),
    )


def _local_max_mask(Z: torch.Tensor) -> torch.Tensor:
    """8-neighborhood local maxima of (B, ny, nx), borders allowed."""
    pooled = F.max_pool2d(Z[:, None], kernel_size=3, stride=1, padding=1)[:, 0]
    return Z >= pooled


# a @ b of the refine, one-pass (operands rounded to bf16) or float32
refine_product = complex_matmul


def _refine(phi, tau0, f0, cfg: PeakSearchConfig, Nb: int, Nd: int):
    """Fixed-round local zoom.  phi: (B, n); tau0/f0: (B, K)."""
    one_pass = cfg.refine_precision == "default" and phi.device.type == "cuda"
    P = cfg.refine_points
    Phi = torch.conj(phi).reshape(phi.shape[0], 1, Nb, Nd)
    rel = torch.linspace(-1.0, 1.0, P, dtype=torch.float32, device=phi.device)
    tau, f = tau0, f0
    height = None
    half_t = cfg.delay_step
    half_f = cfg.doppler_step
    for _ in range(cfg.refine_iters):
        taus = torch.clamp(tau[..., None] + half_t * rel, cfg.delay_min,
                           cfg.delay_max - 1e-6)  # (B, K, P)
        fs = torch.clamp(f[..., None] + half_f * rel, cfg.doppler_min,
                         cfg.doppler_max - 1e-6)
        S = doppler_steering(fs, Nb)  # (B, K, P, Nb)
        Dc = torch.conj(delay_steering(taus, Nd))  # (B, K, P, Nd)
        SPhi = refine_product(S, Phi, one_pass)  # (B, K, P, Nd)
        Zl = torch.abs(refine_product(SPhi, Dc.transpose(-1, -2), one_pass)) ** 2  # (B,K,P,P)
        flat = Zl.reshape(*Zl.shape[:-2], P * P)
        idx = torch.argmax(flat, dim=-1)
        height = torch.gather(flat, -1, idx[..., None])[..., 0]
        f = torch.gather(fs, -1, (idx // P)[..., None])[..., 0]
        tau = torch.gather(taus, -1, (idx % P)[..., None])[..., 0]
        half_t *= cfg.reduce_factor
        half_f *= cfg.reduce_factor
    return tau, f, height


def find_peaks(phi: torch.Tensor, Nb: int, Nd: int,
               cfg: PeakSearchConfig = PeakSearchConfig()) -> PeakResult:
    """Coarse-to-fine peak search on batched phi (..., Nb*Nd).

    Returns PeakResult with K = cfg.max_peaks entries per instance, sorted
    by height descending; invalid (padding) entries have height -inf.  A
    CUDA phi runs the kernel (one launch), any other the plain version.
    """
    with profiling.span("peaks.search"):
        batch_shape = phi.shape[:-1]
        phi2 = phi.reshape(-1, phi.shape[-1])
        if phi.is_cuda:
            out = peak_search(phi2.contiguous(), Nb, Nd, cfg,
                              search_constants(cfg, Nb, Nd, phi.device))
        else:
            out = find_peaks_plain(phi2, Nb, Nd, cfg)
        K = cfg.max_peaks
        return PeakResult(*(x.reshape(*batch_shape, K) for x in out))


def find_peaks_plain(phi2: torch.Tensor, Nb: int, Nd: int, cfg: PeakSearchConfig):
    """The search in batched torch ops on phi (B, Nb*Nd): (tau, f, height,
    valid), each (B, K), sorted by height.  The CPU's path, and on the card
    the reference the kernel is held to."""
    B = phi2.shape[0]
    K = cfg.max_peaks
    dev = phi2.device

    with profiling.span("peaks.coarse"):
        consts = search_constants(cfg, Nb, Nd, dev)
        taus_ax, fs_ax = consts.taus, consts.fs
        nx, ny = taus_ax.numel(), fs_ax.numel()
        Z = spectrum_grid(phi2, taus_ax, fs_ax, Nb, Nd)  # (B, ny, nx)
    with profiling.span("peaks.select"):
        mask = _local_max_mask(Z)
        scores = torch.where(mask, Z, -torch.inf).reshape(B, ny * nx)
        vals, idx = torch.topk(scores, K, dim=-1)
        valid = torch.isfinite(vals)
        tau0 = torch.where(valid, taus_ax[idx % nx], cfg.delay_min)
        f0 = torch.where(valid, fs_ax[idx // nx], cfg.doppler_min)

    with profiling.span("peaks.refine"):
        tau_r, f_r, h_r = _refine(phi2, tau0, f0, cfg, Nb, Nd)
        h_r = torch.where(valid, h_r, -torch.inf)

        order = torch.argsort(-h_r, dim=-1, stable=True)
        return tuple(torch.gather(x, -1, order) for x in (tau_r, f_r, h_r, valid))
