"""Matrix spectral filters as Chebyshev polynomials (products only).

A learned scalar filter f applied to the spectrum of a Hermitian M,
``V f(L) V^H``, is the matrix function f(M); a Chebyshev expansion of f on
the spectral interval evaluates it with ``degree`` matrix products and no
eigendecomposition.  Per call, batched over leading dims:

1. bound the spectrum: r = ||M||_F >= rho(M); normalize Mh = M / r;
2. sample the filter at the Chebyshev nodes mapped back to the spectral
   domain: g_j = f(r x_j) / r;
3. project the samples onto Chebyshev coefficients with the fixed DCT-II
   matrix (c_0 halved for Clenshaw);
4. Clenshaw on matrices: b_k = c_k I + 2 Mh b_{k+1} - b_{k+2}, then
   out = c_0 I + Mh b_1 - b_2, scaled back by r.

Everything is differentiable through torch autograd.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from admmnet_tpu_torch.ops.linalg import complex_matmul


def chebyshev_nodes(n: int) -> np.ndarray:
    """First-kind Chebyshev nodes x_j = cos(pi (j + 1/2) / n), j = 0..n-1."""
    j = np.arange(n)
    return np.cos(np.pi * (j + 0.5) / n)


def coefficient_matrix(n: int) -> np.ndarray:
    """(n, n) matrix C with c = C @ g mapping samples at ``chebyshev_nodes``
    to Chebyshev coefficients (c_0 already halved for Clenshaw)."""
    j = np.arange(n)
    k = np.arange(n)[:, None]
    C = (2.0 / n) * np.cos(k * np.pi * (j + 0.5) / n)
    C[0] *= 0.5
    return C.astype(np.float32)


def _herm(X: torch.Tensor) -> torch.Tensor:
    return 0.5 * (X + torch.conj(X.transpose(-1, -2)))


def spectral_bound(M: torch.Tensor) -> torch.Tensor:
    """r = max(||M||_F, 1e-20) over the trailing two dims, shape (..., 1, 1)."""
    r = torch.sqrt(torch.sum(torch.abs(M) ** 2, dim=(-1, -2), keepdim=True))
    return torch.clamp_min(r, 1e-20)


def filter_coefficients(r: torch.Tensor, f: Callable, degree: int) -> torch.Tensor:
    """Chebyshev coefficients (..., degree) of the normalized-domain filter
    x -> f(r x) / r, for r of shape (..., 1, 1)."""
    x = torch.from_numpy(chebyshev_nodes(degree)).to(torch.float32).to(r.device)
    rr = r[..., 0, 0][..., None]
    g = f(rr * x) / rr
    C = torch.from_numpy(coefficient_matrix(degree)).to(r.device)
    return torch.einsum("kj,...j->...k", C, g)


def apply_spectral_filter(
    M: torch.Tensor,
    f: Callable[[torch.Tensor], torch.Tensor],
    degree: int = 48,
    precision: str = "highest",
) -> torch.Tensor:
    """f_mat(M) for Hermitian complex64 (..., m, m) M and pointwise filter f.

    ``f`` maps a real (..., n_nodes) tensor of eigenvalue locations to
    filter values.  ``degree`` = number of Chebyshev terms = number of
    matrix products.  ``precision="default"`` (``Precision.DEFAULT`` in the
    JAX package, one-pass bf16 on the TPU) adds the Hermitian re-projection
    of every iterate and of the result, and on the card makes each product
    one-pass as the peak search's refine does: the real and imaginary parts
    of both operands rounded to bf16, the exact products summed in fp32.
    On the CPU, where DEFAULT is fp32, and with ``"highest"``, every
    product is fp32.
    """
    if precision not in ("highest", "default"):
        raise ValueError(f"unknown precision {precision!r}")
    resym = precision == "default"
    one_pass = resym and M.device.type == "cuda"
    m = M.shape[-1]
    r = spectral_bound(M)
    Mh = M / r.to(M.dtype)
    c = filter_coefficients(r, f, degree)

    eye = torch.eye(m, dtype=M.dtype, device=M.device)
    b1 = torch.zeros_like(M)
    b2 = torch.zeros_like(M)
    for k in range(degree - 1, 0, -1):
        b0 = (c[..., k][..., None, None].to(M.dtype) * eye
              + (2.0 * complex_matmul(Mh, b1, one_pass) - b2))
        if resym:
            b0 = _herm(b0)
        b1, b2 = b0, b1
    out = c[..., 0][..., None, None].to(M.dtype) * eye + (complex_matmul(Mh, b1, one_pass) - b2)
    if resym:
        out = _herm(out)
    return (out * r.to(M.dtype)).to(M.dtype)
