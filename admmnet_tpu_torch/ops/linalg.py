"""Lifted-matrix assembly and norm helpers for the ANM-DUMV ADMM.

The lifted variable is the (n+1) x (n+1) Hermitian block matrix
``[[diag(h), phi], [phi^H, 1/lambda^2]]`` with h real.  All ops batch over
leading dims.
"""

from __future__ import annotations

import torch

from admmnet_tpu_torch.ops.atoms import COMPLEX


def assemble_lifted(h: torch.Tensor, phi: torch.Tensor, lam_inv_sq) -> torch.Tensor:
    """Build [[diag(h), phi], [phi^H, lam_inv_sq]] of shape (..., n+1, n+1).

    h: (..., n) real; phi: (..., n) complex; lam_inv_sq: scalar or (...,).
    """
    n = phi.shape[-1]
    batch = phi.shape[:-1]
    out = torch.zeros((*batch, n + 1, n + 1), dtype=COMPLEX, device=phi.device)
    idx = torch.arange(n, device=phi.device)
    out[..., idx, idx] = h.to(COMPLEX)
    out[..., :n, n] = phi
    out[..., n, :n] = torch.conj(phi)
    out[..., n, n] = torch.as_tensor(lam_inv_sq, dtype=COMPLEX, device=phi.device)
    return out


def lifted_topleft(M: torch.Tensor) -> torch.Tensor:
    """Upper-left n x n block of a lifted (..., n+1, n+1) matrix."""
    return M[..., :-1, :-1]


def lifted_corner_vec(M: torch.Tensor) -> torch.Tensor:
    """Last column without the corner: M[..., :n, n], shape (..., n)."""
    return M[..., :-1, -1]


def hermitianize(M: torch.Tensor) -> torch.Tensor:
    return 0.5 * (M + torch.conj(M.transpose(-1, -2)))


def fro_norm(M: torch.Tensor) -> torch.Tensor:
    """Frobenius norm over the trailing two dims, batched."""
    return torch.sqrt(torch.sum(torch.abs(M) ** 2, dim=(-1, -2)))


def vec_norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.abs(v) ** 2, dim=-1))


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Complex x with its real and imaginary parts rounded to bf16."""
    def rn(v):
        return v.to(torch.bfloat16).to(v.dtype)
    return torch.complex(rn(x.real), rn(x.imag))


def complex_matmul(a: torch.Tensor, b: torch.Tensor, one_pass: bool) -> torch.Tensor:
    """a @ b of complex tensors: one-pass (the real and imaginary parts of
    both operands rounded to bf16, the exact products summed in fp32, as
    ``Precision.DEFAULT`` on the MXU) or fp32."""
    return _bf16(a) @ _bf16(b) if one_pass else a @ b
