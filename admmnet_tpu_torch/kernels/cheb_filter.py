"""Clenshaw kernel of the chebyshev GLayer: sum_k c_k T_k(M / ||M||_F).

Counterpart of ``admmnet_tpu/kernels/cheb_filter.py ::
cheb_filter_matrices`` (the inference forward).  ``cheb_filter_matrices``
launches the CUDA kernel of ``csrc/cheb_filter.cu`` for a CUDA tensor and
runs ``cheb_filter_matrices_plain`` (the same dataflow in batched torch
ops) for a CPU tensor.  ``apply_spectral_filter_kernel`` is the GLayer's
engine: it samples the learned filter at the Chebyshev nodes, projects the
samples onto coefficients and scales by r in torch, as the JAX package
does outside its kernel, and runs the Clenshaw recurrence through
``cheb_filter_matrices``.

Dataflow (kernel and plain version alike): A = M / max(||M||_F, 1e-20);
b_1 = b_2 = 0; for j = degree-1 .. 1, b_0 = herm(c_j I + 2 A b_1 - b_2);
out = herm(c_0 I + A b_1 - b_2), herm(X) = (X + X^H)/2, every complex
product a 3-product Karatsuba in IEEE fp32.  The output is in the
normalized domain (the caller scales by r).  The TPU kernel's one-pass bf16
products become fp32 products; its per-step re-projection is kept.

The kernel has no backward yet (the port of training adds it): a CUDA call
that would need a gradient raises.
"""

from __future__ import annotations

import torch

from admmnet_tpu_torch.kernels.polar import LaunchCounter, karatsuba, padded_side
from admmnet_tpu_torch.ops.chebyshev import filter_coefficients, spectral_bound

SCRATCH_PLANES = 7

launches = LaunchCounter()


def _t(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


def _check(M: torch.Tensor, coeffs: torch.Tensor, degree: int) -> int:
    if M.dtype != torch.complex64:
        raise TypeError(f"expected complex64, got {M.dtype}")
    if M.dim() < 2 or M.shape[-1] != M.shape[-2]:
        raise ValueError(f"expected (..., m, m), got {tuple(M.shape)}")
    if degree < 1 or tuple(coeffs.shape) != (*M.shape[:-2], degree):
        raise ValueError(
            f"coeffs {tuple(coeffs.shape)} do not match M {tuple(M.shape)} "
            f"and degree {degree}")
    if coeffs.device != M.device:
        raise ValueError(f"coeffs on {coeffs.device}, M on {M.device}")
    return padded_side(M.shape[-1])


def cheb_filter_matrices_plain(M: torch.Tensor, coeffs: torch.Tensor,
                               degree: int) -> torch.Tensor:
    """The kernel's computation in torch ops; complex64 (..., m, m) in/out."""
    m = M.shape[-1]
    Mr = M.real.to(torch.float32)
    Mi = M.imag.to(torch.float32)
    s = torch.sum(Mr * Mr + Mi * Mi, dim=(-1, -2), keepdim=True)
    rinv = 1.0 / torch.clamp_min(torch.sqrt(s), 1e-20)
    Ar, Ai = Mr * rinv, Mi * rinv
    c = coeffs.to(torch.float32)[..., None, None]
    eye = torch.eye(m, dtype=torch.float32, device=M.device)
    b1r = b1i = b2r = b2i = torch.zeros_like(Mr)
    for j in range(degree - 1, 0, -1):
        Pr, Pi = karatsuba(Ar, Ai, b1r, b1i, False)
        b0r = (c[..., j, :, :] * eye + 2.0 * Pr) - b2r
        b0i = 2.0 * Pi - b2i
        b0r, b0i = 0.5 * (b0r + _t(b0r)), 0.5 * (b0i - _t(b0i))
        b1r, b1i, b2r, b2i = b0r, b0i, b1r, b1i
    Pr, Pi = karatsuba(Ar, Ai, b1r, b1i, False)
    outr = (c[..., 0, :, :] * eye + Pr) - b2r
    outi = Pi - b2i
    return torch.complex(0.5 * (outr + _t(outr)), 0.5 * (outi - _t(outi)))


def cheb_filter_planes(M: torch.Tensor, coeffs: torch.Tensor, degree: int):
    """Launch the kernel on CUDA tensors; returns its zero-padded output
    planes (Gr, Gi), each (B, P, P) float32 with B the flattened batch."""
    P = _check(M, coeffs, degree)
    if M.device.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, got {M.device}")
    from admmnet_tpu_torch.kernels import _build

    m = M.shape[-1]
    Mf = M.reshape(-1, m, m)
    B = Mf.shape[0]
    pad = (0, P - m, 0, P - m)
    Mr = torch.nn.functional.pad(Mf.real, pad).contiguous()
    Mi = torch.nn.functional.pad(Mf.imag, pad).contiguous()
    c = coeffs.reshape(B, degree).to(torch.float32).contiguous()
    Gr = torch.empty_like(Mr)
    Gi = torch.empty_like(Mi)
    scratch = torch.empty((B, SCRATCH_PLANES, P, P), dtype=torch.float32, device=M.device)
    lib = _build.lib()
    with torch.cuda.device(M.device):
        err = lib.cheb_filter_launch(
            Mr.data_ptr(), Mi.data_ptr(), c.data_ptr(), Gr.data_ptr(), Gi.data_ptr(),
            None, None, None, None, scratch.data_ptr(), B, P, m, degree,
            torch.cuda.current_stream(M.device).cuda_stream,
        )
    _build.check(err, "cheb_filter_launch")
    launches.count += 1
    return Gr, Gi


def cheb_filter_matrices(M: torch.Tensor, coeffs: torch.Tensor, degree: int) -> torch.Tensor:
    """sum_k c_k T_k(M / ||M||_F) for batched Hermitian complex64 (..., m, m),
    m <= 128, with coefficients (..., degree) (c_0 pre-halved).

    A CUDA tensor launches the CUDA kernel (one thread block per matrix); a
    CPU tensor runs ``cheb_filter_matrices_plain``.  Any other device
    raises, and so does a CUDA call that would need a gradient.
    """
    _check(M, coeffs, degree)
    if M.device.type == "cpu":
        return cheb_filter_matrices_plain(M, coeffs, degree)
    if M.device.type != "cuda":
        raise ValueError(f"unsupported device {M.device}")
    if torch.is_grad_enabled() and (M.requires_grad or coeffs.requires_grad):
        raise NotImplementedError("the Clenshaw kernel has no backward yet")
    if M.numel() == 0:
        return M.clone()
    m = M.shape[-1]
    Gr, Gi = cheb_filter_planes(M, coeffs, degree)
    return torch.complex(Gr[:, :m, :m], Gi[:, :m, :m]).reshape(M.shape)


def apply_spectral_filter_kernel(M: torch.Tensor, f, degree: int = 48) -> torch.Tensor:
    """f_mat(M) for Hermitian complex64 (..., m, m) and pointwise filter f,
    the Clenshaw recurrence through ``cheb_filter_matrices``.

    Counterpart of ``apply_spectral_filter_pallas``: the filter sampling,
    the coefficient projection and the scaling by r = max(||M||_F, 1e-20)
    are torch ops around the kernel.
    """
    r = spectral_bound(M)
    c = filter_coefficients(r, f, degree)
    out = cheb_filter_matrices(M, c, degree)
    return (out * r.to(M.dtype)).to(M.dtype)
