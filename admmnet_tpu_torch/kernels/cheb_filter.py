"""Clenshaw kernels of the chebyshev GLayer: sum_k c_k T_k(M / ||M||_F), its
training forward and its reversible backward.

Counterparts of ``admmnet_tpu/kernels/cheb_filter.py``:

- K4, ``cheb_filter_matrices`` (the inference forward): the CUDA kernel of
  ``csrc/cheb_filter.cu``;
- K5, ``_cheb_fwd_with_residuals`` (the training forward): the same kernel,
  which then also writes the final Clenshaw carries (b_1, b_2);
- K6, ``_cheb_bwd`` (the reversible, checkpoint-free backward): the CUDA
  kernel of ``csrc/cheb_bwd.cu``.

Both CUDA kernels run one thread-block cluster per matrix with its working
planes in the cluster's shared memory and every product on the tensor
cores (``csrc/tc_product.cuh``), at the TPU kernels' tiers (below).

Each has a plain version, the same dataflow in batched torch ops, which a
CPU tensor runs; a CUDA tensor launches the kernel.  ``ChebFilterFn`` wires
K5 and K6 (or their plain versions) into autograd, and
``cheb_filter_matrices`` takes it whenever a gradient is needed, on both
devices, so the CPU runs the same reversible math as the card.
``apply_spectral_filter_kernel`` is the GLayer's engine: it samples the
learned filter at the Chebyshev nodes, projects the samples onto
coefficients and scales by r in torch, as the JAX package does outside its
kernel, and runs the Clenshaw recurrence through ``cheb_filter_matrices``.

Forward dataflow: A = M / max(||M||_F, 1e-20); b_1 = b_2 = 0; for
j = degree-1 .. 1, b_0 = herm(c_j I + 2 A b_1 - b_2); out = herm(c_0 I +
A b_1 - b_2), herm(X) = (X + X^H)/2, every complex product a 3-product
Karatsuba.  The output is in the normalized domain (the caller scales by
r).  Precision follows the device, as ``Precision.DEFAULT`` does in JAX:
the TPU kernel's products are DEFAULT, one-pass bf16 on the MXU (its
closing product HIGHEST with ``final_hi``), and on the card every step's
product and the closing one without ``final_hi`` is a one-pass bf16
product (operands rounded to nearest-even bf16, Karatsuba's operand sums
formed in fp32 and rounded once, exact products summed in fp32), the
closing one with ``final_hi`` 3xTF32 (fp32-faithful).  On the CPU, where
DEFAULT is fp32, the plain version's products are IEEE fp32;
``one_pass=True`` makes them the card's one-pass products (the emulation
the kernel is held to).  The per-step re-projection is kept.

Backward (torch's complex convention: the conjugate of JAX's raw
cotangent), for the cotangent Y of out: V = herm(Y); cbar_0 = Re tr V;
Abar = V b_1; u = A V; v = -V; for j = 1 .. degree-2, with (s, t) =
(b_j, b_{j+1}) rebuilt upward from the carries: cbar_j = Re tr u,
Abar += 2 u t, (u, v) <- (v + 2 A u, -u), (s, t) <- (t, herm(c_j I + 2 A t
- s)); finally cbar_{degree-1} = Re tr u and, for degree >= 3, Abar += 2 u
t with t the rebuilt b_degree, as the JAX kernel adds it: b_degree is zero
in exact arithmetic, not when rebuilt from the carries of a one-pass
forward.  Then
the chain through the normalization, in torch ops:
Mbar = (Abar - Re(sum conj(A) Abar) A) / r.  The backward's tier is
``three_pass`` (``bwd_three_pass`` of the autograd path), the TPU kernel's
two: True (JAX's default) is its ``_mm3``, the 3-pass split-bf16 product
ah bh + ah bl + al bh with ah = bf16(a), al = a - ah; its three products
are DEFAULT, so on the MXU al and bl are rounded to bf16 too, and K6 on
the card computes that (three bf16 mma a 16-deep step).  False is
HIGHEST: 3xTF32 on the card.  The plain version with ``three_pass`` keeps
al and bl in fp32, as ``_mm3`` does on a CPU; with ``one_pass`` too it
rounds them, the emulation K6 is held to.  Without ``three_pass`` its
products are IEEE fp32.  The autograd path's default on a CPU tensor is
fp32, what the JAX GLayer computes off the TPU (its XLA fallback).
"""

from __future__ import annotations

import torch

from admmnet_tpu_torch.kernels import _build
from admmnet_tpu_torch.kernels.polar import bf16_rn, karatsuba, padded_side
from admmnet_tpu_torch.ops.chebyshev import filter_coefficients, spectral_bound
from admmnet_tpu_torch.utils import profiling

launches = profiling.LaunchCounter("K4")  # the inference forward
fwd_launches = profiling.LaunchCounter("K5")  # the training forward
bwd_launches = profiling.LaunchCounter("K6")  # the reversible backward


def _t(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


def _herm_planes(Xr: torch.Tensor, Xi: torch.Tensor):
    return 0.5 * (Xr + _t(Xr)), 0.5 * (Xi - _t(Xi))


def _trace(X: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(X, dim1=-2, dim2=-1).sum(-1)


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


# ---- plain versions: the kernels' dataflow in batched torch ops ------------


def _normalized(M: torch.Tensor):
    """(Ar, Ai) of A = M / max(||M||_F, 1e-20), in M's real precision."""
    Mr, Mi = M.real, M.imag
    s = torch.sum(Mr * Mr + Mi * Mi, dim=(-1, -2), keepdim=True)
    rinv = 1.0 / torch.clamp_min(torch.sqrt(s), 1e-20)
    return Mr * rinv, Mi * rinv


def cheb_filter_matrices_plain_with_residuals(M: torch.Tensor, coeffs: torch.Tensor,
                                              degree: int, one_pass: bool = False,
                                              final_hi: bool = False):
    """The training forward's computation in torch ops: (out, carries) with
    out complex (..., m, m) and carries the final (b_1, b_2) as the real
    planes (b1r, b1i, b2r, b2i), each (..., m, m).  complex64 inputs
    compute in fp32, complex128 inputs in fp64.  ``one_pass``: the card's
    products, one-pass bf16 (``karatsuba`` with ``bf16_rn``), the closing
    one too unless ``final_hi``; else every product is IEEE."""
    m = M.shape[-1]
    Ar, Ai = _normalized(M)
    c = coeffs.to(Ar.dtype)[..., None, None]
    eye = torch.eye(m, dtype=Ar.dtype, device=M.device)
    rnd = bf16_rn if one_pass else None
    b1r = b1i = b2r = b2i = torch.zeros_like(Ar)
    for j in range(degree - 1, 0, -1):
        Pr, Pi = karatsuba(Ar, Ai, b1r, b1i, False, rnd)
        b0r, b0i = _herm_planes((c[..., j, :, :] * eye + 2.0 * Pr) - b2r, 2.0 * Pi - b2i)
        b1r, b1i, b2r, b2i = b0r, b0i, b1r, b1i
    Pr, Pi = karatsuba(Ar, Ai, b1r, b1i, False, None if final_hi else rnd)
    outr, outi = _herm_planes((c[..., 0, :, :] * eye + Pr) - b2r, Pi - b2i)
    return torch.complex(outr, outi), (b1r, b1i, b2r, b2i)


def cheb_filter_matrices_plain(M: torch.Tensor, coeffs: torch.Tensor, degree: int,
                               one_pass: bool = False, final_hi: bool = False) -> torch.Tensor:
    """The kernel's computation in torch ops; complex64 (..., m, m) in/out
    (``one_pass``, ``final_hi``: as ``cheb_filter_matrices_plain_with_residuals``)."""
    return cheb_filter_matrices_plain_with_residuals(M, coeffs, degree, one_pass, final_hi)[0]


def cheb_bwd_plain(M: torch.Tensor, coeffs: torch.Tensor, carries, Y: torch.Tensor,
                   degree: int, three_pass: bool = False, one_pass: bool = False):
    """The reversible backward's computation in torch ops: (Abar, cbar) for
    the output cotangent Y (..., m, m), in the normalized domain and torch's
    complex convention.  ``carries``: the forward's (b1r, b1i, b2r, b2i),
    each (..., m, m).  ``three_pass`` makes every product the 3-pass
    split-bf16 product with fp32 residuals (``_mm3`` on a CPU); with
    ``one_pass`` too the residuals are rounded to bf16, as the MXU and K6
    round them."""
    if one_pass and not three_pass:
        raise ValueError("one_pass rounds the split product's residuals: it needs three_pass")
    m = M.shape[-1]
    Ar, Ai = _normalized(M)
    c = coeffs.to(Ar.dtype)[..., None, None]
    eye = torch.eye(m, dtype=Ar.dtype, device=M.device)
    rnd = bf16_rn if one_pass else None

    def kmul(Pr, Pi, Qr, Qi):
        return karatsuba(Pr, Pi, Qr, Qi, three_pass, rnd)

    Vr, Vi = _herm_planes(Y.real.to(Ar.dtype), Y.imag.to(Ar.dtype))
    sr, si, tr, ti = carries
    cbar = [_trace(Vr)]
    ABr, ABi = kmul(Vr, Vi, sr, si)
    ur, ui = kmul(Ar, Ai, Vr, Vi)
    vr, vi = -Vr, -Vi
    for j in range(1, degree - 1):
        cbar.append(_trace(ur))
        Pr, Pi = kmul(ur, ui, tr, ti)
        ABr, ABi = ABr + 2.0 * Pr, ABi + 2.0 * Pi
        Qr, Qi = kmul(Ar, Ai, ur, ui)
        ur, ui, vr, vi = vr + 2.0 * Qr, vi + 2.0 * Qi, -ur, -ui
        Rr, Ri = kmul(Ar, Ai, tr, ti)
        nr, ni = _herm_planes((c[..., j, :, :] * eye + 2.0 * Rr) - sr, 2.0 * Ri - si)
        sr, si, tr, ti = tr, ti, nr, ni
    if degree >= 2:
        cbar.append(_trace(ur))
    if degree >= 3:  # the rebuilt b_degree: zero only if the forward was exact
        Pr, Pi = kmul(ur, ui, tr, ti)
        ABr, ABi = ABr + 2.0 * Pr, ABi + 2.0 * Pi
    return torch.complex(ABr, ABi), torch.stack(cbar, dim=-1)


def normalization_backward(M: torch.Tensor, Abar: torch.Tensor) -> torch.Tensor:
    """Cotangent of M through A = M / max(||M||_F, 1e-20), given Abar, in
    torch's convention: (Abar - Re(sum conj(A) Abar) A) / r."""
    r = spectral_bound(M)
    A = M / r
    inner = torch.sum((torch.conj(A) * Abar).real, dim=(-1, -2), keepdim=True)
    return (Abar - inner * A) / r


# ---- the kernels ------------------------------------------------------------


def _planes(X: torch.Tensor, P: int):
    """Zero-padded contiguous (B, P, P) float32 planes of complex (B, m, m)."""
    m = X.shape[-1]
    pad = (0, P - m, 0, P - m)
    return (torch.nn.functional.pad(X.real.to(torch.float32), pad).contiguous(),
            torch.nn.functional.pad(X.imag.to(torch.float32), pad).contiguous())


def cheb_filter_planes(M: torch.Tensor, coeffs: torch.Tensor, degree: int,
                       final_hi: bool = False, carries: bool = False):
    """Launch K4 on CUDA tensors, or K5 with ``carries``: (Gr, Gi, carries),
    the zero-padded output planes, each (B, P, P) float32 with B the
    flattened batch, and K5's final carries (b1r, b1i, b2r, b2i), planes of
    the same shape (K4: ()).  The Clenshaw steps' products are one-pass
    bf16, the closing one too unless ``final_hi`` (3xTF32); K5's (Gr, Gi)
    equal K4's bit for bit at the same ``final_hi``."""
    P = _check(M, coeffs, degree)
    m = M.shape[-1]
    Mf = M.reshape(-1, m, m)
    B = Mf.shape[0]
    Mr, Mi = _planes(Mf, P)
    c = coeffs.reshape(B, degree).to(torch.float32).contiguous()
    Gr = torch.empty_like(Mr)
    Gi = torch.empty_like(Mi)
    res = tuple(torch.empty_like(Mr) for _ in range(4)) if carries else ()
    b1r, b1i, b2r, b2i = res or (None,) * 4
    _build.launch("cheb_filter_launch", fwd_launches if carries else launches, Mr=Mr, Mi=Mi,
                  coeffs=c, Gr=Gr, Gi=Gi, b1r=b1r, b1i=b1i, b2r=b2r, b2i=b2i, B=B, P=P, m=m,
                  degree=degree, final_hi=int(final_hi))
    return Gr, Gi, res


def cheb_bwd_planes(M: torch.Tensor, coeffs: torch.Tensor, carries, Y: torch.Tensor,
                    degree: int, three_pass: bool = True):
    """Launch K6 on CUDA tensors: (ABr, ABi, cbar), Abar's zero-padded planes
    (B, P, P) and cbar (B, degree), float32.  ``carries``: K5's four
    (B, P, P) planes; ``Y``: the output's cotangent, shaped like M.
    ``three_pass``: split-bf16 products (the JAX package's default), else
    3xTF32."""
    P = _check(M, coeffs, degree)
    if Y.shape != M.shape or Y.device != M.device:
        raise ValueError(f"cotangent {tuple(Y.shape)} on {Y.device} does not match M")
    m = M.shape[-1]
    Mf = M.reshape(-1, m, m)
    B = Mf.shape[0]
    if any(tuple(x.shape) != (B, P, P) or x.dtype != torch.float32 for x in carries):
        raise ValueError("carries must be K5's (B, P, P) float32 planes")
    Mr, Mi = _planes(Mf, P)
    Yr, Yi = _planes(Y.reshape(-1, m, m), P)
    c = coeffs.reshape(B, degree).to(torch.float32).contiguous()
    ABr = torch.empty_like(Mr)
    ABi = torch.empty_like(Mi)
    cbar = torch.empty((B, degree), dtype=torch.float32, device=M.device)
    b1r, b1i, b2r, b2i = carries
    _build.launch("cheb_bwd_launch", bwd_launches, Mr=Mr, Mi=Mi, coeffs=c, Yr=Yr,
                  Yi=Yi, b1r=b1r, b1i=b1i, b2r=b2r, b2i=b2i, ABr=ABr, ABi=ABi, cbar=cbar,
                  B=B, P=P, m=m, degree=degree, three_pass=int(three_pass))
    return ABr, ABi, cbar


def cheb_fwd_with_residuals(M: torch.Tensor, coeffs: torch.Tensor, degree: int,
                            final_hi: bool = False):
    """(out, carries) of the training forward: K5 for a CUDA tensor (carries
    as its padded planes), the plain version (fp32 products) for a CPU
    tensor."""
    if M.device.type == "cpu":
        return cheb_filter_matrices_plain_with_residuals(M, coeffs, degree)
    m = M.shape[-1]
    Gr, Gi, carries = cheb_filter_planes(M, coeffs, degree, final_hi, carries=True)
    return torch.complex(Gr[:, :m, :m], Gi[:, :m, :m]).reshape(M.shape), carries


def _bwd_tier(M: torch.Tensor, three_pass):
    """``bwd_three_pass`` resolved: None is the device's tier, the split
    product on the card (the JAX package's default) and fp32 on the CPU
    (what the JAX GLayer differentiates off the TPU)."""
    return M.device.type == "cuda" if three_pass is None else bool(three_pass)


def cheb_bwd(M: torch.Tensor, coeffs: torch.Tensor, carries, Y: torch.Tensor, degree: int,
             three_pass=None):
    """(Abar, cbar) of the reversible backward, in the normalized domain: K6
    for a CUDA tensor, ``cheb_bwd_plain`` for a CPU tensor; ``carries`` as
    ``cheb_fwd_with_residuals`` returned them on that device.  ``three_pass``:
    the split-bf16 tier (on a CPU tensor with fp32 residuals, as ``_mm3`` on
    a CPU), else fp32 products; None takes the device's (``_bwd_tier``)."""
    three_pass = _bwd_tier(M, three_pass)
    if M.device.type == "cpu":
        return cheb_bwd_plain(M, coeffs, carries, Y, degree, three_pass)
    m = M.shape[-1]
    ABr, ABi, cbar = cheb_bwd_planes(M, coeffs, carries, Y.contiguous(), degree, three_pass)
    Abar = torch.complex(ABr[:, :m, :m], ABi[:, :m, :m]).reshape(M.shape)
    return Abar, cbar.reshape(coeffs.shape)


class ChebFilterFn(torch.autograd.Function):
    """The normalized-domain Clenshaw evaluation with its reversible
    backward: forward K5 (CUDA) or its plain version (CPU), saving M, the
    coefficients and the final carries; backward K6 or ``cheb_bwd_plain``
    at ``bwd_three_pass`` (``cheb_bwd``), then ``normalization_backward``.
    On the CPU a complex128 M runs the plain versions in fp64 (for
    gradcheck)."""

    @staticmethod
    def forward(ctx, M, coeffs, degree: int, final_hi: bool = False, bwd_three_pass=None):
        out, carries = cheb_fwd_with_residuals(M, coeffs, degree, final_hi)
        ctx.save_for_backward(M, coeffs, *carries)
        ctx.degree = degree
        ctx.three_pass = bwd_three_pass
        return out

    @staticmethod
    def backward(ctx, gout):
        with profiling.span("models.glayer_bwd"):
            M, coeffs, *carries = ctx.saved_tensors
            Abar, cbar = cheb_bwd(M, coeffs, carries, gout, ctx.degree, ctx.three_pass)
            return normalization_backward(M, Abar), cbar.to(coeffs.dtype), None, None, None


def cheb_filter_matrices(M: torch.Tensor, coeffs: torch.Tensor, degree: int,
                         final_hi: bool = False, bwd_three_pass=None) -> torch.Tensor:
    """sum_k c_k T_k(M / ||M||_F) for batched Hermitian complex64 (..., m, m),
    m <= 128, with coefficients (..., degree) (c_0 pre-halved).

    When a gradient is needed this is ``ChebFilterFn`` (K5 + K6 on CUDA,
    their plain versions on the CPU; the backward at ``bwd_three_pass``,
    None for the device's tier).  Otherwise a CUDA tensor launches K4 (one
    thread-block cluster per matrix) and a CPU tensor runs
    ``cheb_filter_matrices_plain``.  Any other device raises.  On the card
    the products are one-pass bf16, the closing one 3xTF32 with
    ``final_hi``; on the CPU every product is fp32.
    """
    _check(M, coeffs, degree)
    if torch.is_grad_enabled() and (M.requires_grad or coeffs.requires_grad):
        return ChebFilterFn.apply(M, coeffs, degree, final_hi, bwd_three_pass)
    if M.device.type == "cpu":
        return cheb_filter_matrices_plain(M, coeffs, degree)
    if M.numel() == 0:
        return M.clone()
    m = M.shape[-1]
    Gr, Gi, _ = cheb_filter_planes(M, coeffs, degree, final_hi)
    return torch.complex(Gr[:, :m, :m], Gi[:, :m, :m]).reshape(M.shape)


def apply_spectral_filter_kernel(M: torch.Tensor, f, degree: int = 48) -> torch.Tensor:
    """f_mat(M) for Hermitian complex64 (..., m, m) and pointwise filter f,
    the Clenshaw recurrence through ``cheb_filter_matrices`` (the backward
    at the device's tier).

    Counterpart of ``apply_spectral_filter_pallas``: the filter sampling,
    the coefficient projection and the scaling by r = max(||M||_F, 1e-20)
    are torch ops around the kernel.
    """
    r = spectral_bound(M)
    c = filter_coefficients(r, f, degree)
    out = cheb_filter_matrices(M, c, degree)
    return (out * r.to(M.dtype)).to(M.dtype)
