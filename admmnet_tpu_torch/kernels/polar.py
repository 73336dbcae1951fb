"""Polar PSD projection kernel: P = (M + |M|)/2 through a matrix-sign schedule.

Counterpart of ``admmnet_tpu/kernels/polar.py :: psd_project_polar_pallas``.
``psd_project_polar_kernel`` launches the CUDA kernel of ``csrc/polar.cu``
for a CUDA tensor and runs ``psd_project_polar_plain`` (the same dataflow
in batched torch ops) for a CPU tensor.

Modes, as in the JAX package:

- ``mode="accurate"``: the 7-step ``POLAR_QUINTIC_SCHEDULE``, every step
  "hi" (no Hermitian re-projection).
- ``mode="fast"``: the 6-step ``POLAR_BF16_SCHEDULE``, re-projected onto the
  Hermitian subspace after every step that is not "hi"; ``hi_steps=1``
  appends ``POLAR_BF16_POLISH`` as a hi step.  ``bf16_store=True`` keeps
  the iterate of the low steps in bf16 and rounds each of their products
  and elementwise results to bf16, as the JAX kernel's bf16 arithmetic
  does; the hi steps and the closing products run on the fp32 iterate.

Precision rule, the JAX package's own: a hi step's products and the
closing |M| products are fp32 products; a low step's products are
one-pass products, as ``jax.lax.Precision.DEFAULT`` is: each operand (an
operand sum of the Karatsuba form is formed in fp32 first) is rounded to
nearest-even bf16, and the exact products are summed in fp32.  The tier
follows the device, as DEFAULT does in JAX.  On the card, fp32 products
run in 3xTF32 on the tensor cores (three TF32 products per product,
fp32-faithful) and one-pass products as bf16 ``mma.sync`` m16n8k16 with
fp32 accumulation.  On the CPU, where DEFAULT is fp32 in JAX, the plain
version computes every product in IEEE fp32; ``one_pass=True`` makes it
round the low products' operands as the card does (the reference that the
kernel is held to; no caller on the main path sets it).  With
``bf16_store`` the low steps' operands are bf16-valued already, so the
plain version's and the kernel's terms are the same exact products and
only the order of their fp32 sums differs.  The kernel computes each
whole product in one thread block (P = 112, m <= 112) or one cluster of
two (P = 128, m <= 128), the planes in shared memory
(``csrc/polar_cta.cuh``).  The matrices are zero-padded to P; zero
eigenvalues are fixed points of every schedule, so the padding is exact.
"""

from __future__ import annotations

import numpy as np
import torch

from admmnet_tpu_torch.kernels import _build
from admmnet_tpu_torch.ops.projections import (
    POLAR_BF16_POLISH,
    POLAR_BF16_SCHEDULE,
    POLAR_QUINTIC_SCHEDULE,
)
from admmnet_tpu_torch.utils.profiling import LaunchCounter

MAX_SIDE = 128

launches = LaunchCounter("K1")


def padded_side(m: int) -> int:
    """Plane side of the kernel for a logical side m (112 or 128)."""
    if m > MAX_SIDE:
        raise ValueError(f"matrix side {m} exceeds {MAX_SIDE}")
    return 112 if m <= 112 else 128


def schedule_for(mode: str, hi_steps):
    """(schedule, hi_steps) of a mode, as the JAX wrapper resolves them."""
    if mode == "fast":
        hi_steps = 0 if hi_steps is None else hi_steps
        schedule = POLAR_BF16_SCHEDULE + ((POLAR_BF16_POLISH,) if hi_steps >= 1 else ())
    elif mode == "accurate":
        schedule = POLAR_QUINTIC_SCHEDULE
        hi_steps = len(schedule) if hi_steps is None else hi_steps
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return tuple(schedule), int(hi_steps)


# ---- plain version: the kernel's dataflow in batched torch ops -------------


def bf16_rn(x: torch.Tensor) -> torch.Tensor:
    """x rounded to nearest-even bf16, as float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """x rounded to tf32 (10 mantissa bits), ties away from zero."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & ~0x1FFF).view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, split: bool, one_pass_round=None) -> torch.Tensor:
    """fp32 product; the 3-pass split-bf16 product ah bh + ah bl + al bh
    (x = xh + xl, xh = bf16_rn(x), xl = x - xh in fp32) with ``split``; the
    one-pass product rnd(a) rnd(b), summed in fp32, with ``one_pass_round``
    = rnd (``bf16_rn``: the JAX package's DEFAULT, K1's tier on the card;
    ``tf32_rna``: K2's and K3's).  With both, the split product of one-pass
    products, whose residuals are rounded too: xl = rnd(x - xh) (the JAX
    package's ``_mm3`` on the MXU, K6's split tier)."""
    if split:
        ah = bf16_rn(a)
        bh = bf16_rn(b)
        al, bl = a - ah, b - bh
        if one_pass_round is not None:
            al, bl = one_pass_round(al), one_pass_round(bl)
        return ah @ bh + ah @ bl + al @ bh
    if one_pass_round is not None:
        return one_pass_round(a) @ one_pass_round(b)
    return a @ b


def _t(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


def herm_square(Xr, Xi, split, one_pass_round=None):
    """X^2 of Hermitian X in 3 real products: X2i = XrXi - (XrXi)^T."""
    XrXi = mm(Xr, Xi, split, one_pass_round)
    return (mm(Xr, Xr, split, one_pass_round) - mm(Xi, Xi, split, one_pass_round),
            XrXi - _t(XrXi))


def karatsuba(Ar, Ai, Br, Bi, split, one_pass_round=None):
    """(Ar + i Ai)(Br + i Bi) in 3 real products (the operand sums in
    fp32)."""
    t1 = mm(Ar, Br, split, one_pass_round)
    t2 = mm(Ai, Bi, split, one_pass_round)
    t3 = mm(Ar + Ai, Br + Bi, split, one_pass_round)
    return t1 - t2, t3 - t1 - t2


def frobenius_inv(Mr, Mi):
    s = torch.sum(Mr * Mr, dim=(-1, -2), keepdim=True) + torch.sum(
        Mi * Mi, dim=(-1, -2), keepdim=True
    )
    return 1.0 / torch.clamp_min(torch.sqrt(s), 1e-30)


def _bf16(x: float) -> float:
    return float(torch.tensor(x, dtype=torch.float32).to(torch.bfloat16))


def bf16_step(Xr, Xi, a, b, c):
    """One low schedule step with bf16 iterate storage, on bfloat16 planes:
    each product accumulates in fp32 and is rounded once; each elementwise
    op (the polynomial's terms and sums, the Karatsuba sums and
    differences, the Hermitian re-projection) rounds its result, with the
    coefficients rounded first, as the JAX kernel's bf16 arithmetic does."""
    def mm_lo(x, y):
        return (x.to(torch.float32) @ y.to(torch.float32)).to(torch.bfloat16)

    def square(Xr, Xi):
        XrXi = mm_lo(Xr, Xi)
        return mm_lo(Xr, Xr) - mm_lo(Xi, Xi), XrXi - _t(XrXi)

    a, b, c = _bf16(a), _bf16(b), _bf16(c)
    eye = torch.eye(Xr.shape[-1], dtype=torch.bfloat16, device=Xr.device)
    X2r, X2i = square(Xr, Xi)
    X4r, X4i = square(X2r, X2i)
    Yr = a * eye + b * X2r + c * X4r
    Yi = b * X2i + c * X4i
    t1 = mm_lo(Xr, Yr)
    t2 = mm_lo(Xi, Yi)
    t3 = mm_lo(Xr + Xi, Yr + Yi)
    Xr = t1 - t2
    Xi = t3 - t1 - t2
    return 0.5 * (Xr + _t(Xr)), 0.5 * (Xi - _t(Xi))


def sign_schedule(Xr, Xi, schedule, hi_steps, all_hi=False, three_pass=False,
                  bf16_store=False, one_pass_round=None):
    """Apply the sign schedule to the scaled iterate X.  Step s is "hi" iff
    all_hi or s >= nsteps - hi_steps; hi products are split iff three_pass;
    the iterate is re-projected after a step iff it is not hi or three_pass.
    ``bf16_store``: the low steps run ``bf16_step`` on the iterate rounded
    to bf16; it is promoted to fp32 at the first hi step.
    ``one_pass_round``: the low steps' products are one-pass (``mm``)."""
    nsteps = len(schedule)
    eye = torch.eye(Xr.shape[-1], dtype=Xr.dtype, device=Xr.device)
    if bf16_store:
        Xr, Xi = Xr.to(torch.bfloat16), Xi.to(torch.bfloat16)
    for s, (a, b, c) in enumerate(schedule):
        hi = all_hi or s >= nsteps - hi_steps
        if bf16_store and not hi:
            Xr, Xi = bf16_step(Xr, Xi, a, b, c)
            continue
        Xr, Xi = Xr.to(torch.float32), Xi.to(torch.float32)
        split = hi and three_pass
        rnd = None if hi else one_pass_round
        X2r, X2i = herm_square(Xr, Xi, split, rnd)
        X4r, X4i = herm_square(X2r, X2i, split, rnd)
        Yr = a * eye + b * X2r + c * X4r
        Yi = b * X2i + c * X4i
        Xr, Xi = karatsuba(Xr, Xi, Yr, Yi, split, rnd)
        if not hi or three_pass:
            Xr = 0.5 * (Xr + _t(Xr))
            Xi = 0.5 * (Xi - _t(Xi))
    return Xr.to(torch.float32), Xi.to(torch.float32)


def abs_product(Xr, Xi, Mr, Mi, split, one_pass_round=None):
    """A = Hermitian part of S M, S the sign iterate: |M| in M's scale."""
    Ar, Ai = karatsuba(Xr, Xi, Mr, Mi, split, one_pass_round)
    return 0.5 * (Ar + _t(Ar)), 0.5 * (Ai - _t(Ai))


def psd_project_polar_plain(M: torch.Tensor, mode: str = "accurate",
                            hi_steps=None, bf16_store: bool = False,
                            one_pass: bool = False) -> torch.Tensor:
    """The kernel's computation in torch ops; complex64 (..., m, m) in/out.
    ``one_pass``: the low steps' products as the card computes them (module
    docstring)."""
    schedule, hi_steps = schedule_for(mode, hi_steps)
    return polar_plain_schedule(M, schedule, hi_steps, bf16_store and mode == "fast",
                                one_pass)


def polar_plain_schedule(M, schedule, hi_steps, bf16_store, one_pass):
    """``psd_project_polar_plain`` with any schedule (as ``launch_schedule``
    takes it)."""
    Mr = M.real.to(torch.float32)
    Mi = M.imag.to(torch.float32)
    inv = frobenius_inv(Mr, Mi)
    Xr, Xi = sign_schedule(Mr * inv, Mi * inv, schedule, hi_steps, bf16_store=bf16_store,
                           one_pass_round=bf16_rn if one_pass else None)
    Ar, Ai = abs_product(Xr, Xi, Mr, Mi, False)
    Pr = 0.5 * (Mr + Ar)
    Pi = 0.5 * (Mi + Ai)
    return torch.complex(0.5 * (Pr + _t(Pr)), 0.5 * (Pi - _t(Pi)))


# ---- the kernel -------------------------------------------------------------


def _check_matrix(M: torch.Tensor) -> int:
    if M.dtype != torch.complex64:
        raise TypeError(f"expected complex64, got {M.dtype}")
    if M.dim() < 2 or M.shape[-1] != M.shape[-2]:
        raise ValueError(f"expected (..., m, m), got {tuple(M.shape)}")
    return padded_side(M.shape[-1])


def psd_project_polar_kernel(M: torch.Tensor, mode: str = "accurate",
                             hi_steps=None, bf16_store: bool = False) -> torch.Tensor:
    """PSD projection of batched Hermitian complex64 (..., m, m), m <= 128.

    A CUDA tensor launches the CUDA kernel (one thread block per matrix, or
    a cluster of two at P = 128; tensor-core products in the module's
    precision rule); a CPU tensor runs ``psd_project_polar_plain``.  Any
    other device raises.  ``bf16_store`` (fast mode only, as in the JAX
    package) keeps the iterate of the low steps in bf16.
    """
    _check_matrix(M)
    if M.device.type == "cpu":
        return psd_project_polar_plain(M, mode, hi_steps, bf16_store)
    batch_shape, m = M.shape[:-2], M.shape[-1]
    if M.numel() == 0:
        return M.clone()
    Pr, Pi = psd_project_polar_planes(M, mode, hi_steps, bf16_store)
    out = torch.complex(Pr[:, :m, :m], Pi[:, :m, :m])
    return out.reshape(*batch_shape, m, m)


def psd_project_polar_planes(M: torch.Tensor, mode: str = "accurate", hi_steps=None,
                             bf16_store: bool = False):
    """Launch K1 on a CUDA tensor (..., m, m); returns its zero-padded output
    planes (Pr, Pi), each (B, P, P) float32 with B the flattened batch."""
    schedule, hi_steps = schedule_for(mode, hi_steps)
    return launch_schedule(M, schedule, hi_steps, bf16_store and mode == "fast")


def launch_schedule(M: torch.Tensor, schedule, hi_steps: int, bf16_store: bool):
    """``psd_project_polar_planes`` with any schedule of at most 8 steps:
    K1's launcher, whose low steps run one-pass (the card's tier)."""
    P = _check_matrix(M)
    m = M.shape[-1]
    Mf = M.reshape(-1, m, m)
    pad = (0, P - m, 0, P - m)
    Mr = torch.nn.functional.pad(Mf.real, pad).contiguous()
    Mi = torch.nn.functional.pad(Mf.imag, pad).contiguous()
    Pr = torch.empty_like(Mr)
    Pi = torch.empty_like(Mi)
    coeffs = np.ascontiguousarray(schedule, dtype=np.float32)
    _build.launch("polar_psd_launch", launches, Mr=Mr, Mi=Mi, Pr=Pr, Pi=Pi,
                  B=Mf.shape[0], P=P, m=m, coeffs=coeffs.ctypes.data, nsteps=len(schedule),
                  hi_steps=int(hi_steps), bf16_store=int(bf16_store))
    return Pr, Pi
