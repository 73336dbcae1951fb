"""Operand rounding of one-pass products, by the name a configuration gives
its tier: a one-pass product rounds each operand and sums the exact
products in float32.  Plain torch; nothing of the program."""

from __future__ import annotations

import torch

FP8_MAX = 448.0  # largest finite float8 e4m3


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """x rounded to tf32 (10 mantissa bits), ties away from zero, as the
    tensor cores' cvt.rna.tf32.f32 rounds."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & ~0x1FFF).view(torch.float32)


def bf16_rn(x: torch.Tensor) -> torch.Tensor:
    """x rounded to nearest-even bf16, as float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def fp8_rn(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 after scaling each matrix (the last two
    dimensions) by its largest magnitude, as float32."""
    scale = torch.clamp_min(torch.amax(torch.abs(x), dim=(-1, -2), keepdim=True),
                            1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


ROUNDERS = {"fp32": None, "tf32": tf32_rna, "bf16": bf16_rn, "fp8": fp8_rn}
# the next tier below each: the control of a configuration that states one
BELOW = {"fp32": "tf32", "tf32": "bf16", "bf16": "fp8"}


def rounder(tier: str):
    if tier not in ROUNDERS:
        raise ValueError(f"unknown tier {tier!r}; expected one of {sorted(ROUNDERS)}")
    return ROUNDERS[tier]


def round_complex(z: torch.Tensor, rnd) -> torch.Tensor:
    """A complex64 tensor with its real and imaginary planes rounded."""
    if rnd is None:
        return z
    return torch.complex(rnd(z.real.contiguous()), rnd(z.imag.contiguous()))


def cmm(a: torch.Tensor, b: torch.Tensor, rnd) -> torch.Tensor:
    """a @ b of complex64 tensors, one-pass at ``rnd`` (None: float32)."""
    return round_complex(a, rnd) @ round_complex(b, rnd)
