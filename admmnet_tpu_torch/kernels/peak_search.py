"""Coarse-to-fine peak search of a batch of scenes in one CUDA launch.

Replaces no TPU kernel: the JAX package computes the search with XLA ops
(``admmnet_tpu/peaks/search.py``), and the port's plain version
(``peaks/search.py``) with about 60 small PyTorch launches a call, whose
dispatch set a single scene's latency on the card.  ``csrc/peak_search.cu``
runs each scene's whole search (coarse grid, local-maximum top-K, refine
rounds, sort) in one thread block, the grid in shared memory; its note says
what bounds it.  ``peaks.find_peaks`` sends a CUDA phi here and keeps the
plain version for CPU tensors.

The coarse axes, their steering and the refine's ``linspace`` come from
``peaks.search.search_constants``, built once per configuration, sizes and
device; the kernel computes the refine's steering itself, in ops/atoms.py's
fp32 operation order.  The refine's tier is the plain version's on the card
(``refine_precision="default"``: each product's operands rounded to bf16).
Tie rules: the first maximum of a refine window (``torch.argmax``'s) and
equal heights kept in their order (the stable ``argsort``'s), as the plain
version; equal candidate heights enter the top K in flat index order, one
of the orders ``torch.topk`` may give (it leaves theirs unspecified).
"""

from __future__ import annotations

import torch

from admmnet_tpu_torch.kernels import _build
from admmnet_tpu_torch.utils.profiling import LaunchCounter

MAX_PEAKS = 32  # K: one warp sorts a scene's list
MAX_POINTS = 32  # P: refine points per axis
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on an H100
THREADS = 256  # csrc/peak_search.cu's NT

launches = LaunchCounter("peaks")


def _align4(n: int) -> int:
    return (n + 3) & ~3


def smem_bytes(Nb: int, Nd: int, ny: int, nx: int, K: int, P: int) -> int:
    """Dynamic shared memory of a block: ``layout(...).total`` of
    csrc/peak_search.cu in bytes (the coarse stage's T, Dc, Z (S staged in
    its place first) and candidate bits, or the refine's per-warp scratch
    that reuses them, whichever is larger, beside conj(phi), the K peaks and
    the reduction slots).  The launcher refuses a launch whose count is not
    the C layout's, so a drift between the two fails every call."""
    warps = THREADS // 32
    phi = _align4(2 * Nb * Nd)
    coarse = (2 * Nd * (-(-ny // 4) * 4) + _align4(2 * Nd * nx)
              + _align4(max(ny * nx, 2 * ny * Nb)) + _align4(-(-(ny * nx) // 32)))
    refine = warps * (2 * _align4(P) + _align4(2 * P * Nb) + 2 * _align4(2 * P * Nd))
    return 4 * (phi + max(coarse, refine) + 4 * _align4(K) + _align4(2 * warps + 1))


def check_search(phi: torch.Tensor, Nb: int, Nd: int, cfg, ny: int, nx: int) -> int:
    """Raise, naming the limit, for what the kernel does not take (the
    device is ``_build.launch``'s to check); no CUDA call is made before
    these checks.  Returns the block's shared memory in
    bytes."""
    if phi.dtype != torch.complex64:
        raise TypeError(f"expected complex64 phi, got {phi.dtype}")
    if Nb < 1 or Nd < 1 or phi.dim() != 2 or phi.shape[-1] != Nb * Nd:
        raise ValueError(f"expected phi of shape (B, {Nb} * {Nd}), got {tuple(phi.shape)}")
    K, P = cfg.max_peaks, cfg.refine_points
    if not 1 <= K <= MAX_PEAKS:
        raise ValueError(f"max_peaks {K} outside the kernel's 1..{MAX_PEAKS}")
    if not 1 <= P <= MAX_POINTS:
        raise ValueError(f"refine_points {P} outside the kernel's 1..{MAX_POINTS}")
    if cfg.refine_iters < 1:
        raise ValueError(f"refine_iters {cfg.refine_iters}: the kernel needs at least one")
    if K > ny * nx:
        raise ValueError(f"max_peaks {K} exceeds the {ny} x {nx} coarse grid")
    need = smem_bytes(Nb, Nd, ny, nx, K, P)
    if need > SMEM_LIMIT:
        raise ValueError(f"a {ny} x {nx} coarse grid at Nb = {Nb}, Nd = {Nd}, max_peaks {K}, "
                         f"refine_points {P} needs {need} bytes of shared memory a block, "
                         f"above the kernel's {SMEM_LIMIT}")
    return need


def peak_search(phi: torch.Tensor, Nb: int, Nd: int, cfg, consts):
    """(tau, f, height, valid), each (B, max_peaks), of a CUDA complex64 phi
    (B, Nb * Nd) in one launch; ``consts`` is ``search_constants(cfg, Nb,
    Nd, phi.device)``.  Sorted by height, descending; padding entries have
    height -inf and valid False.  The outputs are fresh on every call."""
    ny, nx = consts.fs.numel(), consts.taus.numel()
    smem = check_search(phi, Nb, Nd, cfg, ny, nx)
    B, K = phi.shape[0], cfg.max_peaks
    dev = phi.device
    tau = torch.empty((B, K), dtype=torch.float32, device=dev)
    f = torch.empty_like(tau)
    height = torch.empty_like(tau)
    valid = torch.empty((B, K), dtype=torch.bool, device=dev)
    if B == 0:
        return tau, f, height, valid
    _build.launch(
        "peak_search_launch", launches, phi=phi, S=consts.S, DcT=consts.DcT,
        taus=consts.taus, fs=consts.fs, rel=consts.rel, tau=tau, f=f, height=height,
        valid=valid, B=B, Nb=Nb, Nd=Nd, ny=ny, nx=nx, K=K, P=cfg.refine_points, smem=smem,
        iters=cfg.refine_iters, one_pass=int(cfg.refine_precision == "default"),
        tau_lo=cfg.delay_min, tau_hi=cfg.delay_max - 1e-6, f_lo=cfg.doppler_min,
        f_hi=cfg.doppler_max - 1e-6, half_t=cfg.delay_step, half_f=cfg.doppler_step,
        reduce=cfg.reduce_factor)
    return tau, f, height, valid
