"""Batched Hermitian eigendecomposition in one CUDA launch: the eigh
GLayer's solver on the card.

Replaces no TPU kernel: the JAX package's eigh GLayer calls
``jnp.linalg.eigh`` (XLA's own solver on the TPU).  The port's plain path,
``ops.projections.hermitian_eigh``, casts to complex128 and calls
``torch.linalg.eigh``, which on the card solves a batch of sides above 32
one matrix at a time.  ``csrc/eigh_jacobi.cu`` solves each matrix of the
batch in its own thread block, A and V in shared memory, by the two-sided
cyclic Jacobi method in round-robin order, in complex64 (the JAX package's
precision).  A is kept as its upper triangle (an entry below the diagonal
is the conjugate of its mirror), so each round rotates every unordered
pair of 2 x 2 blocks once and A stays exactly Hermitian; the round's block
pairs and V's updates are dealt over all 1024 threads by a rule derived
from the side alone.  Its note gives the algorithm, the deal and what
bounds it.

- ``eigh_kernel(M)``: (w, V) of the hermitianized (..., m, m) complex64
  CUDA tensor M, w float32 ascending and V complex64, the contract of
  ``torch.linalg.eigh``; m up to ``MAX_SIDE``;
- ``eigh_jacobi_plain(M)``: the same algorithm in batched torch operations
  (the same pairs, rotations, threshold and stop), in M's precision: the
  kernel's plain version, which a CPU tensor runs;
- ``eigh_detached(M)``: the eigh GLayer's eigendecomposition under
  autograd, with V detached: the gradient flows through the eigenvalues
  only, M_bar = V diag(w_bar) V^H, what ``torch.linalg.eigh``'s backward
  gives when V carries no gradient.  It launches the kernel, so M is what
  ``eigh_kernel`` takes: a larger side, or a CPU tensor, raises.  Its
  backward is the span ``models.eigh_bwd``.
"""

from __future__ import annotations

import torch

from admmnet_tpu_torch.kernels import _build
from admmnet_tpu_torch.utils import profiling
from admmnet_tpu_torch.utils.profiling import LaunchCounter

SMEM_LIMIT = 232448  # bytes of shared memory a block may use on an H100
THREADS = 1024  # csrc/eigh_jacobi.cu's NT
MAX_SWEEPS = 30  # a batch of the GLayer's matrices stops after 6-10
TOL_REL = 2.0**-24  # fp32's unit roundoff: a pair rotates while |a_pq| > TOL_REL ||A||_F / m

launches = LaunchCounter("eigh")


def smem_bytes(m: int) -> int:
    """Dynamic shared memory of a block: ``layout(m).total`` of
    csrc/eigh_jacobi.cu (A at the odd row stride mp + 1, V^T, the round's
    rotations, which the sort's permutation reuses, and the norm's partial
    sums)."""
    mp = m + (m & 1)
    return 8 * mp * (mp + 1) + 8 * mp * mp + 16 * (mp // 2) + 4 * (THREADS // 32)


MAX_SIDE = max(m for m in range(1, 257) if smem_bytes(m) <= SMEM_LIMIT)  # 120


def round_robin(mp: int, r: int):
    """(p, q) index tensors of round ``r``'s mp / 2 pairs: r with mp - 1, and
    (r + k) mod (mp - 1) with (r - k) mod (mp - 1) for k = 1 .. mp/2 - 1."""
    n1 = mp - 1
    k = torch.arange(mp // 2)
    p = torch.where(k == 0, torch.tensor(r), (r + k) % n1)
    q = torch.where(k == 0, torch.tensor(n1), (r - k) % n1)
    return p, q


def _herm(M: torch.Tensor) -> torch.Tensor:
    return 0.5 * (M + torch.conj(M.transpose(-1, -2)))


def eigh_jacobi_plain(M: torch.Tensor, sweeps: bool = False):
    """The kernel's algorithm in batched torch operations, in M's precision
    (complex64 or complex128): (w, V), and the number of sweeps each matrix
    rotated in with ``sweeps``.  Every matrix runs until a sweep of its own
    rotates nothing (or ``MAX_SWEEPS``); the batch until all have."""
    if not M.is_complex():
        raise TypeError(f"expected a complex M, got {M.dtype}")
    batch, m = M.shape[:-2], M.shape[-1]
    A = _herm(M.reshape(-1, m, m))
    B = A.shape[0]
    mp = m + (m & 1)
    if mp != m:
        A = torch.nn.functional.pad(A, (0, 1, 0, 1))
    V = torch.zeros((B, m, mp), dtype=A.dtype, device=A.device)
    V[:, :, :m] = torch.eye(m, dtype=A.dtype, device=A.device)
    eye = torch.arange(mp, device=A.device)
    A[:, eye, eye] = A[:, eye, eye].real.to(A.dtype)
    # the kernel's TOL_REL at complex64, the unit roundoff of M's precision
    u = torch.finfo(A.real.dtype).eps / 2
    tol = u * torch.linalg.vector_norm(A, dim=(-2, -1)) / m  # (B,)
    done = torch.zeros(B, dtype=torch.bool, device=A.device)
    count = torch.zeros(B, dtype=torch.int32, device=A.device)
    for _ in range(MAX_SWEEPS):
        rotated = torch.zeros(B, dtype=torch.bool, device=A.device)
        for r in range(mp - 1):
            p, q = (x.to(A.device) for x in round_robin(mp, r))
            a, d, g = A[:, p, p].real, A[:, q, q].real, A[:, p, q]
            ag = torch.abs(g)
            on = ag > tol[:, None]
            if not bool(on.any()):
                continue
            rotated |= on.any(-1)
            safe = torch.where(on, ag, torch.ones_like(ag))
            tau = (d - a) / (2.0 * safe)
            t = torch.copysign(torch.ones_like(tau), tau) / (torch.abs(tau)
                                                             + torch.sqrt(tau * tau + 1.0))
            c = 1.0 / torch.sqrt(t * t + 1.0)
            z = (t * c).to(A.dtype) * (g / safe)
            c = torch.where(on, c, torch.ones_like(c))
            z = torch.where(on, z, torch.zeros_like(z))
            tb = torch.where(on, t * ag, torch.zeros_like(ag))
            cc, zz = c[..., None].to(A.dtype), z[..., None]
            Ap, Aq = A[:, p, :], A[:, q, :]
            A[:, p, :] = cc * Ap - zz * Aq
            A[:, q, :] = torch.conj(zz) * Ap + cc * Aq
            cc, zz = c[:, None, :].to(A.dtype), z[:, None, :]
            Ap, Aq = A[:, :, p], A[:, :, q]
            A[:, :, p] = cc * Ap - torch.conj(zz) * Aq
            A[:, :, q] = zz * Ap + cc * Aq
            Vp, Vq = V[:, :, p], V[:, :, q]
            V[:, :, p] = cc * Vp - torch.conj(zz) * Vq
            V[:, :, q] = zz * Vp + cc * Vq
            zero = torch.zeros_like(g)
            A[:, p, p] = torch.where(on, (a - tb).to(A.dtype), A[:, p, p])
            A[:, q, q] = torch.where(on, (d + tb).to(A.dtype), A[:, q, q])
            A[:, p, q] = torch.where(on, zero, A[:, p, q])
            A[:, q, p] = torch.where(on, zero, A[:, q, p])
        count += (rotated & ~done).to(torch.int32)
        done |= ~rotated
        if bool(done.all()):
            break
    w = A[:, eye[:m], eye[:m]].real
    key = torch.where(torch.isnan(w), torch.full_like(w, float("inf")), w)
    order = torch.sort(key, dim=-1, stable=True).indices
    w = torch.gather(w, -1, order)
    V = torch.gather(V[:, :, :m], -1, order[:, None, :].expand(B, m, m))
    out = (w.reshape(*batch, m), V.reshape(*batch, m, m))
    return out + (count.reshape(batch),) if sweeps else out


def check_side(M: torch.Tensor) -> int:
    """Raise for what the kernel does not take (the device is
    ``_build.launch``'s to check); no CUDA call is made before these
    checks.  Returns the block's shared memory in bytes."""
    if M.dtype != torch.complex64:
        raise TypeError(f"expected complex64 M, got {M.dtype}")
    if M.dim() < 2 or M.shape[-1] != M.shape[-2]:
        raise ValueError(f"expected (..., m, m) matrices, got {tuple(M.shape)}")
    m = M.shape[-1]
    if not 1 <= m <= MAX_SIDE:
        raise ValueError(f"matrix side {m} outside the kernel's 1..{MAX_SIDE}")
    return smem_bytes(m)


def eigh_kernel(M: torch.Tensor, sweeps: bool = False):
    """(w, V) of the hermitianized CUDA complex64 M (..., m, m) in one launch:
    w float32 ascending, V complex64 with the eigenvectors as columns; and
    each matrix's number of rotating sweeps (int32) with ``sweeps`` (equal
    to ``MAX_SWEEPS``: not converged).  The outputs are fresh on every
    call."""
    smem = check_side(M)
    batch, m = M.shape[:-2], M.shape[-1]
    B = M.numel() // (m * m)
    dev = M.device
    w = torch.empty((*batch, m), dtype=torch.float32, device=dev)
    V = torch.empty((*batch, m, m), dtype=torch.complex64, device=dev)
    count = torch.empty(batch, dtype=torch.int32, device=dev)
    if B:
        _build.launch("eigh_jacobi_launch", launches, M=M, w=w, V=V, sweeps=count, B=B,
                      m=m, max_sweeps=MAX_SWEEPS, smem=smem)
    return (w, V, count) if sweeps else (w, V)


def _solve(M: torch.Tensor):
    return eigh_kernel(M.contiguous())


class _EighDetached(torch.autograd.Function):
    @staticmethod
    def forward(ctx, M):
        w, V = _solve(M)
        ctx.mark_non_differentiable(V)
        ctx.save_for_backward(V)
        return w, V

    @staticmethod
    def backward(ctx, w_bar, _):
        with profiling.span("models.eigh_bwd"):
            (V,) = ctx.saved_tensors
            return (V * w_bar.to(V.dtype)[..., None, :]) @ torch.conj(V.transpose(-1, -2))


def eigh_detached(M: torch.Tensor):
    """(w, V) of herm(M), the gradient through w alone (module docstring)."""
    return _EighDetached.apply(M)
