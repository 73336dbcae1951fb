"""Limits and checks that hold the port's CUDA kernels to their plain
versions on the card, shared by the card tests (``test_torch_cuda.py``)
and ``chip_smoke.py``, which applies them to its timing inputs.  Each
limit carries the measurement it was set from.  Imports torch, numpy and
the port only."""

import numpy as np
import torch


def rel_err(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-instance relative Frobenius error of a against b."""
    a = a.reshape(a.shape[0], -1)
    b = b.reshape(b.shape[0], -1)
    return torch.linalg.norm(a - b, dim=-1) / torch.linalg.norm(b, dim=-1)


# K1 per matrix: the accurate mode (all fp32) vs its plain version, the
# fast modes (one-pass bf16 low steps, with or without bf16_store) vs
# their emulation (the plain version with one_pass) at the JAX package's
# 8e-3 ceiling for the fast tier's noise on the median matrix, 1e-2 on the
# worst, where a flipped rounding is carried by the later low steps
K1_PLAIN = 1e-4
K1_ONE_PASS = {"median": 8e-3, "max": 1e-2}
# K2 and K3 per instance vs their one-pass emulation (test_torch_cuda.py's
# docstring: the tf32 tier measured median 2.8e-3, max 1.1e-2 after 100
# iterations on an H100, a bf16 tier 2.2e-2 / 7.9e-2); the edge sides'
# knobs amplify the roundings (K2_ONE_PASS_EDGES)
K2_ONE_PASS = {"median": 1e-2, "max": 2e-2}
K2_ONE_PASS_EDGES = {"median": 3e-2, "max": 4e-2}

# K4/K5 vs their one-pass emulation (the plain version with one_pass: the
# same bf16 operands, fp32 sums in the plain version's order), per matrix:
# a sum in another order flips a bf16 rounding now and then and the later
# steps carry it.  tests/one_pass_spread.py measured on an H100 at m = 101
# the kernel median 7.7e-4 / max 2.1e-3 (carries 3.5e-3) from the
# emulation, the emulation's own float32-vs-float64 spread 7.4e-4 / 2.2e-3
# (carries 3.0e-3), the fp32 tier 3.8e-3 / 7.9e-3 away: the limits lie at
# ~2-3x the spread, below the fp32 tier's median; the carries' max
# K5_ONE_PASS.  The first real product (degree 3: the first step multiplies
# by c I) has exact terms: median 1e-5, max 1e-3 (measured median 3.0e-8,
# max 6.9e-5)
K4_ONE_PASS = {"median": 1.5e-3, "max": 6e-3}
K5_ONE_PASS = 1e-2
# A dominant eigenvalue (spectral radius near 1) amplifies a flipped
# rounding further, and the worst of 256 such matrices moves with the draw:
# on an H100 the kernel read max 3.99e-3 and 7.43e-3 on two draws where the
# emulation sat 4.18e-3 and 7.40e-3 from itself with float64 sums.  There
# the worst matrix is held to this multiple of that spread on the same
# matrices (the median still to K4_ONE_PASS); on the first draw that is
# 5.9e-3, within K4_ONE_PASS's max
K4_SPIKED_SPREAD = 1.4

# K4's and K5's output bits on fixed inputs, pinned by the SHA-256 digests
# of tests/golden/cheb_fwd_digest.json: (m, B, seed) at P = 112 and P = 128,
# degree 48, each with final_hi off and on
CHEB_BIT_CASES = ((101, 32, 7), (126, 16, 8))
CHEB_BIT_DEGREE = 48
CHEB_BIT_ARRAYS = ("K4.Gr", "K4.Gi", "K5.Gr", "K5.Gi", "K5.b1r", "K5.b1i", "K5.b2r", "K5.b2i")


def cheb_bit_case(m: int, B: int, seed: int, final_hi: bool) -> str:
    """The key of one case in the golden file."""
    return f"m={m} B={B} seed={seed} final_hi={int(final_hi)}"


def cheb_fwd_digests(kc, dev) -> dict:
    """{case: {array: SHA-256 hex of its float32 bytes}} of K4's output planes
    (Gr, Gi) and K5's (Gr, Gi and the carries b1r, b1i, b2r, b2i), as
    ``kc.cheb_filter_planes`` returns them (zero-padded to P), on random
    Hermitian matrices whose second half has a dominant eigenvalue, drawn
    with numpy from each case's seed."""
    import hashlib

    out = {}
    for m, B, seed in CHEB_BIT_CASES:
        rng = np.random.default_rng(seed)
        X = rng.normal(size=(B, m, m)) + 1j * rng.normal(size=(B, m, m))
        M = (X + X.conj().transpose(0, 2, 1)) / 2
        v = rng.normal(size=(B // 2, m)) + 1j * rng.normal(size=(B // 2, m))
        v /= np.linalg.norm(v, axis=-1, keepdims=True)
        M[B // 2:] += 300.0 * v[:, :, None] * v.conj()[:, None, :]
        c = (rng.normal(size=(B, CHEB_BIT_DEGREE)) * 0.3).astype(np.float32)
        M = torch.from_numpy(np.ascontiguousarray(M, np.complex64)).to(dev)
        c = torch.from_numpy(c).to(dev)
        for final_hi in (False, True):
            Gr, Gi, _ = kc.cheb_filter_planes(M, c, CHEB_BIT_DEGREE, final_hi)
            Gr5, Gi5, carries = kc.cheb_filter_planes(M, c, CHEB_BIT_DEGREE, final_hi,
                                                      carries=True)
            arrays = dict(zip(CHEB_BIT_ARRAYS, (Gr, Gi, Gr5, Gi5, *carries)))
            out[cheb_bit_case(m, B, seed, final_hi)] = {
                k: hashlib.sha256(x.float().cpu().numpy().tobytes()).hexdigest()
                for k, x in arrays.items()}
    return out

# K6 vs its plain version at its tier, per matrix (measured by
# tests/one_pass_spread.py and on an H100): the split tier vs the rounded
# split emulation (Mbar median 2.6e-6, max 7.5e-6, cbar max 2.7e-5; the
# emulation vs itself with float64 sums Mbar 2.0e-6 / 4.0e-6; the split
# with fp32 residuals sits at median 8.6e-6, which the median limit tells
# apart), 3xTF32 vs the fp32 plain version (Mbar 1.1e-6-1.4e-6, cbar
# 4.3e-6: ~10x the fp32 sums' spread)
K6_TOL = {True: {"median": 5e-6, "max": 2e-5, "cbar": 6e-5},
          False: {"median": 2e-5, "max": 2e-5, "cbar": 5e-5}}

# K7 vs its plain version over 100 iterations: fp32 sums in another
# order, amplified by the quintic's large first-step coefficients
# (measured on an H100 median 8.28e-5, max 1.92e-4)
K7_PLAIN = {"median": 8e-4, "max": 2e-3}

# The kernel is held to the plain version on the same phi by one set of
# rules (peak_lists_held): as many valid entries, tau / f within one final
# refine step, heights within PEAK_H_TOL of the scene's top, padded entries
# as the plain version's; a scene may differ only where the coarse grid
# decides a seed at a near tie, and there every kernel peak must be a real
# peak of the spectrum.
# - the peak-search kernel vs its plain version on the same phi: as many
#   valid entries; tau and f within one
#   final refine step; heights within PEAK_H_TOL of the scene's top.  The
#   kernel sums every product in the plain version's order, and at B = 1,
#   7 and 8192 on K2's and random phi the two agree bit for bit (a largest
#   gap of 0 at both tiers, measured on an H100); a sum in another order
#   would move an fp32 height ~1e-7 of the top and, at "default", could
#   flip the bf16 rounding of one S Phi term (2^-8 of it).  The control:
#   the kernel at one tier against the plain version at the other sits at
#   least 4.8e-4 of the top away in every scene by heights alone (and a
#   final refine step away in position), so 1e-4 tells the tiers apart.
#   Against the spectrum in float64 at the kernel's points
#   (PEAK_REAL_TOL) the tier's own error counts too: bf16 operands (2^-9 a
#   part) move a height ~1e-2.
PEAK_H_TOL = {"highest": 1e-5, "default": 1e-4}
PEAK_REAL_TOL = {"highest": 1e-4, "default": 2e-2}
# - a near tie of the fp32 coarse grid, over the scene's top: there two
#   summation orders of the same spectrum may pick different seeds, and a
#   scene may differ if every peak of the kernel's is a real one
PEAK_TIE_RTOL = 1e-5


def peak_final_step(cfg):
    """(delay, doppler) spacing of the last refine round's grid, with room
    for the rounding of the window's points."""
    step = 2 * cfg.reduce_factor ** (cfg.refine_iters - 1) / (cfg.refine_points - 1)
    return step * cfg.delay_step * (1 + 1e-3), step * cfg.doppler_step * (1 + 1e-3)


def peak_height_gap(pk, pp, cfg, anywhere: bool = False) -> torch.Tensor:
    """Per scene, over the scene's top (pp's highest): the largest, over the
    valid entries of either list, of the smallest height difference to a
    valid entry of the other within one final refine step in tau and f
    (inf where an entry has none), or to any valid entry with
    ``anywhere``."""
    st, sf = peak_final_step(cfg)
    both = pk.valid[:, :, None] & pp.valid[:, None, :]
    if not anywhere:
        both = both & (((pk.tau[:, :, None] - pp.tau[:, None, :]).abs() <= st)
                       & ((pk.f[:, :, None] - pp.f[:, None, :]).abs() <= sf))
    top = pp.height[:, :1, None].clamp_min(1e-30)
    dh = torch.where(both, (pk.height[:, :, None] - pp.height[:, None, :]).abs() / top,
                     torch.inf)
    return torch.maximum(torch.where(pk.valid, dh.amin(-1), 0.0).amax(-1),
                         torch.where(pp.valid, dh.amin(1), 0.0).amax(-1))


def peak_lists_match(pk, pp, cfg, h_tol=None) -> torch.Tensor:
    """Per scene: the kernel's list pk holds the plain version's pp: as many
    valid entries; each valid entry of either within one final refine step
    (tau, f) and ``h_tol`` (PEAK_H_TOL at the tier) of the top (height) of
    one of the other's (the orders may differ where two heights are that
    close); padded entries at height -inf, at the plain version's padded
    point."""
    st, sf = peak_final_step(cfg)
    h_tol = PEAK_H_TOL[cfg.refine_precision] if h_tol is None else h_tol
    pads = (~pk.valid & ((pk.height != -torch.inf) | ((pk.tau - pp.tau[:, -1:]).abs() > st)
                         | ((pk.f - pp.f[:, -1:]).abs() > sf))).any(-1)
    return ((pk.valid.sum(-1) == pp.valid.sum(-1)) & (peak_height_gap(pk, pp, cfg) <= h_tol)
            & ~pads)


def peak_real_heights(phi, pk, cfg, Nb=10, Nd=10) -> torch.Tensor:
    """Per scene: every valid height of pk within PEAK_REAL_TOL of the top
    of |<phi, a(tau, f)>|^2 at its point, in float64."""
    m = torch.arange(Nb, dtype=torch.float64, device=phi.device)
    k = torch.arange(Nd, dtype=torch.float64, device=phi.device)
    s = torch.exp(2j * np.pi * pk.f.double()[..., None] * m)
    dc = torch.exp(-2j * np.pi * pk.tau.double()[..., None] * k)
    Phi = phi.to(torch.complex128).conj().reshape(-1, Nb, Nd)
    z = torch.abs(torch.einsum("bkm,bmd,bkd->bk", s, Phi, dc)) ** 2
    top = z.amax(-1, keepdim=True).clamp_min(1e-30)
    err = torch.where(pk.valid, (pk.height.double() - z).abs(), 0.0)
    return (err <= PEAK_REAL_TOL[cfg.refine_precision] * top).all(-1)


def peak_coarse_near_ties(phi, cfg, Nb=10, Nd=10) -> torch.Tensor:
    """Per scene: whether the plain version's coarse grid decides its K
    seeds at a near tie (PEAK_TIE_RTOL of the scene's top): a point within
    it of its largest neighbour, at or above the K-th candidate, or the
    K-th candidate within it of the next."""
    import torch.nn.functional as F

    from admmnet_tpu_torch.peaks.search import search_constants
    from admmnet_tpu_torch.peaks.spectrum import spectrum_grid

    c = search_constants(cfg, Nb, Nd, phi.device)
    K = cfg.max_peaks
    out = []
    for i in range(0, phi.shape[0], 1024):
        Z = spectrum_grid(phi[i:i + 1024], c.taus, c.fs, Nb, Nd)
        ny, nx = Z.shape[1:]
        padded = F.pad(Z, (1, 1, 1, 1), value=-torch.inf)
        nbr = torch.stack([padded[:, 1 + dy:1 + dy + ny, 1 + dx:1 + dx + nx]
                           for dy in (-1, 0, 1) for dx in (-1, 0, 1) if dy or dx]).amax(0)
        tol = PEAK_TIE_RTOL * Z.amax(dim=(1, 2))
        scores = torch.where(Z >= nbr, Z, -torch.inf).reshape(Z.shape[0], -1)
        top = torch.topk(scores, K + 1, dim=-1).values
        kth = top[:, K - 1]
        edge = torch.isfinite(top[:, K]) & (kth - top[:, K] <= tol)
        close = ((Z - nbr).abs() <= tol[:, None, None]) & (Z >= (kth - tol)[:, None, None])
        out.append(edge | close.flatten(1).any(-1))
    return torch.cat(out)


def peak_lists_held(phi, pk, pp, cfg, Nb=10, Nd=10):
    """(scenes whose lists differ, of them those not explained): the
    kernel's lists pk and the plain version's pp on the same phi may differ
    only in a scene whose coarse grid decides a seed at a near tie, and
    there every valid peak of the kernel's must be a real one."""
    from admmnet_tpu_torch.peaks import PeakResult

    differ = ~peak_lists_match(pk, pp, cfg)
    if not bool(differ.any()):
        return 0, 0
    ties = peak_coarse_near_ties(phi, cfg, Nb, Nd)
    real = torch.ones_like(differ)
    real[differ] = peak_real_heights(phi[differ], PeakResult(*(x[differ] for x in pk)), cfg,
                                     Nb, Nd)
    return int(differ.sum()), int((differ & ~(ties & real)).sum())


# The batched Jacobi eigensolver (kernels/eigh.py) against torch.linalg.eigh
# in complex128, per matrix (eigh_errors).  Its plain version, the same fp32 arithmetic
# on the CPU, measures at m = 101 on random Hermitian matrices: the
# reconstruction ||V diag(w) V^H - herm(M)||_F / ||M||_F 1.6e-5, the
# orthogonality max |V^H V - I| 1.9e-5 and the eigenvalues max |w - w_ref| /
# max |w_ref| 1.0e-6 (a rotation's rounding, ~u = 6e-8, accumulated over
# the ~400 large rotations each column takes).  The kernel sums in another
# order (fused multiply-adds), so it is held to 4-6x those.
EIGH_REC_TOL = 1e-4
EIGH_ORTH_TOL = 1e-4
EIGH_W_TOL = 5e-6
# the eigh GLayer on the kernel against the complex128 route (forward,
# relative Frobenius a matrix; gradients of a random functional of G with
# respect to phi, h, Z and the layer's parameters, relative norm): the
# kernel's reconstruction error (1.6e-5 in its plain version), through the
# filter's rebuild; the gradient flows through fp32 eigenvectors twice
EIGH_GLAYER_TOL = 1e-4
EIGH_GLAYER_GRAD_TOL = 1e-3
# one training step of upstream's published net (runs/admmnet10, ten eigh
# GLayers, the attention head with dropout) at B = 256 on the kernel route
# against the same step with each eigendecomposition in complex128 (the
# same batch and masks): the loss, relative; by the worst leaf whose
# gradient is at least a thousandth of the median leaf's, the clipped
# gradient and the first AdamW update, each ||x - x_ref|| / ||x_ref||.
# The kernel's eigenvalues carry ~1e-6 of the spectrum (EIGH_W_TOL's
# reading), which nine layers carry into the loss and the gradient; the
# first update is lr sign(g) entry by entry, so an entry whose gradient is
# round-off may flip.  Measured on an H100 (the inputs are fixed): loss
# 2.4e-7, gradient 2.5e-4, update 6.2e-4; the limits are 4-8 times those,
# the gradient's EIGH_GLAYER_GRAD_TOL.
EIGH_TRAIN_LOSS_TOL = 2e-6
EIGH_TRAIN_GRAD_TOL = 1e-3
EIGH_TRAIN_STEP_TOL = 5e-3


def eigh_edge_batch(m: int, dev) -> dict:
    """Edge spectra of side m: zero, diagonal, repeated (three clusters of
    equal eigenvalues in a random basis) and rank one."""
    g = torch.Generator().manual_seed(m)
    X = torch.randn(m, m, dtype=torch.complex64, generator=g)
    Q, _ = torch.linalg.qr(X)
    reps = torch.tensor([float(i * 3 // m) - 1.0 for i in range(m)])
    u = torch.randn(m, 1, dtype=torch.complex64, generator=g)
    cases = {"zero": torch.zeros(m, m, dtype=torch.complex64),
             "diagonal": torch.diag(torch.randn(m, generator=g)).to(torch.complex64),
             "repeated": (Q * reps.to(Q.dtype)) @ Q.mH,
             "rank-1": u @ u.mH}
    return {k: v[None].to(dev) for k, v in cases.items()}


def eigh_errors(M, w, V, w_ref=None):
    """(reconstruction, orthogonality, eigenvalue error) of each matrix:
    ||V diag(w) V^H - herm(M)||_F / ||M||_F, max |V^H V - I| and max |w -
    w_ref| / max |w_ref|, w_ref from torch.linalg.eigvalsh in complex128
    unless given (zero where M is zero)."""
    H = 0.5 * (M + M.mH).to(torch.complex128)
    Vd, wd = V.to(torch.complex128), w.to(torch.float64)
    rec = torch.linalg.norm((Vd * wd.to(Vd.dtype)[..., None, :]) @ Vd.mH - H, dim=(-2, -1))
    nrm = torch.linalg.norm(H, dim=(-2, -1))
    eye = torch.eye(M.shape[-1], dtype=Vd.dtype, device=M.device)
    orth = (Vd.mH @ Vd - eye).abs().amax(dim=(-2, -1))
    w_ref = torch.linalg.eigvalsh(H) if w_ref is None else w_ref.to(torch.float64)
    scale = w_ref.abs().amax(-1)
    w_err = (wd - w_ref).abs().amax(-1)
    return (torch.where(nrm > 0, rec / nrm.clamp_min(1e-300), rec),
            orth, torch.where(scale > 0, w_err / scale.clamp_min(1e-300), w_err))
