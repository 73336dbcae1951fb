"""CUDA kernels of the port vs their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  The file
imports neither JAX nor the JAX package, so it also runs on a machine
without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances.  The all-fp32 modes (3xTF32 on the tensor cores,
fp32-faithful) and their plain versions compute every product in fp32
with sums in another order; through the accurate schedule's amplification
that stays below 1e-4 relative for one projection, below 1e-3 for 20
iterations of fused_exact and K7 (where a last-bit difference can also
flip a bisection decision of the H-projection), below 5e-5 for the 48
dependent steps of a Clenshaw evaluation at the GLayer's side (measured
5.7e-7 on random matrices on an H100; at the edge sides, where small
spiked matrices amplify any rounding, within 8x the fp32 plain version's
distance from fp64), and below 1e-3 for the reversible backward, which
rebuilds the forward's states from its last two.  The one-pass tier (K1's
low steps in bf16, K2's and K3's low and final_hi-off closing products in
tf32) is held to the plain version with ``one_pass=True``, whose operands
are rounded as the kernel's: the first low step's median instance within
1e-5 (the terms are exact; the worst within 1e-3, where a sum in another
order flips an intermediate rounding); a whole K1 projection at the JAX
package's 8e-3 ceiling for the fast tier's noise (median; 1e-2 for the
worst matrix, where a flip is carried by the later low steps), and K1
``bf16_store`` must stand more than 1e-3 from the fp32 store; K2 and K3
per instance within 2e-2, the median instance within 1e-2 (K2_ONE_PASS:
the tf32 tier measured 1.1e-2 / 2.8e-3 after 100 iterations on an H100,
a bf16 tier 7.9e-2 / 2.2e-2; the JAX package's band for the fast mode's
phi accuracy floor, 0.05 in tests/test_fused_fast.py, is wider).  The
edge sides' knobs (warm root, the polish step, hi closing products, rho
1.3, lambda 0.8) amplify the tf32 roundings more: at n = 111 and 126 the
emulation sits median 1.4e-2, max 1.9e-2 from itself with float64 sums,
as far as the kernel sits from it (tests/one_pass_spread.py on an H100),
so they are held to twice that (K2_ONE_PASS_EDGES).
"""

import json
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

from admmnet_tpu_torch.core.config import (
    DETECTION_BUDGET_ITERS,
    PRODUCTION_PEAKS,
    ADMMOptions,
    PeakSearchConfig,
)
from admmnet_tpu_torch.data.anchor import ANCHOR_C, ANCHOR_F, ANCHOR_TAU, _psi, make_anchor_batch
from admmnet_tpu_torch.kernels import cheb_filter as kc
from admmnet_tpu_torch.kernels import fused_admm as k7
from admmnet_tpu_torch.kernels import fused_admm_fast as kf
from admmnet_tpu_torch.kernels import peak_search as kps
from admmnet_tpu_torch.kernels import polar as kp
from admmnet_tpu_torch.ops.projections import POLAR_BF16_SCHED2, psd_project_eigh
from admmnet_tpu_torch.peaks import PeakResult, find_peaks
from admmnet_tpu_torch.peaks.search import find_peaks_plain
from admmnet_tpu_torch.solver import admm_solve_fixed
from admmnet_tpu_torch.solver.admm import fused_kernel_options
from card_checks import (
    CHEB_BIT_DEGREE,
    EIGH_GLAYER_GRAD_TOL,
    EIGH_GLAYER_TOL,
    EIGH_ORTH_TOL,
    EIGH_REC_TOL,
    EIGH_TRAIN_GRAD_TOL,
    EIGH_TRAIN_LOSS_TOL,
    EIGH_TRAIN_STEP_TOL,
    EIGH_W_TOL,
    K1_ONE_PASS,
    K1_PLAIN,
    K2_ONE_PASS,
    K2_ONE_PASS_EDGES,
    K4_ONE_PASS,
    K4_SPIKED_SPREAD,
    K5_ONE_PASS,
    K6_TOL,
    K7_PLAIN,
    PEAK_H_TOL,
    eigh_edge_batch,
    eigh_errors,
    peak_height_gap,
    peak_lists_held,
    peak_lists_match,
    cheb_fwd_digests,
    rel_err,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b, reduce=torch.max):
    """Per-instance relative error of a against b, reduced over instances."""
    return float(reduce(rel_err(a, b)))


_MM = kp.mm


def mm_f64(a, b, split, one_pass_round=None):
    """``polar.mm`` with its one-pass and split products summed in float64
    (the same rounded operands); the fp32 product as it is."""
    if one_pass_round is None and not split:
        return _MM(a, b, split)
    if not split:
        return (one_pass_round(a).double() @ one_pass_round(b).double()).float()
    ah, bh = kp.bf16_rn(a), kp.bf16_rn(b)
    al, bl = a - ah, b - bh
    if one_pass_round is not None:
        al, bl = one_pass_round(al), one_pass_round(bl)
    ah, bh, al, bl = (x.double() for x in (ah, bh, al, bl))
    return (ah @ bh + ah @ bl + al @ bh).float()


def sums_in_float64(fn, *args, **kw):
    """``fn`` with ``polar.mm`` replaced by ``mm_f64``: an emulation whose
    sums run in another order and width, which shows how far a correct
    kernel may sit from it."""
    kp.mm = mm_f64
    try:
        return fn(*args, **kw)
    finally:
        kp.mm = _MM


def _one_pass_ok(pk, pp, tol=K2_ONE_PASS):
    """K2 / K3 against their one-pass emulation (module docstring)."""
    return _rel(pk, pp) < tol["max"] and _rel(pk, pp, torch.median) < tol["median"]


def _hermitian(rng, B, m):
    X = rng.normal(size=(B, m, m)) + 1j * rng.normal(size=(B, m, m))
    return np.ascontiguousarray((X + X.conj().transpose(0, 2, 1)) / 2, np.complex64)


@pytest.mark.cuda
@pytest.mark.parametrize("B, m", [(64, 101), (512, 101), (64, 120)])
@pytest.mark.parametrize("mode, hi_steps, eigh_tol", [("accurate", None, 2e-4),
                                                      ("fast", None, 8e-3), ("fast", 1, 8e-3)])
def test_polar_kernel_matches_plain(cuda, mode, hi_steps, eigh_tol, B, m):
    """K1 in every mode (the fast one with and without the polish step)
    against its plain version and against eigh, at the GLayer's side, on
    512 matrices, and at plane side 128 (m = 120, a cluster of two CTAs).
    Against eigh: the accurate schedule's own accuracy
    (tests/test_polar.py), and for the fast modes the JAX package's 8e-3
    ceiling for the fast tier's hardware noise."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(B, m, m)) + 1j * rng.normal(size=(B, m, m))
    M = np.ascontiguousarray((X + X.conj().transpose(0, 2, 1)) / 2, np.complex64)
    M = torch.from_numpy(M).to(cuda)
    before = kp.launches.count
    Pk = kp.psd_project_polar_kernel(M, mode=mode, hi_steps=hi_steps)
    assert kp.launches.count == before + 1
    Pp = kp.psd_project_polar_plain(M, mode=mode, hi_steps=hi_steps, one_pass=mode == "fast")
    if mode == "fast":
        assert (_rel(Pk, Pp, torch.median) < K1_ONE_PASS["median"]
                and _rel(Pk, Pp) < K1_ONE_PASS["max"])
    else:
        assert _rel(Pk, Pp) < K1_PLAIN
    assert _rel(Pk, psd_project_eigh(M)) < eigh_tol


@pytest.mark.cuda
@pytest.mark.parametrize("n, B", [(100, 64), (119, 64), (100, 2048), (119, 256)])
def test_first_low_step_matches_the_emulation(cuda, n, B):
    """K1 through its launcher with a one-step schedule, with and without
    bf16 storage, and K2's second iteration (one step, final_hi off; the
    first phi reads no product): exact terms, only the order of the sums
    differs, so the median instance within 1e-5, where a kernel that drops
    or misplaces a rounding moves every instance (the fp32 tier's median
    sits 7.4e-4 (K1) and 2.7e-5 (K2) away).  The step chains its products
    through rounded intermediates, where a sum in another order flips a
    rounding now and then: the worst instance within 1e-3 (measured on an
    H100: K1 median 1.4e-7, max 4.9e-5 at B = 511; K2 2.5e-7 / 4.0e-5 at
    n = 100, B = 2048, and 2.6e-7 / 1.0e-4 at n = 119, B = 256)."""
    from admmnet_tpu_torch.ops.projections import POLAR_BF16_SCHEDULE

    M = torch.from_numpy(_hermitian(np.random.default_rng(n), B, n + 1)).to(cuda)
    one = (POLAR_BF16_SCHEDULE[0],)
    for bf16_store in (False, True):
        Pr, Pi = kp.launch_schedule(M, one, 0, bf16_store)
        Pk = torch.complex(Pr[:, :n + 1, :n + 1], Pi[:, :n + 1, :n + 1])
        Pe = kp.polar_plain_schedule(M, one, 0, bf16_store, True)
        assert _rel(Pk, Pe, torch.median) < 1e-5 and _rel(Pk, Pe) < 1e-3
    y, b, s = _anchor_rows(n, cuda, B)
    kw = dict(hi_steps=0, outer_iters=4, inner_iters=3, schedule=(POLAR_BF16_SCHED2[0],),
              final_hi=False, layout="lean", fold_diag=False)
    pk = kf.admm_solve_fused_fast(y, b, s, 2, **kw)
    pe = kf.admm_solve_fused_fast_plain(y, b, s, 2, one_pass=True, **kw)
    assert _rel(pk, pe, torch.median) < 1e-5 and _rel(pk, pe) < 1e-3


POLAR_MODES = [("accurate", None, False), ("fast", 0, False), ("fast", 1, False),
               ("fast", 0, True), ("fast", 1, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 10, 16, 101, 112, 113, 120, 128])
@pytest.mark.parametrize("mode, hi_steps, bf16_store", POLAR_MODES)
def test_polar_kernel_edges(cuda, m, mode, hi_steps, bf16_store):
    """K1 at the sides where its body changes shape (m <= 112: one CTA per
    matrix on planes of side 112; m >= 113: a cluster of two on side 128;
    m = 1, 10, 16: most of the planes padding) in every mode, on an odd
    batch whose last matrix is zero: the zero matrix exactly zero, every
    padded row and column exactly 0, the rest held to the plain version
    (the fast modes to its one-pass emulation).  The error is taken against
    ||M|| (a 1 x 1 projection of a negative entry is exactly 0): accurate
    within 1e-4, the fast modes' median matrix within 8e-3 and every matrix
    within 1e-2 (the module's one-pass tolerances)."""
    rng = np.random.default_rng(m)
    X = rng.normal(size=(5, m, m)) + 1j * rng.normal(size=(5, m, m))
    M = torch.from_numpy(np.ascontiguousarray((X + X.conj().transpose(0, 2, 1)) / 2,
                                              np.complex64)).to(cuda)
    M[-1] = 0
    before = kp.launches.count
    Pr, Pi = kp.psd_project_polar_planes(M, mode, hi_steps, bf16_store)
    assert kp.launches.count == before + 1
    for x in (Pr, Pi):
        assert bool(torch.all(x[:, m:, :] == 0)) and bool(torch.all(x[:, :, m:] == 0))
        assert bool(torch.all(torch.isfinite(x)))
        assert bool(torch.all(x[-1] == 0))
    Pk = torch.complex(Pr[:-1, :m, :m], Pi[:-1, :m, :m])
    Pp = kp.psd_project_polar_plain(M[:-1], mode, hi_steps, bf16_store,
                                    one_pass=mode == "fast")
    err = (torch.linalg.norm((Pk - Pp).reshape(4, -1), dim=-1)
           / torch.linalg.norm(M[:-1].reshape(4, -1), dim=-1))
    if mode == "fast":
        assert float(err.median()) < 8e-3 and float(err.max()) < 1e-2
    else:
        assert float(err.max()) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("B, m", [(1, 101), (7, 101), (1, 120), (7, 120)])
def test_polar_kernel_batch_sizes(cuda, B, m):
    """K1 on one matrix and on an odd batch, through the wrapper."""
    rng = np.random.default_rng(B)
    X = rng.normal(size=(B, m, m)) + 1j * rng.normal(size=(B, m, m))
    M = torch.from_numpy(np.ascontiguousarray((X + X.conj().transpose(0, 2, 1)) / 2,
                                              np.complex64)).to(cuda)
    Pk = kp.psd_project_polar_kernel(M)
    assert Pk.shape == M.shape
    assert _rel(Pk, kp.psd_project_polar_plain(M)) < 1e-4


GRIDS = {10: (2, 5), 16: (4, 4), 111: (3, 37), 119: (7, 17), 126: (7, 18)}


def _anchor_rows(n, dev, B=64):
    """B instances of the anchor's three targets at side n: the anchor
    batch at n = 100; at other sides the same targets on an Nb x Nd grid
    (GRIDS; n = 119 is lifted side 120, plane side 128) with fresh QPSK
    symbols, 7 dB demodulation errors and 20 dB noise, as
    make_anchor_batch builds them."""
    if n == 100:
        rows = make_anchor_batch(B, "redemod", seed=0)
    else:
        Nb, Nd = GRIDS[n]
        rng = np.random.default_rng(0)
        sym = np.exp(1j * (np.pi / 2 * rng.integers(0, 4, size=(B, n)) + np.pi / 4))
        noise = np.sqrt(10 ** -0.7 / 2) * (rng.standard_normal((B, n))
                                           + 1j * rng.standard_normal((B, n)))
        quad = np.floor(np.mod(np.angle(sym + noise), 2 * np.pi) * 2 / np.pi).astype(int) % 4
        b = np.exp(1j * (np.pi / 2 * quad + np.pi / 4))
        clean = sym * _psi(ANCHOR_TAU, ANCHOR_F, ANCHOR_C, Nb, Nd)[None]
        w_var = np.linalg.norm(clean, axis=-1, keepdims=True) ** 2 / (100.0 * n)
        y = clean + np.sqrt(w_var / 2) * (rng.standard_normal((B, n))
                                          + 1j * rng.standard_normal((B, n)))
        sigma = np.linalg.norm((sym - b) / b, axis=-1) + 1.0
        rows = (y.astype(np.complex64), b.astype(np.complex64), sigma.astype(np.float32))
    return [torch.from_numpy(x).to(dev) for x in rows]


@pytest.mark.cuda
@pytest.mark.parametrize("n, B, iters", [(100, 64, 20), (119, 64, 20), (100, 2048, 100),
                                         (119, 256, 100)])
@pytest.mark.parametrize("g_update", ["fused_fast", "fused_exact"])
def test_fused_kernel_matches_plain(cuda, g_update, n, B, iters):
    """The production K2 (fused_fast: one-pass low steps; fused_exact: all
    fp32) against its plain version, and over the full 100 iterations on
    the anchor batch of 2048 and at plane side 128 (n = 119, B = 256).
    fused_exact after 100 iterations: fp32 sums in another order, carried
    through the H-projection's bisection decisions (measured on an H100
    median 4.8e-5, max 2.3e-4), so median 1e-4 and max 2e-3."""
    y, b, s = _anchor_rows(n, cuda, B)
    kw = fused_kernel_options(ADMMOptions(g_update=g_update))
    before = kf.launches.count
    pk = kf.admm_solve_fused_fast(y, b, s, iters, **kw)
    assert kf.launches.count == before + 1
    assert bool(torch.all(torch.isfinite(torch.view_as_real(pk))))
    fast = g_update == "fused_fast"
    pp = kf.admm_solve_fused_fast_plain(y, b, s, iters, one_pass=fast, **kw)
    if fast:
        assert _one_pass_ok(pk, pp)
    elif iters == 20:
        assert _rel(pk, pp) < 1e-3
    else:
        assert _rel(pk, pp, torch.median) < 1e-4 and _rel(pk, pp) < 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize("fold_diag", [True, False])
@pytest.mark.parametrize("n", [10, 16, 111, 126])
def test_fused_kernel_edges_match_plain(cuda, n, fold_diag):
    """Sides whose bands are mostly padding or whose row n opens or closes
    a band, and a hi step without three_pass (the polish step: no
    re-projection) with hi closing products after the one-pass low steps."""
    y, b, s = _anchor_rows(n, cuda)
    kw = dict(hi_steps=1, outer_iters=4, inner_iters=3, final_hi=True, layout="lean",
              fold_diag=fold_diag, warm_root=True)
    pk = kf.admm_solve_fused_fast(y, b, s, 20, 1.3, 0.8, **kw)
    assert bool(torch.all(torch.isfinite(torch.view_as_real(pk))))
    pp = kf.admm_solve_fused_fast_plain(y, b, s, 20, 1.3, 0.8, one_pass=True, **kw)
    assert _one_pass_ok(pk, pp, K2_ONE_PASS_EDGES)


@pytest.mark.cuda
@pytest.mark.parametrize("n, B, iters, rho", [(100, 64, 20, 1.7), (119, 64, 20, 1.7),
                                              (100, 2048, 100, 1.0), (119, 256, 100, 1.0)])
@pytest.mark.parametrize("layout", ["lists", "lean"])
def test_unfolded_fused_kernels_match_plain(cuda, layout, n, B, iters, rho):
    """K3 (lists) and K2's unfolded carry at the pinned control knobs, and
    at the escape hatch's own (rho 1, 100 iterations) on the anchor batch
    of 2048 and at plane side 128."""
    y, b, s = _anchor_rows(n, cuda, B)
    kw = dict(hi_steps=0, outer_iters=4, inner_iters=3, schedule=POLAR_BF16_SCHED2,
              final_hi=False, layout=layout, fold_diag=False)
    counter = kf.lists_launches if layout == "lists" else kf.launches
    before = counter.count
    pk = kf.admm_solve_fused_fast(y, b, s, iters, rho, **kw)
    assert counter.count == before + 1
    assert bool(torch.all(torch.isfinite(torch.view_as_real(pk))))
    assert _one_pass_ok(pk, kf.admm_solve_fused_fast_plain(y, b, s, iters, rho, one_pass=True,
                                                           **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("n, B, iters", [(100, 64, 20), (119, 64, 20), (100, 512, 100)])
@pytest.mark.parametrize("ablate", kf.ABLATE[1:])
def test_ablate_kernels_match_plain(cuda, ablate, n, B, iters):
    """K2's profiling variants (B6) at runs/profile_lean.py's knobs, and
    over the profile's 100 iterations on 512 anchor instances."""
    y, b, s = _anchor_rows(n, cuda, B)
    kw = dict(hi_steps=0, outer_iters=4, inner_iters=3, schedule=POLAR_BF16_SCHED2,
              final_hi=False, layout="lean", fold_diag=False, ablate=ablate)
    before = kf.launches.count
    pk = kf.admm_solve_fused_fast(y, b, s, iters, **kw)
    assert kf.launches.count == before + 1
    assert bool(torch.all(torch.isfinite(torch.view_as_real(pk))))
    assert _one_pass_ok(pk, kf.admm_solve_fused_fast_plain(y, b, s, iters, one_pass=True,
                                                           **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("B, iters, rho, lam", [(16, 20, 2.0, 0.5), (512, 100, 1.0, 1.0)])
def test_k7_kernel_matches_plain(cuda, B, iters, rho, lam):
    """K7 against its plain version, and over the full 100 iterations of
    512 anchor instances at the defaults: fp32 sums in another order,
    amplified by the quintic's large first-step coefficients (measured on
    an H100 median 8.28e-5, max 1.92e-4), so median 8e-4 and max 2e-3.
    The plain version is ~1e5 small launches (~10 s)."""
    y, b, s = (torch.from_numpy(x).to(cuda) for x in make_anchor_batch(B, "redemod", seed=0))
    before = k7.launches.count
    pk = k7.admm_solve_fused(y, b, s, iters, rho, lam)
    assert k7.launches.count == before + 1
    pp = k7.admm_solve_fused_plain(y, b, s, iters, rho, lam)
    if iters == 20:
        assert _rel(pk, pp) < 1e-3
    else:
        assert _rel(pk, pp, torch.median) < K7_PLAIN["median"] and _rel(pk, pp) < K7_PLAIN["max"]


@pytest.mark.cuda
@pytest.mark.parametrize("n, B", [(119, 8), (100, 1)])
def test_k7_kernel_edges(cuda, n, B):
    """K7 at plane side 128 (n = 119, the anchor's targets on a 7 x 17 grid:
    a cluster of two CTAs per instance) and on a single instance, held to
    its plain version as test_k7_kernel_matches_plain is."""
    y, b, s = (x[:B] for x in _anchor_rows(n, cuda))
    before = k7.launches.count
    pk = k7.admm_solve_fused(y, b, s, 20, 2.0, 0.5)
    assert k7.launches.count == before + 1
    assert pk.shape == (B, n)
    assert _rel(pk, k7.admm_solve_fused_plain(y, b, s, 20, 2.0, 0.5)) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("B", [64, 512])
@pytest.mark.parametrize("hi_steps", [0, 1])
def test_polar_bf16_store_matches_plain(cuda, hi_steps, B):
    """K1's bf16 iterate storage: its low steps' operands are bf16-valued,
    so the kernel's terms are the emulation's exact products summed in
    another order; one bf16 rounding flips (2^-8 relative) and the later
    low steps carry it (measured median 3.4e-3), held to the fast tier's
    one-pass limits.  The rounding must show against the fp32 store
    (measured median 4.30e-3 / 3.06e-3 at hi_steps 0 / 1)."""
    rng = np.random.default_rng(1)
    X = rng.normal(size=(B, 101, 101)) + 1j * rng.normal(size=(B, 101, 101))
    M = torch.from_numpy(np.ascontiguousarray((X + X.conj().transpose(0, 2, 1)) / 2,
                                              np.complex64)).to(cuda)
    Pk = kp.psd_project_polar_kernel(M, mode="fast", hi_steps=hi_steps, bf16_store=True)
    Pp = kp.psd_project_polar_plain(M, "fast", hi_steps, bf16_store=True, one_pass=True)
    assert _rel(Pk, Pp) < K1_ONE_PASS["max"]
    assert _rel(Pk, Pp, torch.median) < K1_ONE_PASS["median"]
    # the rounding shows: the fp32 store is a bf16 flip away on most matrices
    P32 = kp.psd_project_polar_kernel(M, mode="fast", hi_steps=hi_steps)
    assert _rel(Pk, P32, torch.median) > 1e-3
    assert _rel(Pk, psd_project_eigh(M)) < 8e-3


@pytest.mark.cuda
@pytest.mark.parametrize("B, spiked", [(64, False), (512, True)])
@pytest.mark.parametrize("final_hi", [False, True])
def test_cheb_kernel_matches_plain(cuda, final_hi, B, spiked):
    """K4 vs its emulation (the plain version with ``one_pass``): the
    Clenshaw steps' products one-pass bf16, the closing one too unless
    ``final_hi``; on random matrices, and on a batch of 512 (the learned
    path's) whose second half has a dominant eigenvalue, the coefficients
    drawn after the spikes, where the worst spiked matrix is held to the
    emulation's own float32-vs-float64 spread (K4_SPIKED_SPREAD); the
    first real product (degree 3) at its own tight limits."""
    if spiked:
        rng = np.random.default_rng(2)
        M = torch.from_numpy(_hermitian(rng, B, 101)).to(cuda)
        v = torch.from_numpy(rng.normal(size=(B // 2, 101)) + 1j * rng.normal(size=(B // 2, 101)))
        v = (v / torch.linalg.norm(v, dim=-1, keepdim=True)).to(torch.complex64).to(cuda)
        M[B // 2:] += 300.0 * v[:, :, None] * v.conj()[:, None, :]
        c = torch.from_numpy((rng.normal(size=(B, 48)) * 0.3).astype(np.float32)).to(cuda)
    else:
        rng = np.random.default_rng(0)
        X = rng.normal(size=(B, 101, 101)) + 1j * rng.normal(size=(B, 101, 101))
        M = torch.from_numpy(np.ascontiguousarray((X + X.conj().transpose(0, 2, 1)) / 2,
                                                  np.complex64)).to(cuda)
        c = torch.from_numpy((rng.normal(size=(B, 48)) * 0.3).astype(np.float32)).to(cuda)
    M[-1] = 0
    before = kc.launches.count
    G = kc.cheb_filter_matrices(M, c, 48, final_hi)
    assert kc.launches.count == before + 1
    Ge = kc.cheb_filter_matrices_plain(M, c, 48, one_pass=True, final_hi=final_hi)
    assert _rel(G[:-1], Ge[:-1], torch.median) < K4_ONE_PASS["median"]
    if spiked:
        h = B // 2
        assert _rel(G[:h], Ge[:h]) < K4_ONE_PASS["max"]
        G64 = sums_in_float64(kc.cheb_filter_matrices_plain, M[h:-1], c[h:-1], 48,
                              one_pass=True, final_hi=final_hi)
        assert _rel(G[h:-1], Ge[h:-1]) < K4_SPIKED_SPREAD * _rel(Ge[h:-1], G64)
    else:
        assert _rel(G[:-1], Ge[:-1]) < K4_ONE_PASS["max"]
    assert torch.equal(G[-1], Ge[-1])  # A = 0: no product carries rounding
    Gr, Gi, _ = kc.cheb_filter_planes(M, c, 48, final_hi)
    for X in (Gr, Gi):
        assert bool(torch.all(X[:, 101:, :] == 0)) and bool(torch.all(X[:, :, 101:] == 0))
    # a call that needs a gradient runs the training forward K5 instead,
    # whose output is K4's bit for bit
    before, before5 = kc.launches.count, kc.fwd_launches.count
    G5 = kc.cheb_filter_matrices(M.clone().requires_grad_(True), c, 48, final_hi)
    assert (kc.launches.count, kc.fwd_launches.count) == (before, before5 + 1)
    assert torch.equal(G5.detach(), G)
    c3 = c[:, :3].contiguous()
    G3 = kc.cheb_filter_matrices(M, c3, 3, final_hi)[:-1]
    E3 = kc.cheb_filter_matrices_plain(M, c3, 3, one_pass=True, final_hi=final_hi)[:-1]
    assert _rel(G3, E3, torch.median) < 1e-5 and _rel(G3, E3) < 1e-3


def _cheb_inputs(cuda, B=64, m=101, degree=48, seed=0):
    """Random Hermitian matrices, half of them with a dominant eigenvalue
    (A's spectral radius near 1, as the GLayer's lifted matrices have),
    coefficients and a random cotangent."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(B, m, m)) + 1j * rng.normal(size=(B, m, m))
    M = (X + X.conj().transpose(0, 2, 1)) / 2
    v = rng.normal(size=(B // 2, m)) + 1j * rng.normal(size=(B // 2, m))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    M[B // 2:] += 300.0 * v[:, :, None] * v.conj()[:, None, :]
    Y = rng.normal(size=(B, m, m)) + 1j * rng.normal(size=(B, m, m))
    c = rng.normal(size=(B, degree)) * 0.3
    return (torch.from_numpy(np.ascontiguousarray(M, np.complex64)).to(cuda),
            torch.from_numpy(c.astype(np.float32)).to(cuda),
            torch.from_numpy(Y.astype(np.complex64)).to(cuda))


@pytest.mark.cuda
def test_cheb_fwd_kernel_is_k4_with_carries(cuda):
    """K5: K4's output bit for bit, and the final carries of the one-pass
    emulation (K4_ONE_PASS's median, K5_ONE_PASS's max)."""
    M, c, _ = _cheb_inputs(cuda)
    G4r, G4i, _ = kc.cheb_filter_planes(M, c, 48)
    before = kc.fwd_launches.count
    Gr, Gi, carries = kc.cheb_filter_planes(M, c, 48, carries=True)
    assert kc.fwd_launches.count == before + 1
    assert torch.equal(Gr, G4r) and torch.equal(Gi, G4i)
    _, emul = kc.cheb_filter_matrices_plain_with_residuals(M, c, 48, one_pass=True)
    for k, e in zip(carries, emul):
        assert bool(torch.all(k[:, 101:, :] == 0)) and bool(torch.all(k[:, :, 101:] == 0))
        assert _rel(k[:, :101, :101], e, torch.median) < K4_ONE_PASS["median"]
        assert _rel(k[:, :101, :101], e) < K5_ONE_PASS


def _near_emulation(k, e32, e64):
    """Matrices whose emulation is exactly zero (degree 1's carries, degree
    2's b_2) must be exactly zero; the rest: the median matrix no further
    from the float32 emulation than 3x the emulation's own float32-vs-
    float64 spread (or 1e-5), and every matrix within 5e-2.  On small sides
    with a dominant eigenvalue the recurrence amplifies one flipped bf16
    rounding (tests/one_pass_spread.py: 1.9e-2 at m = 10 where the spread's
    max is 1.2e-6, 2.3e-2 at m = 16 where it is 3.0e-2); a misplaced band
    or step moves matrices by O(1)."""
    zero = torch.linalg.norm(e32.reshape(e32.shape[0], -1), dim=-1) == 0
    assert torch.equal(k[zero], e32[zero])
    if bool((~zero).any()):
        k, e32, e64 = k[~zero], e32[~zero], e64[~zero]
        spread = _rel(e32, e64, torch.median)
        assert _rel(k, e32, torch.median) <= max(1e-5, 3 * spread)
        assert _rel(k, e32) < 5e-2


@pytest.mark.cuda
@pytest.mark.parametrize("m", [10, 16, 101, 111, 120, 126])
@pytest.mark.parametrize("degree", [1, 2, 3, 48])
def test_cheb_fwd_kernel_edges(cuda, degree, m):
    """K4 and K5 at the loop's bounds (degree 1: no step, the product with
    b_1 = 0 only; 2: no step after the first; 3: one, the first real
    product), at sides that leave whole bands of the cluster as padding
    (m = 10, 16), at the GLayer's (m = 101) and the last of P = 112
    (m = 111), and at lifted sides of the P = 128 instantiation (m = 120,
    126: clusters of 8 CTAs), with a zero matrix: G and the carries of the
    zero matrix exactly the emulation's, every padded row and column
    exactly 0, K5's G bitwise K4's, and the rest near the one-pass
    emulation (_near_emulation).  At the GLayer's side the same kernels are
    held to K4_ONE_PASS (test_cheb_kernel_matches_plain,
    test_cheb_fwd_kernel_is_k4_with_carries)."""
    M, c, _ = _cheb_inputs(cuda, B=8, m=m, degree=degree, seed=100 + degree)
    M[-1] = 0
    G4r, G4i, _ = kc.cheb_filter_planes(M, c, degree)
    Gr, Gi, carries = kc.cheb_filter_planes(M, c, degree, carries=True)
    assert torch.equal(Gr, G4r) and torch.equal(Gi, G4i)
    Ge, emul = kc.cheb_filter_matrices_plain_with_residuals(M, c, degree, one_pass=True)
    G64, emul64 = sums_in_float64(kc.cheb_filter_matrices_plain_with_residuals, M, c, degree,
                                  one_pass=True)
    G = torch.complex(Gr[:, :m, :m], Gi[:, :m, :m])
    for x in (Gr, Gi, *carries):
        assert bool(torch.all(x[:, m:, :] == 0)) and bool(torch.all(x[:, :, m:] == 0))
        assert bool(torch.all(torch.isfinite(x)))
    assert torch.equal(G[-1], Ge[-1])  # A = 0: no product carries rounding
    _near_emulation(G[:-1], Ge[:-1], G64[:-1])
    for k, e, e64 in zip(carries, emul, emul64):
        assert torch.equal(k[-1, :m, :m], e[-1])
        _near_emulation(k[:-1, :m, :m], e[:-1], e64[:-1])


CHEB_DIGEST = Path(__file__).resolve().parent / "golden" / "cheb_fwd_digest.json"


@pytest.mark.cuda
def test_cheb_fwd_kernel_bits(cuda):
    """K4's and K5's output bits: the SHA-256 digests of K4's G and of K5's
    G and four carries (float32 planes) on fixed inputs at m = 101 (P =
    112) and m = 126 (P = 128), degree 48, final_hi off and on
    (card_checks.cheb_fwd_digests), equal to tests/golden/cheb_fwd_digest.json,
    made on an H100 by tests/golden/make_cheb_digest.py from the tree whose
    kernel staged b_1 as fp32 and rounded every fragment as it loaded it.
    A change of the kernel's layout, staging or schedule keeps these bits.
    A change that alters them on purpose (another rounding, pairing of k,
    band or summation order) regenerates the file with that script and
    says why in CHANGES.md."""
    want = json.loads(CHEB_DIGEST.read_text())
    assert want["degree"] == CHEB_BIT_DEGREE
    got = cheb_fwd_digests(kc, cuda)
    assert got.keys() == want["digests"].keys()
    for case, digests in got.items():
        assert digests["K5.Gr"] == digests["K4.Gr"] and digests["K5.Gi"] == digests["K4.Gi"]
        differ = sorted(k for k, v in digests.items() if want["digests"][case][k] != v)
        assert not differ, f"{case}: {differ} differ from the golden bits"


@pytest.mark.cuda
@pytest.mark.parametrize("B, m", [(64, 101), (16, 120)])
@pytest.mark.parametrize("three_pass", [True, False])
def test_cheb_bwd_kernel_matches_plain(cuda, three_pass, B, m):
    """K6 vs ``cheb_bwd_plain`` at its tier on the same inputs (K5's
    carries), at the GLayer's side (P = 112: clusters of 7 CTAs, two an
    SM) and at a lifted side of 120 (P = 128: clusters of 8, one an SM);
    the dispatch's default on the card is the split tier."""
    M, c, Y = _cheb_inputs(cuda, B=B, m=m)
    _, _, carries = kc.cheb_filter_planes(M, c, 48, carries=True)
    before = kc.bwd_launches.count
    kw = {} if three_pass else {"three_pass": False}
    Abar, cbar = kc.cheb_bwd(M, c, carries, Y, 48, **kw)
    assert kc.bwd_launches.count == before + 1
    Ap, cp = kc.cheb_bwd_plain(M, c, [x[:, :m, :m] for x in carries], Y, 48, three_pass,
                               three_pass)
    Mb, Mbp = kc.normalization_backward(M, Abar), kc.normalization_backward(M, Ap)
    tol = K6_TOL[three_pass]
    assert bool(torch.all(torch.isfinite(torch.view_as_real(Mb))))
    assert _rel(Mb, Mbp, torch.median) < tol["median"] and _rel(Mb, Mbp) < tol["max"]
    assert _rel(cbar, cp) < tol["cbar"]


@pytest.mark.cuda
@pytest.mark.parametrize("m", [24, 101, 120])
@pytest.mark.parametrize("degree", [2, 3, 48])
def test_cheb_bwd_kernel_edges(cuda, degree, m):
    """K6 at the loop's bounds (degree 2: no step but the first; 3: one
    rebuild, of b_degree), at a side that leaves whole bands of the cluster
    as padding (m = 24), at the GLayer's (m = 101, P = 112) and at a lifted
    side of the P = 128 instantiation (m = 120: clusters of 8 CTAs), with a
    zero matrix: vs its rounded split emulation, finite, and every padded
    row and column of Abar exactly 0.  The 1e-3 limit catches a wrong band
    or step, not a lost digit: K6's precision is held in
    test_cheb_bwd_kernel_matches_plain, at both plane sides."""
    M, c, Y = _cheb_inputs(cuda, B=8, m=m, degree=degree, seed=degree)
    M[-1] = 0
    _, _, carries = kc.cheb_filter_planes(M, c, degree, carries=True)
    ABr, ABi, cbar = kc.cheb_bwd_planes(M, c, carries, Y, degree)
    for x in (ABr, ABi):
        assert bool(torch.all(x[:, m:, :] == 0)) and bool(torch.all(x[:, :, m:] == 0))
        assert bool(torch.all(torch.isfinite(x)))
    Ap, cp = kc.cheb_bwd_plain(M, c, [x[:, :m, :m] for x in carries], Y, degree, True, True)
    assert _rel(torch.complex(ABr[:, :m, :m], ABi[:, :m, :m]), Ap) < 1e-3
    assert _rel(cbar, cp) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("B", [16, 64])
def test_cheb_filter_fn_backward_on_cuda(cuda, B):
    """Gradients through ``cheb_filter_matrices`` on the card (K5 + K6 at
    the card's tiers) vs torch autograd through the fp32 plain forward,
    Hermitian parts (the kernel symmetrizes the cotangent, plain autograd
    does not): the one-pass forward's states differ from the fp32 ones at
    ~1e-3 and the reversible backward rebuilds them from its carries, so
    ~2.5x the card tiers' distance on the CPU's emulation
    (tests/golden/cheb_tier_gap.py: Mbar 8.5e-3, cbar 2.3e-5)."""
    M, c, W = _cheb_inputs(cuda, B=B)
    grads = []
    for fn in (kc.cheb_filter_matrices, kc.cheb_filter_matrices_plain):
        Mg, cg = M.clone().requires_grad_(True), c.clone().requires_grad_(True)
        (fn(Mg, cg, 48) * W.conj()).real.sum().backward()
        herm = 0.5 * (Mg.grad + Mg.grad.conj().transpose(-1, -2))
        grads.append((herm, cg.grad))
    assert _rel(grads[0][0], grads[1][0]) < 2e-2
    assert _rel(grads[0][1], grads[1][1]) < 6e-5


# ---- the peak search kernel -------------------------------------------------------

def _peak_phi(source, B, dev):
    """phi of B scenes: K2's at the detection budget on anchor scenes, or
    complex normal noise (many local maxima, none dominant)."""
    if source == "random":
        g = torch.Generator().manual_seed(B)
        return torch.randn(B, 100, dtype=torch.complex64, generator=g).to(dev)
    y, b, s = (torch.from_numpy(x).to(dev) for x in make_anchor_batch(B, "redemod", seed=B))
    return admm_solve_fixed(y, b, s, DETECTION_BUDGET_ITERS, 1.0,
                            ADMMOptions(g_update="fused_fast"))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 7, 8192])
@pytest.mark.parametrize("source", ["k2", "random"])
@pytest.mark.parametrize("cfg", [PRODUCTION_PEAKS, PeakSearchConfig()],
                         ids=["production", "default"])
def test_peak_kernel_matches_plain(cuda, cfg, source, B):
    """The kernel against the plain version on the card, on the same phi.
    A scene may differ only where the plain version's coarse grid decides
    a seed at a near tie (another summation order breaks it the other way,
    as the benchmark's peak_gap allows), and there every kernel peak is
    still a real peak of the spectrum."""
    phi = _peak_phi(source, B, cuda)
    pk = find_peaks(phi, 10, 10, cfg)
    pp = PeakResult(*find_peaks_plain(phi, 10, 10, cfg))
    torch.cuda.synchronize()
    assert pk.tau.shape == pp.tau.shape == (B, cfg.max_peaks)
    assert bool((pk.height[:, 1:] <= pk.height[:, :-1]).all())
    n_differ, n_bad = peak_lists_held(phi, pk, pp, cfg)
    assert n_bad == 0, f"{n_bad} of {n_differ} differing scenes not at a near tie"


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [PRODUCTION_PEAKS, PeakSearchConfig()],
                         ids=["production", "default"])
def test_peak_kernel_tier_control(cuda, cfg):
    """PEAK_H_TOL tells the refine's tiers apart: the kernel against the
    plain version at the other tier (one-pass bf16 against fp32, and fp32
    against one-pass) on K2's phi at B = 8192 fails the lists' match in
    every scene, and by heights alone, wherever the peaks stand, in every
    scene too; against the plain version at its own tier it passes."""
    phi = _peak_phi("k2", 8192, cuda)
    tiers = ("default", "highest")
    plain = {t: PeakResult(*find_peaks_plain(phi, 10, 10, replace(cfg, refine_precision=t)))
             for t in tiers}
    for t, other in (tiers, tiers[::-1]):
        c = replace(cfg, refine_precision=t)
        pk = find_peaks(phi, 10, 10, c)
        assert bool(peak_lists_match(pk, plain[t], c).all())
        assert not bool(peak_lists_match(pk, plain[other], c).any())
        heights = peak_height_gap(pk, plain[other], c, anywhere=True)
        assert float(heights.min()) > PEAK_H_TOL[t]


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [PRODUCTION_PEAKS, PeakSearchConfig()],
                         ids=["production", "default"])
def test_peak_kernel_pads_as_plain(cuda, cfg):
    """Nb = Nd = 2 leaves a few local maxima on the grid, so most of the K
    entries are padding: refined from (delay_min, doppler_min), height
    -inf, valid False, last."""
    g = torch.Generator().manual_seed(5)
    phi = torch.randn(64, 4, dtype=torch.complex64, generator=g).to(cuda)
    pk = find_peaks(phi, 2, 2, cfg)
    pp = PeakResult(*find_peaks_plain(phi, 2, 2, cfg))
    assert bool((pk.valid.sum(-1) < cfg.max_peaks).all())
    assert bool(torch.equal(pk.valid, pp.valid))
    assert bool(peak_lists_match(pk, pp, cfg).all())


@pytest.mark.cuda
@pytest.mark.parametrize("Nb, Nd, cfg", [
    (4, 4, PeakSearchConfig(max_peaks=32, refine_points=32, refine_iters=3)),
    (7, 17, PeakSearchConfig(delay_step=0.009, doppler_step=0.0137, max_peaks=5,
                             refine_precision="default")),
    (3, 37, PeakSearchConfig(max_peaks=16, refine_points=21, refine_iters=1,
                             refine_precision="default")),
], ids=["K32_P32", "grid73x112", "Nd37"])
def test_peak_kernel_edges_match_plain(cuda, Nb, Nd, cfg):
    """The kernel's limits (K = P = 32), a grid whose rows are no multiple
    of the coarse product's four and Nb != Nd, held as at the deploy point."""
    g = torch.Generator().manual_seed(Nb * Nd)
    phi = torch.randn(64, Nb * Nd, dtype=torch.complex64, generator=g).to(cuda)
    pk = find_peaks(phi, Nb, Nd, cfg)
    pp = PeakResult(*find_peaks_plain(phi, Nb, Nd, cfg))
    assert bool((pk.height[:, 1:] <= pk.height[:, :-1]).all())
    n_differ, n_bad = peak_lists_held(phi, pk, pp, cfg, Nb, Nd)
    assert n_bad == 0, f"{n_bad} of {n_differ} differing scenes not at a near tie"


@pytest.mark.cuda
def test_peak_kernel_refuses_another_layout(cuda, monkeypatch):
    """The launcher takes the wrapper's count of the block's shared memory
    and refuses a launch where it is not the C layout's."""
    true = kps.smem_bytes
    monkeypatch.setattr(kps, "smem_bytes", lambda *a: true(*a) + 16)
    phi = _peak_phi("random", 4, cuda)
    before = kps.launches.count
    with pytest.raises(RuntimeError, match="layout"):
        find_peaks(phi, 10, 10, PRODUCTION_PEAKS)
    assert kps.launches.count == before


@pytest.mark.cuda
def test_peak_kernel_one_launch_a_call(cuda):
    """Each find_peaks call on the card is one launch, whatever the batch
    shape, counted as launches.peaks."""
    from admmnet_tpu_torch.utils import profiling

    phi = _peak_phi("random", 12, cuda).reshape(3, 4, 100)
    before = kps.launches.count
    for i in range(3):
        out = find_peaks(phi, 10, 10, PRODUCTION_PEAKS)
        assert kps.launches.count == before + i + 1
    assert out.tau.shape == (3, 4, PRODUCTION_PEAKS.max_peaks)
    assert profiling.snapshot()["launches.peaks"]["count"] == kps.launches.count


# ---- data parallelism on the card ----------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("B", [64, 8192])
def test_sharded_solve_gloo_fleet_on_one_card(cuda, B):
    """Two gloo ranks, both on cuda:0 (NCCL refuses two ranks on one
    device), run the deploy point on B anchor instances sharded (the fused
    solve K2 at DETECTION_BUDGET_ITERS, then PRODUCTION_PEAKS on each
    shard): the gathered phi equals the single process's bit for bit (the
    kernel is per instance), the peak lists' valid flags too and their
    positions and heights within 1e-6 of their largest (each scene is one
    block of the peak kernel), and each rank launched K2."""
    import torch_rank_fns
    from admmnet_tpu_torch.kernels import _build
    from admmnet_tpu_torch.parallel import spawn_ranks
    from admmnet_tpu_torch.solver import admm_solve_fixed

    _build.lib()  # built once here; the ranks load it
    y, b, s = make_anchor_batch(B, mode="redemod", seed=0)
    opts = ADMMOptions(g_update="fused_fast")
    ranks = spawn_ranks(torch_rank_fns.sharded_solve, 2, backend="gloo", device="cuda:0",
                        args=(y, b, s, DETECTION_BUDGET_ITERS, opts), timeout=300)
    phi = admm_solve_fixed(*(torch.from_numpy(a).to(cuda) for a in (y, b, s)),
                           DETECTION_BUDGET_ITERS, opts=opts)
    single = {k: v.cpu().numpy() for k, v in
              find_peaks(phi, 10, 10, PRODUCTION_PEAKS)._asdict().items()}
    for got, peaks, launches in ranks:
        assert launches > 0
        np.testing.assert_array_equal(got, phi.cpu().numpy())
        np.testing.assert_array_equal(peaks["valid"], single["valid"])
        for k in ("tau", "f", "height"):
            v = single[k].astype(np.float64)
            scale = np.max(np.abs(v[np.isfinite(v)]))
            diff = np.abs(np.where(peaks[k] == v, 0.0, peaks[k] - v))
            assert float(np.max(diff)) <= 1e-6 * scale, k


@pytest.mark.cuda
@pytest.mark.parametrize("size", ["small", "net10"])
def test_nccl_world_one_trainer_equals_no_mesh(cuda, tmp_path, size):
    """A one-rank NCCL fleet (DDP, the ZLayer bound to the fleet) trains
    bit for bit as the trainer without a mesh: a small net for 3 steps, and
    the flagship net-10 (MN = 100, the net-3 recipe's other settings) for
    20 steps of a batch of 256."""
    import torch_rank_fns
    from admmnet_tpu_torch.core.config import DataConfig, ModelConfig, ProblemSpec, TrainConfig
    from admmnet_tpu_torch.data.generator import generate_batch
    from admmnet_tpu_torch.kernels import _build
    from admmnet_tpu_torch.parallel import spawn_ranks
    from admmnet_tpu_torch.train.trainer import train_admmnet

    _build.lib()
    if size == "small":
        spec = ProblemSpec(Nb=4, Nd=4, L_max=2)
        mcfg = ModelConfig(spec=spec, num_layers=2, hidden_dim=32, g_mode="chebyshev",
                           cheb_impl="pallas", head="spectrum")
        tcfg = TrainConfig(batch_size=32, epochs=3, assignment="perm")
    else:
        spec = ProblemSpec(Nb=10, Nd=10, L_max=3)
        mcfg = ModelConfig(spec=spec, num_layers=10, g_mode="chebyshev", cheb_impl="pallas",
                           head="spectrum")
        tcfg = TrainConfig(batch_size=256, epochs=20, lr=1e-3, assignment="perm",
                           spectral_weight=0.5, patience=100, seed=0)
    data = generate_batch(DataConfig(spec=spec), tcfg.batch_size,
                          torch.Generator().manual_seed(0), device="cpu")
    (losses, params), = spawn_ranks(torch_rank_fns.train_steps, 1, backend="nccl",
                                    device="cuda", args=(data, mcfg, tcfg), timeout=300)
    ref = train_admmnet(mcfg, tcfg, data, data, workdir=tmp_path, log_fn=lambda *_: None,
                        device=cuda)
    assert losses == ref.history["train_loss"]
    for k, v in ref.params.items():
        np.testing.assert_array_equal(params[k], v.numpy())


# ---- the batched Jacobi eigensolver ----------------------------------------------
def _eigh_held(M, w, V, sweeps):
    from admmnet_tpu_torch.kernels import eigh as ke

    rec, orth, werr = (float(x.max()) for x in eigh_errors(M, w, V))
    assert rec <= EIGH_REC_TOL
    assert orth <= EIGH_ORTH_TOL
    assert werr <= EIGH_W_TOL
    assert bool((w[..., 1:] >= w[..., :-1]).all())
    assert int(sweeps.max()) < ke.MAX_SWEEPS


# Sides beside the layout's edges whose mp / 2 pairs deal phase 2's units
# over the 32 warps differently: 1 (one pair, no block pair of A), 33, 64
# and 65 (fewer steps of A than warps: some warps update V alone), 119 (odd,
# padded to the largest side).
@pytest.mark.cuda
@pytest.mark.parametrize("B, m", [(1, 101), (7, 101), (4096, 101), (7, 2), (7, 3), (7, 16),
                                  (7, 100), (7, 120), (7, 1), (7, 33), (7, 64), (7, 65),
                                  (7, 119)])
def test_eigh_kernel_random(cuda, B, m):
    from admmnet_tpu_torch.kernels import eigh as ke

    M = torch.from_numpy(_hermitian(np.random.default_rng(B * 1000 + m), B, m)).to(cuda)
    _eigh_held(M, *ke.eigh_kernel(M, sweeps=True))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["zero", "diagonal", "repeated", "rank-1"])
@pytest.mark.parametrize("m", [3, 16, 101, 120, 1, 33, 64, 65, 119])
def test_eigh_kernel_edge_spectra(cuda, case, m):
    from admmnet_tpu_torch.kernels import eigh as ke

    M = eigh_edge_batch(m, cuda)[case]
    w, V, sweeps = ke.eigh_kernel(M, sweeps=True)
    _eigh_held(M, w, V, sweeps)
    if case in ("zero", "diagonal"):
        assert int(sweeps.max()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("m", [101, 120])
def test_eigh_kernel_sweeps_match_plain(cuda, m):
    """The kernel rotates in as many sweeps as its plain version, matrix by
    matrix, on a seeded batch of 64: the same pairs, rotations, threshold
    and stop; a rounding may flip a matrix whose last |a_pq| sits at the
    threshold, so 62 of the 64 must agree."""
    from admmnet_tpu_torch.kernels import eigh as ke

    M = torch.from_numpy(_hermitian(np.random.default_rng(m), 64, m)).to(cuda)
    kernel = ke.eigh_kernel(M, sweeps=True)[2].cpu()
    plain = ke.eigh_jacobi_plain(M.cpu(), sweeps=True)[2]
    assert int((kernel == plain).sum()) >= 62


@pytest.mark.cuda
@pytest.mark.parametrize("B, trained", [(64, False), (256, True)])
def test_eigh_glayer_kernel_route_matches_complex128(cuda, B, trained):
    """The eigh GLayer on the card (the kernel, gradient through the
    eigenvalues) against the same layer on the CPU (complex128 eigh):
    forward and the gradients of a random functional of G with respect to
    phi, h, Z and the parameters (EIGH_GLAYER_TOL, EIGH_GLAYER_GRAD_TOL);
    at its init, and with the trained weights of runs/admmnet10's first
    GLayer."""
    import json
    from pathlib import Path

    from admmnet_tpu_torch.core.convert import options_from_jax, params_from_jax
    from admmnet_tpu_torch.kernels import eigh as ke
    from admmnet_tpu_torch.models.layers import GLayer
    from admmnet_tpu_torch.train.checkpoint import restore_checkpoint

    torch.manual_seed(3)
    n = 100
    layer = GLayer(n, mode="eigh")
    if trained:
        run = Path(__file__).resolve().parents[1] / "runs" / "admmnet10"
        cfg = options_from_jax(json.loads((run / "config.json").read_text())["model"])
        params = params_from_jax(restore_checkpoint(run)[0]["params"]["params"], cfg)
        layer = GLayer(n, value_hidden=cfg.value_net_hidden, mode="eigh")
        layer.load_state_dict({k[len("trunk.g_0."):]: v for k, v in params.items()
                               if k.startswith("trunk.g_0.")})
    phi = torch.randn(B, n, dtype=torch.complex64) * 0.3
    h = torch.rand(B, n) * 0.05
    Z = torch.from_numpy(_hermitian(np.random.default_rng(4), B, n + 1)) * 0.05
    probe = torch.randn(B, n + 1, n + 1, dtype=torch.complex64)

    def run(device):
        args = [t.to(device).clone().requires_grad_() for t in (phi, h, Z)]
        lay = layer.to(device)
        lay.zero_grad()
        G = lay(*args)
        (G * probe.to(device)).real.sum().backward()
        return G.detach().cpu(), [a.grad.cpu() for a in args] + [
            p.grad.cpu() for p in lay.parameters() if p.grad is not None]

    before = ke.launches.count
    G_k, g_k = run(cuda)
    assert ke.launches.count == before + 1
    G_p, g_p = run("cpu")
    assert _rel(G_k, G_p) <= EIGH_GLAYER_TOL
    for a, b in zip(g_k, g_p):
        gap = float(torch.linalg.norm((a - b).reshape(-1)) / torch.linalg.norm(b.reshape(-1)))
        assert gap <= EIGH_GLAYER_GRAD_TOL


@pytest.mark.cuda
def test_eigh_net_train_step_matches_complex128_route(cuda, monkeypatch):
    """One step of upstream's training recipe (``build_steps(mode="e2e")``,
    slot pairing, clip 1.0, AdamW in two groups) on runs/admmnet10's net at
    B = 256 on the card, its nine eigh GLayers on the Jacobi kernel,
    against the same step with every eigendecomposition in complex128
    (``hermitian_eigh``) on the same batch with the same dropout masks:
    the loss, the clipped gradient and the update by the worst leaf
    (EIGH_TRAIN_*)."""
    from admmnet_tpu_torch.core.config import DataConfig, TrainConfig
    from admmnet_tpu_torch.core.convert import options_from_jax, params_from_jax
    from admmnet_tpu_torch.data.generator import generate_batch
    from admmnet_tpu_torch.kernels import eigh as ke
    from admmnet_tpu_torch.models import ADMMNet
    from admmnet_tpu_torch.ops.projections import hermitian_eigh
    from admmnet_tpu_torch.train.checkpoint import restore_checkpoint
    from admmnet_tpu_torch.train.trainer import batch_to_device, build_steps, make_optimizer

    run_dir = Path(__file__).resolve().parents[1] / "runs" / "admmnet10"
    cfg = options_from_jax(json.loads((run_dir / "config.json").read_text())["model"])
    params = params_from_jax(restore_checkpoint(run_dir)[0]["params"]["params"], cfg)
    tcfg = TrainConfig(batch_size=256, assignment="slot")
    data = generate_batch(DataConfig(spec=cfg.spec, snr_range=(20.0, 20.0)), 256,
                          torch.Generator(device=cuda).manual_seed(5), cuda)
    batch = batch_to_device({k: data[k] for k in ("y", "b", "sigma", "tau", "f", "L_true")},
                            cuda)

    def one_step():
        net = ADMMNet(cfg)
        net.load_state_dict(params)
        net = net.to(cuda)
        net.peak_head.attention.dropout_generator = torch.Generator(device=cuda).manual_seed(7)
        opt = make_optimizer(net, tcfg)
        step, _ = build_steps(net, opt, "e2e", lambda s: tcfg.lr, grad_clip=tcfg.grad_clip,
                              assignment="slot")
        loss = float(step(batch, 0))
        return (loss, {k: p.grad.detach().clone() for k, p in net.named_parameters()},
                {k: (p.detach() - params[k].to(cuda)) for k, p in net.named_parameters()})

    before = ke.launches.count
    loss_k, grad_k, upd_k = one_step()
    assert ke.launches.count == before + cfg.num_layers - 1

    def complex128_route(M):
        w, V = hermitian_eigh(M)
        return w.to(torch.float32), V.to(torch.complex64).detach()

    monkeypatch.setattr(ke, "eigh_detached", complex128_route)
    loss_r, grad_r, upd_r = one_step()
    norms = {k: float(torch.linalg.vector_norm(g)) for k, g in grad_r.items()}
    med = float(np.median(list(norms.values())))
    keep = [k for k, v in norms.items() if v >= 1e-3 * med]

    def worst(x, r):
        return max(float(torch.linalg.vector_norm(x[k] - r[k]) / torch.linalg.vector_norm(r[k]))
                   for k in keep)

    gaps = (abs(loss_k - loss_r) / abs(loss_r), worst(grad_k, grad_r), worst(upd_k, upd_r))
    print(f"eigh train step on the card: loss {gaps[0]:.3e} gradient {gaps[1]:.3e} "
          f"update {gaps[2]:.3e} ({len(keep)} of {len(norms)} leaves)")
    assert gaps[0] <= EIGH_TRAIN_LOSS_TOL
    assert gaps[1] <= EIGH_TRAIN_GRAD_TOL
    assert gaps[2] <= EIGH_TRAIN_STEP_TOL
