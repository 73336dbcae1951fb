"""CUDA kernels of the port vs their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  The file
imports neither JAX nor the JAX package, so it also runs on a machine
without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: kernel (3xTF32 on the tensor cores, fp32-faithful; K1's
bf16_store low steps in fp32 FMAs) and plain version compute every
product in fp32 with sums in another order; through the accurate schedule's amplification that
stays below 1e-4 relative for one projection, below 1e-3 for 20
iterations of the fused solves (where a last-bit difference can also flip
a bisection decision of the H-projection), below 1e-2 for the bf16
iterate storage (where it can flip a bf16 rounding, 2^-8 relative), whose
median matrix must agree to 1e-5 and stand more than 1e-3 from the fp32
store (one flip is ~3e-3, fp32 noise ~1e-7), below 5e-5 for the 48
dependent steps of a Clenshaw evaluation at the GLayer's side (measured
5.7e-7 on random matrices on an H100; at the edge sides, where small
spiked matrices amplify any rounding, within 8x the fp32 plain version's
distance from fp64), and below 1e-3
for the reversible backward, which rebuilds the forward's states from its
last two.
"""

import numpy as np
import pytest
import torch

from admmnet_tpu_torch.core.config import ADMMOptions
from admmnet_tpu_torch.data.anchor import ANCHOR_C, ANCHOR_F, ANCHOR_TAU, _psi, make_anchor_batch
from admmnet_tpu_torch.kernels import cheb_filter as kc
from admmnet_tpu_torch.kernels import fused_admm as k7
from admmnet_tpu_torch.kernels import fused_admm_fast as kf
from admmnet_tpu_torch.kernels import polar as kp
from admmnet_tpu_torch.ops.projections import POLAR_BF16_SCHED2, psd_project_eigh
from admmnet_tpu_torch.solver.admm import fused_kernel_options


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b, reduce=torch.max):
    """Per-instance relative error of a against b, reduced over instances."""
    a, b = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
    return float(reduce(torch.linalg.norm(a - b, dim=-1) / torch.linalg.norm(b, dim=-1)))


@pytest.mark.cuda
@pytest.mark.parametrize("mode, eigh_tol", [("accurate", 2e-4), ("fast", 5e-4)])
def test_polar_kernel_matches_plain(cuda, mode, eigh_tol):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(64, 101, 101)) + 1j * rng.normal(size=(64, 101, 101))
    M = np.ascontiguousarray((X + X.conj().transpose(0, 2, 1)) / 2, np.complex64)
    M = torch.from_numpy(M).to(cuda)
    before = kp.launches.count
    Pk = kp.psd_project_polar_kernel(M, mode=mode)
    assert kp.launches.count == before + 1
    assert _rel(Pk, kp.psd_project_polar_plain(M, mode=mode)) < 1e-4
    assert _rel(Pk, psd_project_eigh(M)) < eigh_tol


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
    padded row and column exactly 0, the rest held to the plain version.
    The error is taken against ||M|| (a 1 x 1 projection of a negative
    entry is exactly 0): the fp32 modes within 1e-4, bf16_store's median
    matrix within 1e-5 and every matrix within 1e-2 (where a sum in another
    order flips one bf16 rounding)."""
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
    Pp = kp.psd_project_polar_plain(M[:-1], mode, hi_steps, bf16_store)
    err = (torch.linalg.norm((Pk - Pp).reshape(4, -1), dim=-1)
           / torch.linalg.norm(M[:-1].reshape(4, -1), dim=-1))
    if bf16_store:
        assert float(err.median()) < 1e-5 and float(err.max()) < 1e-2
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


def _anchor_rows(n, dev):
    """64 instances of the anchor's three targets at side n: the anchor
    batch at n = 100; at other sides the same targets on an Nb x Nd grid
    (GRIDS; n = 119 is lifted side 120, plane side 128) with fresh QPSK
    symbols, 7 dB demodulation errors and 20 dB noise, as
    make_anchor_batch builds them."""
    if n == 100:
        rows = make_anchor_batch(64, "redemod", seed=0)
    else:
        Nb, Nd = GRIDS[n]
        rng = np.random.default_rng(0)
        sym = np.exp(1j * (np.pi / 2 * rng.integers(0, 4, size=(64, n)) + np.pi / 4))
        noise = np.sqrt(10 ** -0.7 / 2) * (rng.standard_normal((64, n))
                                           + 1j * rng.standard_normal((64, n)))
        quad = np.floor(np.mod(np.angle(sym + noise), 2 * np.pi) * 2 / np.pi).astype(int) % 4
        b = np.exp(1j * (np.pi / 2 * quad + np.pi / 4))
        clean = sym * _psi(ANCHOR_TAU, ANCHOR_F, ANCHOR_C, Nb, Nd)[None]
        w_var = np.linalg.norm(clean, axis=-1, keepdims=True) ** 2 / (100.0 * n)
        y = clean + np.sqrt(w_var / 2) * (rng.standard_normal((64, n))
                                          + 1j * rng.standard_normal((64, n)))
        sigma = np.linalg.norm((sym - b) / b, axis=-1) + 1.0
        rows = (y.astype(np.complex64), b.astype(np.complex64), sigma.astype(np.float32))
    return [torch.from_numpy(x).to(dev) for x in rows]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [100, 119])
@pytest.mark.parametrize("g_update", ["fused_fast", "fused_exact"])
def test_fused_kernel_matches_plain(cuda, g_update, n):
    y, b, s = _anchor_rows(n, cuda)
    kw = fused_kernel_options(ADMMOptions(g_update=g_update))
    before = kf.launches.count
    pk = kf.admm_solve_fused_fast(y, b, s, 20, **kw)
    assert kf.launches.count == before + 1
    assert _rel(pk, kf.admm_solve_fused_fast_plain(y, b, s, 20, **kw)) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("fold_diag", [True, False])
@pytest.mark.parametrize("n", [10, 16, 111, 126])
def test_fused_kernel_edges_match_plain(cuda, n, fold_diag):
    """Sides whose bands are mostly padding or whose row n opens or closes
    a band, and a hi step without three_pass (the polish step: no
    re-projection) with hi closing products."""
    y, b, s = _anchor_rows(n, cuda)
    kw = dict(hi_steps=1, outer_iters=4, inner_iters=3, final_hi=True, layout="lean",
              fold_diag=fold_diag, warm_root=True)
    pk = kf.admm_solve_fused_fast(y, b, s, 20, 1.3, 0.8, **kw)
    assert bool(torch.all(torch.isfinite(torch.view_as_real(pk))))
    assert _rel(pk, kf.admm_solve_fused_fast_plain(y, b, s, 20, 1.3, 0.8, **kw)) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("n", [100, 119])
@pytest.mark.parametrize("layout", ["lists", "lean"])
def test_unfolded_fused_kernels_match_plain(cuda, layout, n):
    """K3 (lists) and K2's unfolded carry at the pinned control knobs."""
    y, b, s = _anchor_rows(n, cuda)
    kw = dict(hi_steps=0, outer_iters=4, inner_iters=3, schedule=POLAR_BF16_SCHED2,
              final_hi=False, layout=layout, fold_diag=False)
    counter = kf.lists_launches if layout == "lists" else kf.launches
    before = counter.count
    pk = kf.admm_solve_fused_fast(y, b, s, 20, 1.7, **kw)
    assert counter.count == before + 1
    assert _rel(pk, kf.admm_solve_fused_fast_plain(y, b, s, 20, 1.7, **kw)) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("n", [100, 119])
@pytest.mark.parametrize("ablate", kf.ABLATE[1:])
def test_ablate_kernels_match_plain(cuda, ablate, n):
    """K2's profiling variants (B6) at runs/profile_lean.py's knobs."""
    y, b, s = _anchor_rows(n, cuda)
    kw = dict(hi_steps=0, outer_iters=4, inner_iters=3, schedule=POLAR_BF16_SCHED2,
              final_hi=False, layout="lean", fold_diag=False, ablate=ablate)
    before = kf.launches.count
    pk = kf.admm_solve_fused_fast(y, b, s, 20, **kw)
    assert kf.launches.count == before + 1
    assert bool(torch.all(torch.isfinite(torch.view_as_real(pk))))
    assert _rel(pk, kf.admm_solve_fused_fast_plain(y, b, s, 20, **kw)) < 1e-3


@pytest.mark.cuda
def test_k7_kernel_matches_plain(cuda):
    y, b, s = (torch.from_numpy(x).to(cuda) for x in make_anchor_batch(16, "redemod", seed=0))
    before = k7.launches.count
    pk = k7.admm_solve_fused(y, b, s, 20, 2.0, 0.5)
    assert k7.launches.count == before + 1
    assert _rel(pk, k7.admm_solve_fused_plain(y, b, s, 20, 2.0, 0.5)) < 1e-3


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
@pytest.mark.parametrize("hi_steps", [0, 1])
def test_polar_bf16_store_matches_plain(cuda, hi_steps):
    rng = np.random.default_rng(1)
    X = rng.normal(size=(64, 101, 101)) + 1j * rng.normal(size=(64, 101, 101))
    M = torch.from_numpy(np.ascontiguousarray((X + X.conj().transpose(0, 2, 1)) / 2,
                                              np.complex64)).to(cuda)
    Pk = kp.psd_project_polar_kernel(M, mode="fast", hi_steps=hi_steps, bf16_store=True)
    Pp = kp.psd_project_polar_plain(M, "fast", hi_steps, bf16_store=True)
    assert _rel(Pk, Pp) < 1e-2
    assert _rel(Pk, Pp, torch.median) < 1e-5
    # the rounding shows: the fp32 store is a bf16 flip away on most matrices
    P32 = kp.psd_project_polar_kernel(M, mode="fast", hi_steps=hi_steps)
    assert _rel(Pk, P32, torch.median) > 1e-3
    assert _rel(Pk, psd_project_eigh(M)) < 8e-3


@pytest.mark.cuda
def test_cheb_kernel_matches_plain(cuda):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(64, 101, 101)) + 1j * rng.normal(size=(64, 101, 101))
    M = np.ascontiguousarray((X + X.conj().transpose(0, 2, 1)) / 2, np.complex64)
    M[-1] = 0
    M = torch.from_numpy(M).to(cuda)
    c = torch.from_numpy((rng.normal(size=(64, 48)) * 0.3).astype(np.float32)).to(cuda)
    before = kc.launches.count
    G = kc.cheb_filter_matrices(M, c, 48)
    assert kc.launches.count == before + 1
    Gp = kc.cheb_filter_matrices_plain(M, c, 48)
    assert _rel(G[:-1], Gp[:-1]) < 5e-5
    assert torch.equal(G[-1], Gp[-1])  # A = 0: no product carries rounding
    Gr, Gi = kc.cheb_filter_planes(M, c, 48)
    for X in (Gr, Gi):
        assert bool(torch.all(X[:, 101:, :] == 0)) and bool(torch.all(X[:, :, 101:] == 0))
    # a call that needs a gradient runs the training forward K5 instead,
    # whose output is K4's bit for bit
    before, before5 = kc.launches.count, kc.fwd_launches.count
    G5 = kc.cheb_filter_matrices(M.clone().requires_grad_(True), c, 48)
    assert (kc.launches.count, kc.fwd_launches.count) == (before, before5 + 1)
    assert torch.equal(G5.detach(), G)


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
    """K5: K4's output bit for bit, and the final carries of the plain
    forward (fp32 sums in another order through 47 steps)."""
    M, c, _ = _cheb_inputs(cuda)
    G4r, G4i = kc.cheb_filter_planes(M, c, 48)
    before = kc.fwd_launches.count
    Gr, Gi, carries = kc.cheb_fwd_planes(M, c, 48)
    assert kc.fwd_launches.count == before + 1
    assert torch.equal(Gr, G4r) and torch.equal(Gi, G4i)
    _, plain = kc.cheb_filter_matrices_plain_with_residuals(M, c, 48)
    for k, p in zip(carries, plain):
        assert bool(torch.all(k[:, 101:, :] == 0)) and bool(torch.all(k[:, :, 101:] == 0))
        assert _rel(k[:, :101, :101], p) < 5e-5


def _fp32_faithful(k, p32, p64):
    """Matrices whose fp32 plain version is exactly zero (degree 1's carries,
    degree 2's b_2) must be exactly zero; the rest no further from the fp64
    evaluation than 8x the fp32 plain version is (3xTF32 rounds a product at
    ~2^-21, IEEE fp32 at 2^-24), plus 1e-6."""
    zero = torch.linalg.norm(p32.reshape(p32.shape[0], -1), dim=-1) == 0
    assert torch.equal(k[zero], p32[zero])
    if bool((~zero).any()):
        k, p32, p64 = k[~zero].to(p64.dtype), p32[~zero].to(p64.dtype), p64[~zero]
        assert _rel(k, p64) <= 8 * _rel(p32, p64) + 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("m", [10, 16, 101, 111, 120, 126])
@pytest.mark.parametrize("degree", [1, 2, 3, 48])
def test_cheb_fwd_kernel_edges(cuda, degree, m):
    """K4 and K5 at the loop's bounds (degree 1: no step, the product with
    b_1 = 0 only; 2: no step after the first; 3: one), at sides that leave
    whole bands of the cluster as padding (m = 10, 16), at the GLayer's
    (m = 101) and the last of P = 112 (m = 111), and at lifted sides of the
    P = 128 instantiation (m = 120, 126: clusters of 8 CTAs), with a zero
    matrix: G and the carries of the zero matrix exactly the plain
    version's, every padded row and column exactly 0, K5's G bitwise K4's,
    and the rest fp32-faithful against the fp64 evaluation (_fp32_faithful).
    A fixed limit against the fp32 plain version would not do here: on
    small matrices with a dominant eigenvalue the carries are
    ill-conditioned, and the plain version's own carries sit far from fp64
    (chip_smoke.py phase 14 prints the kernel's and the plain version's
    distances at m = 16).  At the GLayer's side the same kernels are held
    to the plain version within 5e-5
    (test_cheb_kernel_matches_plain, test_cheb_fwd_kernel_is_k4_with_carries,
    chip_smoke.py phases 10 and 14)."""
    M, c, _ = _cheb_inputs(cuda, B=8, m=m, degree=degree, seed=100 + degree)
    M[-1] = 0
    G4r, G4i = kc.cheb_filter_planes(M, c, degree)
    Gr, Gi, carries = kc.cheb_fwd_planes(M, c, degree)
    assert torch.equal(Gr, G4r) and torch.equal(Gi, G4i)
    Gp, plain = kc.cheb_filter_matrices_plain_with_residuals(M, c, degree)
    G64, plain64 = kc.cheb_filter_matrices_plain_with_residuals(
        M.to(torch.complex128), c.double(), degree)
    G = torch.complex(Gr[:, :m, :m], Gi[:, :m, :m])
    for x in (Gr, Gi, *carries):
        assert bool(torch.all(x[:, m:, :] == 0)) and bool(torch.all(x[:, :, m:] == 0))
        assert bool(torch.all(torch.isfinite(x)))
    assert torch.equal(G[-1], Gp[-1])  # A = 0: no product carries rounding
    _fp32_faithful(G[:-1], Gp[:-1], G64[:-1])
    for k, p, p64 in zip(carries, plain, plain64):
        assert torch.equal(k[-1, :m, :m], p[-1])
        _fp32_faithful(k[:-1, :m, :m], p[:-1], p64[:-1])


@pytest.mark.cuda
def test_cheb_bwd_kernel_matches_plain(cuda):
    """K6 vs ``cheb_bwd_plain`` on the same inputs (K5's carries)."""
    M, c, Y = _cheb_inputs(cuda)
    _, _, carries = kc.cheb_fwd_planes(M, c, 48)
    before = kc.bwd_launches.count
    Abar, cbar = kc.cheb_bwd(M, c, carries, Y, 48)
    assert kc.bwd_launches.count == before + 1
    Ap, cp = kc.cheb_bwd_plain(M, c, [x[:, :101, :101] for x in carries], Y, 48)
    assert _rel(Abar, Ap) < 1e-3
    assert _rel(cbar, cp) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("m", [24, 101, 120])
@pytest.mark.parametrize("degree", [2, 3, 48])
def test_cheb_bwd_kernel_edges(cuda, degree, m):
    """K6 at the loop's bounds (degree 2: no step but the first; 3: no
    rebuild), at a side that leaves whole bands of the cluster as padding
    (m = 24), at the GLayer's (m = 101, P = 112) and at a lifted side of the
    P = 128 instantiation (m = 120: clusters of 8 CTAs), with a zero matrix:
    vs its plain version, finite, and every padded row and column of Abar
    exactly 0.  The 1e-3 limit catches a wrong band or step, not a lost
    digit: K6's precision (3xTF32, fp32-faithful) is held to K6_PLAIN_TOL in
    chip_smoke.py phase 14, at both plane sides."""
    M, c, Y = _cheb_inputs(cuda, B=8, m=m, degree=degree, seed=degree)
    M[-1] = 0
    _, _, carries = kc.cheb_fwd_planes(M, c, degree)
    ABr, ABi, cbar = kc.cheb_bwd_planes(M, c, carries, Y, degree)
    for x in (ABr, ABi):
        assert bool(torch.all(x[:, m:, :] == 0)) and bool(torch.all(x[:, :, m:] == 0))
        assert bool(torch.all(torch.isfinite(x)))
    Ap, cp = kc.cheb_bwd_plain(M, c, [x[:, :m, :m] for x in carries], Y, degree)
    assert _rel(torch.complex(ABr[:, :m, :m], ABi[:, :m, :m]), Ap) < 1e-3
    assert _rel(cbar, cp) < 1e-3


@pytest.mark.cuda
def test_cheb_filter_fn_backward_on_cuda(cuda):
    """Gradients through ``cheb_filter_matrices`` on the card (K5 + K6) vs
    torch autograd through the plain forward, Hermitian parts (the kernel
    symmetrizes the cotangent, plain autograd does not)."""
    M, c, W = _cheb_inputs(cuda, B=16)
    grads = []
    for fn in (kc.cheb_filter_matrices, kc.cheb_filter_matrices_plain):
        Mg, cg = M.clone().requires_grad_(True), c.clone().requires_grad_(True)
        (fn(Mg, cg, 48) * W.conj()).real.sum().backward()
        herm = 0.5 * (Mg.grad + Mg.grad.conj().transpose(-1, -2))
        grads.append((herm, cg.grad))
    assert _rel(grads[0][0], grads[1][0]) < 1e-3
    assert _rel(grads[0][1], grads[1][1]) < 1e-3


# ---- data parallelism on the card ----------------------------------------------


@pytest.mark.cuda
def test_sharded_solve_gloo_fleet_on_one_card(cuda):
    """Two gloo ranks, both on cuda:0 (NCCL refuses two ranks on one
    device), solve B = 64 anchor instances sharded with the fused solve
    (K2): the gathered phi equals the single process's bit for bit (the
    kernel is per instance), and each rank launched K2."""
    import torch_rank_fns
    from admmnet_tpu_torch.kernels import _build
    from admmnet_tpu_torch.parallel import spawn_ranks
    from admmnet_tpu_torch.solver import admm_solve_fixed

    _build.lib()  # built once here; the ranks load it
    y, b, s = make_anchor_batch(64, mode="redemod", seed=0)
    opts = ADMMOptions(g_update="fused_fast")
    ranks = spawn_ranks(torch_rank_fns.sharded_solve, 2, backend="gloo", device="cuda:0",
                        args=(y, b, s, 10, opts), timeout=300)
    single = admm_solve_fixed(*(torch.from_numpy(a).to(cuda) for a in (y, b, s)), 10,
                              opts=opts).cpu().numpy()
    for phi, launches in ranks:
        assert launches > 0
        np.testing.assert_array_equal(phi, single)


@pytest.mark.cuda
def test_nccl_world_one_trainer_equals_no_mesh(cuda, tmp_path):
    """A one-rank NCCL fleet (DDP, the ZLayer bound to the fleet) trains
    bit for bit as the trainer without a mesh."""
    import torch_rank_fns
    from admmnet_tpu_torch.core.config import DataConfig, ModelConfig, ProblemSpec, TrainConfig
    from admmnet_tpu_torch.data.generator import generate_batch
    from admmnet_tpu_torch.kernels import _build
    from admmnet_tpu_torch.parallel import spawn_ranks
    from admmnet_tpu_torch.train.trainer import train_admmnet

    _build.lib()
    spec = ProblemSpec(Nb=4, Nd=4, L_max=2)
    data = generate_batch(DataConfig(spec=spec), 32, torch.Generator().manual_seed(0),
                          device="cpu")
    (losses, params), = spawn_ranks(torch_rank_fns.train_steps, 1, backend="nccl",
                                    device="cuda", args=(data, 3), timeout=300)
    ref = train_admmnet(ModelConfig(spec=spec, num_layers=2, hidden_dim=32, g_mode="chebyshev",
                                    cheb_impl="pallas", head="spectrum"),
                        TrainConfig(batch_size=32, epochs=3, assignment="perm"), data, data,
                        workdir=tmp_path, log_fn=lambda *_: None, device=cuda)
    assert losses == ref.history["train_loss"]
    for k, v in ref.params.items():
        np.testing.assert_array_equal(params[k], v.numpy())
