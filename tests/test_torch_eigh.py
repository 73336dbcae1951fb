"""The batched Jacobi eigensolver's plain version, its autograd wrapper and
the eigh GLayer's route, on the CPU (the kernel itself runs on the card:
tests/test_torch_cuda.py and chip_smoke.py's phase 28).

Tolerances: the plain version is the kernel's algorithm; in complex128
(the unit roundoff 2^-53 in its threshold) it must meet LAPACK to 1e-12
of ||M||; in complex64 within the kernel's own limits (chip_smoke's
EIGH_*_TOL: 1e-4 reconstruction and orthogonality, 5e-6 eigenvalues).
"""

import numpy as np
import pytest
import torch

from admmnet_tpu_torch.kernels import eigh as ke
from admmnet_tpu_torch.models.layers import GLayer
from admmnet_tpu_torch.utils import profiling


def _hermitian(B, m, seed, dtype=torch.complex128):
    g = torch.Generator().manual_seed(seed)
    X = torch.randn(B, m, m, dtype=dtype, generator=g)
    return 0.5 * (X + X.mH)


def _edge(case, m, seed=0):
    g = torch.Generator().manual_seed(seed)
    if case == "zero":
        return torch.zeros(1, m, m, dtype=torch.complex128)
    if case == "diagonal":
        return torch.diag(torch.randn(m, dtype=torch.float64, generator=g)).to(
            torch.complex128)[None]
    if case == "repeated":
        Q, _ = torch.linalg.qr(torch.randn(m, m, dtype=torch.complex128, generator=g))
        d = torch.tensor([float(i * 3 // m) - 1.0 for i in range(m)], dtype=torch.float64)
        return ((Q * d.to(Q.dtype)) @ Q.mH)[None]
    u = torch.randn(m, 1, dtype=torch.complex128, generator=g)
    return (u @ u.mH)[None]


def _errors(M, w, V):
    H = (0.5 * (M + M.mH)).to(torch.complex128)
    Vd = V.to(torch.complex128)
    rec = torch.linalg.norm((Vd * w.to(Vd.dtype)[..., None, :]) @ Vd.mH - H, dim=(-2, -1))
    nrm = torch.linalg.norm(H, dim=(-2, -1)).clamp_min(1e-300)
    orth = (Vd.mH @ Vd - torch.eye(M.shape[-1], dtype=Vd.dtype)).abs().amax(dim=(-2, -1))
    w_ref = torch.linalg.eigvalsh(H)
    scale = w_ref.abs().amax(-1).clamp_min(1e-300)
    return (float((rec / nrm).max()), float(orth.max()),
            float(((w.to(torch.float64) - w_ref).abs().amax(-1) / scale).max()))


@pytest.mark.parametrize("m", [1, 2, 3, 7, 10, 16])
def test_plain_jacobi_meets_lapack_in_complex128(m):
    M = _hermitian(4, m, seed=m)
    w, V, sweeps = ke.eigh_jacobi_plain(M, sweeps=True)
    rec, orth, werr = _errors(M, w, V)
    assert rec < 1e-12 and orth < 1e-12 and werr < 1e-12
    assert bool((w[..., 1:] >= w[..., :-1]).all())
    assert int(sweeps.max()) < ke.MAX_SWEEPS


@pytest.mark.parametrize("case", ["zero", "diagonal", "repeated", "rank-1"])
@pytest.mark.parametrize("m", [3, 8])
def test_plain_jacobi_edge_spectra(case, m):
    M = _edge(case, m)
    for dtype, tol in ((torch.complex128, 1e-12), (torch.complex64, 1e-5)):
        w, V, sweeps = ke.eigh_jacobi_plain(M.to(dtype), sweeps=True)
        assert w.dtype == M.to(dtype).real.dtype and V.dtype == dtype
        assert max(_errors(M, w, V)) < tol
        if case in ("zero", "diagonal"):
            assert int(sweeps.max()) == 0


def test_plain_jacobi_complex64_at_the_glayers_side():
    """m = 101 (the lifted side), complex64: the kernel's arithmetic, held to
    the limits the kernel is held to on the card."""
    M = _hermitian(2, 101, seed=5, dtype=torch.complex64)
    w, V, sweeps = ke.eigh_jacobi_plain(M, sweeps=True)
    rec, orth, werr = _errors(M, w, V)
    assert rec < 1e-4 and orth < 1e-4 and werr < 5e-6
    assert 4 <= int(sweeps.min()) and int(sweeps.max()) <= 12


def test_plain_jacobi_hermitianizes_and_keeps_batch_shape():
    g = torch.Generator().manual_seed(1)
    X = torch.randn(2, 3, 5, 5, dtype=torch.complex128, generator=g)
    w, V = ke.eigh_jacobi_plain(X)
    assert w.shape == (2, 3, 5) and V.shape == (2, 3, 5, 5)
    w_ref = torch.linalg.eigvalsh(0.5 * (X + X.mH))
    assert float((w - w_ref).abs().max()) < 1e-12


def test_round_robin_meets_every_pair_once_a_sweep():
    for mp in (2, 4, 10, 102):
        seen = []
        for r in range(mp - 1):
            p, q = ke.round_robin(mp, r)
            idx = torch.cat([p, q])
            assert idx.unique().numel() == mp  # the round's pairs are disjoint
            seen += [tuple(sorted(x)) for x in zip(p.tolist(), q.tolist())]
        assert len(seen) == len(set(seen)) == mp * (mp - 1) // 2


def test_layout_and_limits():
    assert ke.smem_bytes(101) == 168224
    assert ke.MAX_SIDE == 120
    assert ke.smem_bytes(120) <= ke.SMEM_LIMIT < ke.smem_bytes(121)


@pytest.mark.parametrize("M, err", [
    (torch.zeros(2, 4, 4, dtype=torch.complex128), TypeError),
    (torch.zeros(2, 4, 5, dtype=torch.complex64), ValueError),
    (torch.zeros(2, 121, 121, dtype=torch.complex64), ValueError),
    (torch.zeros(2, 4, 4, dtype=torch.complex64), ValueError),  # a CPU tensor
])
def test_kernel_refuses_what_it_does_not_take(M, err):
    with pytest.raises(err):
        ke.eigh_kernel(M)


@pytest.mark.parametrize("M, err", [
    (torch.zeros(2, 4, 4, dtype=torch.complex128), TypeError),
    (torch.zeros(2, 121, 121, dtype=torch.complex64), ValueError),  # side above MAX_SIDE
    (torch.zeros(2, 4, 4, dtype=torch.complex64), ValueError),  # a CPU tensor
])
def test_detached_eigh_refuses_what_the_kernel_does_not_take(M, err, monkeypatch):
    """``eigh_detached`` hands every matrix to the kernel: a side above
    ``MAX_SIDE`` is refused, naming the limit, before any CUDA call (no
    fallback to the complex128 library path)."""
    from admmnet_tpu_torch.kernels import _build

    def no_cuda():
        raise AssertionError("a CUDA call before the checks")

    monkeypatch.setattr(_build, "lib", no_cuda)
    with pytest.raises(err) as e:
        ke.eigh_detached(M.requires_grad_())
    if M.shape[-1] > ke.MAX_SIDE:
        assert f"1..{ke.MAX_SIDE}" in str(e.value)


def test_detached_eigh_gradient_is_torchs_with_v_detached(monkeypatch):
    """M_bar = V diag(w_bar) V^H: what torch.linalg.eigh's backward gives
    when V carries no gradient, through herm(M).  The solve is the kernel's
    algorithm in complex64 (its plain version), as a CUDA tensor takes it."""
    monkeypatch.setattr(ke, "_solve", lambda A: ke.eigh_jacobi_plain(A.contiguous()))
    M = torch.randn(3, 6, 6, dtype=torch.complex64, generator=torch.Generator().manual_seed(2))
    weights = torch.arange(6.0)
    a = M.clone().requires_grad_()
    w, V = ke.eigh_detached(a)
    assert not V.requires_grad
    (torch.sin(w) * weights).sum().backward()
    b = M.clone().requires_grad_()
    w2, _ = torch.linalg.eigh((0.5 * (b + b.mH)).to(torch.complex128))
    (torch.sin(w2.to(torch.float32)) * weights).sum().backward()
    assert float((w.detach() - w2.detach()).abs().max()) < 1e-5
    assert float((a.grad - b.grad).abs().max()) < 1e-5 * float(b.grad.abs().max())


def _glayer_case(n=15, B=6, seed=0):
    rng = np.random.default_rng(seed)
    phi = torch.from_numpy((rng.normal(size=(B, n)) + 1j * rng.normal(size=(B, n))).astype(
        np.complex64)) * 0.3
    h = torch.from_numpy(rng.uniform(size=(B, n)).astype(np.float32)) * 0.05
    X = rng.normal(size=(B, n + 1, n + 1)) + 1j * rng.normal(size=(B, n + 1, n + 1))
    Z = torch.from_numpy(((X + np.conj(np.swapaxes(X, -1, -2))) / 2).astype(np.complex64)) * 0.05
    probe = torch.from_numpy((rng.normal(size=(B, n + 1, n + 1))).astype(np.complex64))
    return phi, h, Z, probe


def _glayer_grads(layer, phi, h, Z, probe):
    args = [t.clone().requires_grad_() for t in (phi, h, Z)]
    layer.zero_grad()
    G = layer(*args)
    (G * probe).real.sum().backward()
    return G.detach(), [a.grad for a in args] + [p.grad for p in layer.parameters()
                                                 if p.grad is not None]


def test_glayer_with_the_kernels_algorithm_matches_the_complex128_route(monkeypatch):
    """The eigh GLayer with the kernel's arithmetic (the plain Jacobi in
    complex64, through ``eigh_detached``, as a CUDA tensor takes it) against
    the CPU's complex128 route: forward and gradients, within chip_smoke's
    EIGH_GLAYER_TOL (1e-4) and EIGH_GLAYER_GRAD_TOL (1e-3)."""
    import admmnet_tpu_torch.models.layers as layers

    torch.manual_seed(0)
    layer = GLayer(15, mode="eigh")
    case = _glayer_case()
    G_ref, g_ref = _glayer_grads(layer, *case)

    monkeypatch.setattr(ke, "_solve", lambda A: ke.eigh_jacobi_plain(A.contiguous()))
    monkeypatch.setattr(layers, "hermitian_eigh", ke.eigh_detached)
    G, g = _glayer_grads(layer, *case)
    rel = torch.linalg.norm(G - G_ref, dim=(-2, -1)) / torch.linalg.norm(G_ref, dim=(-2, -1))
    assert float(rel.max()) < 1e-4
    for a, b in zip(g, g_ref):
        assert float(torch.linalg.norm(a - b) / torch.linalg.norm(b)) < 1e-3


def test_eigh_span_and_launch_counter_in_snapshot():
    """Under a profiler the eigh GLayer opens ``models.eigh`` inside
    ``models.glayer``, once a forward; ``launches.eigh`` is in the
    snapshot (0 on the CPU, whose route is complex128 LAPACK)."""
    layer = GLayer(15, mode="eigh")
    phi, h, Z, _ = _glayer_case()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.no_grad():
            layer(phi, h, Z)
            layer(phi, h, Z)
    snap = profiling.snapshot()
    assert snap["models.eigh"]["count"] == 2
    assert snap["models.glayer"]["count"] == 2
    assert snap["models.eigh"]["host_s"] <= snap["models.glayer"]["host_s"]
    assert snap["launches.eigh"]["count"] == ke.launches.count
