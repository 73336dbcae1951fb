"""Port parity: Chebyshev matrix filters and the Clenshaw kernel's plain version.

Same numpy inputs through ``admmnet_tpu.ops.chebyshev`` /
``admmnet_tpu.kernels.cheb_filter`` (Pallas in interpret mode) and their
port counterparts.  Tolerances: every product is fp32 on both sides with
the sums in another order, through 16 dependent Clenshaw steps; measured
below 1e-6 relative, held at 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admmnet_tpu.kernels.cheb_filter import apply_spectral_filter_pallas, cheb_filter_matrices
from admmnet_tpu.ops import chebyshev as jcheb
from admmnet_tpu_torch.kernels import cheb_filter as kc
from admmnet_tpu_torch.ops import chebyshev as tcheb

torch.set_num_threads(1)  # JAX and torch share the cores of one test worker

TOL = 1e-5


def _hermitian(b, m, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(b, m, m)) + 1j * rng.normal(size=(b, m, m))
    return ((X + np.conj(np.swapaxes(X, -1, -2))) / 2).astype(np.complex64)


def _rel(a, b):
    a, b = np.asarray(a).reshape(len(a), -1), np.asarray(b).reshape(len(b), -1)
    return float(np.max(np.linalg.norm(a - b, axis=-1) / np.linalg.norm(b, axis=-1)))


def _filters(thr=0.3):
    return (lambda w: jax.nn.softplus(w - thr),
            lambda w: torch.nn.functional.softplus(w - thr))


@pytest.mark.parametrize("n", [1, 16, 48])
def test_nodes_and_coefficient_matrix_equal(n):
    assert np.array_equal(tcheb.chebyshev_nodes(n), jcheb.chebyshev_nodes(n))
    C = tcheb.coefficient_matrix(n)
    assert C.dtype == np.float32 and np.array_equal(C, jcheb.coefficient_matrix(n))


@pytest.mark.parametrize("precision, jax_precision", [
    ("highest", None), ("default", jax.lax.Precision.DEFAULT)])
def test_apply_spectral_filter_matches_jax(precision, jax_precision):
    M = _hermitian(3, 20, 0)
    fj, ft = _filters()
    ref = jcheb.apply_spectral_filter(jnp.asarray(M), fj, 16, precision=jax_precision)
    out = tcheb.apply_spectral_filter(torch.from_numpy(M), ft, 16, precision)
    assert out.dtype == torch.complex64
    assert _rel(out.numpy(), ref) < TOL


def test_plain_clenshaw_matches_pallas_kernel():
    """B = 3 is not a multiple of kblk = 2: the TPU kernel pads the batch."""
    M = _hermitian(3, 20, 2)
    c = (np.random.default_rng(3).normal(size=(3, 16)) * 0.1).astype(np.float32)
    ref = cheb_filter_matrices(jnp.asarray(M), jnp.asarray(c), 16, kblk=2, interpret=True)
    before = kc.launches.count
    out = kc.cheb_filter_matrices(torch.from_numpy(M), torch.from_numpy(c), 16)
    assert kc.launches.count == before  # a CPU tensor runs the plain version
    assert _rel(out.numpy(), ref) < TOL


@pytest.mark.parametrize("m, degree", [(20, 1), (20, 2), (120, 16)])
def test_plain_forward_edges_match_pallas_kernel(m, degree):
    """The plain forward and its carries at the recurrence's bounds (degree
    1: no step; 2: the first step only) and at a side the card runs on its
    P = 128 instantiation (m = 120), vs ``cheb_filter_matrices`` and
    ``_cheb_fwd_with_residuals`` in interpret mode (cropped to m: the TPU
    kernel adds c_j on the padded diagonal too).  A carry that is zero in
    JAX's (degree 1's, degree 2's b_2) must be exactly zero."""
    from admmnet_tpu.kernels.cheb_filter import _cheb_fwd_with_residuals

    M = _hermitian(2, m, 20 + degree)
    c = (np.random.default_rng(21 + degree).normal(size=(2, degree)) * 0.3).astype(np.float32)
    ref = cheb_filter_matrices(jnp.asarray(M), jnp.asarray(c), degree, kblk=2, interpret=True)
    _, res_j = _cheb_fwd_with_residuals(jnp.asarray(M), jnp.asarray(c), degree, kblk=2,
                                        interpret=True)
    out, res_t = kc.cheb_filter_matrices_plain_with_residuals(
        torch.from_numpy(M), torch.from_numpy(c), degree)
    assert _rel(out.numpy(), ref) < TOL
    for rj, rt in zip(res_j, res_t):
        rj = np.asarray(rj)[:, :m, :m]
        if not np.any(rj):
            assert not torch.any(rt)
        else:
            assert _rel(rt.numpy(), rj) < TOL


def test_kernel_route_matches_pallas_route():
    M = _hermitian(3, 20, 4)
    fj, ft = _filters(0.1)
    ref = apply_spectral_filter_pallas(jnp.asarray(M), fj, 16, kblk=2, interpret=True)
    out = kc.apply_spectral_filter_kernel(torch.from_numpy(M), ft, 16)
    assert _rel(out.numpy(), ref) < TOL


def test_kernel_route_is_a_matrix_function():
    """Against the eigendecomposition oracle at degree 48: the float32
    truncation floor of the method is ~1.2e-3 (tests/test_cheb_filter.py)."""
    M = _hermitian(4, 16, 1)
    out = kc.apply_spectral_filter_kernel(
        torch.from_numpy(M), lambda w: torch.tanh(w) * 0.5 + 0.5 * w, 48).numpy()
    w, V = np.linalg.eigh(M)
    oracle = np.einsum("...ij,...j,...kj->...ik", V, np.tanh(w) * 0.5 + 0.5 * w, np.conj(V))
    assert _rel(out, oracle) < 5e-3


def test_zero_matrix():
    """A zero M normalizes to A = 0: the plain Clenshaw output is exactly
    diagonal, with the scalar recurrence at x = 0 on the diagonal, and the
    filtered matrix is f(0) I, as the JAX evaluation gives."""
    c = (np.random.default_rng(5).normal(size=(2, 16)) * 0.3).astype(np.float32)
    G = kc.cheb_filter_matrices_plain(torch.zeros(2, 20, 20, dtype=torch.complex64),
                                      torch.from_numpy(c), 16).numpy()
    for i in range(2):
        b1 = b2 = np.float32(0)
        for j in range(15, 0, -1):
            b1, b2 = (c[i, j] + np.float32(0)) - b2, b1
        diag = np.full(20, (c[i, 0] + np.float32(0)) - b2, np.float32)
        assert np.array_equal(G[i], np.diag(diag).astype(np.complex64))
    fj, ft = _filters()
    out = kc.apply_spectral_filter_kernel(torch.zeros(2, 20, 20, dtype=torch.complex64), ft, 16)
    ref = jcheb.apply_spectral_filter(jnp.zeros((2, 20, 20), jnp.complex64), fj, 16,
                                      precision=jax.lax.Precision.DEFAULT)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)
    assert abs(out[0, 0, 0].item() - float(jax.nn.softplus(-0.3))) < 1e-3


def test_wrapper_checks_and_devices():
    M = torch.from_numpy(_hermitian(2, 8, 6))
    c = torch.zeros(2, 5)
    with pytest.raises(ValueError, match="coeffs"):
        kc.cheb_filter_matrices(M, torch.zeros(2, 4), 5)
    with pytest.raises(TypeError):
        kc.cheb_filter_matrices(M.to(torch.complex128), c, 5)
    with pytest.raises(ValueError, match="unsupported device"):
        kc.cheb_filter_matrices(M.to("meta"), c.to("meta"), 5)
    with pytest.raises(ValueError, match="CUDA"):
        kc.cheb_filter_planes(M, c, 5)


def test_plain_version_is_differentiable():
    """On the CPU the Clenshaw recurrence trains through torch autograd."""
    M = torch.from_numpy(_hermitian(2, 8, 7)).requires_grad_(True)
    c = torch.full((2, 6), 0.2, requires_grad=True)
    kc.cheb_filter_matrices(M, c, 6).real.sum().backward()
    assert torch.isfinite(torch.view_as_real(M.grad)).all() and torch.isfinite(c.grad).all()


# ---- training: K5's and K6's plain versions and the autograd wiring ----------


def _herm_t(X):
    return 0.5 * (X + torch.conj(X.transpose(-1, -2)))


@pytest.mark.parametrize("three_pass", [False, True])
def test_plain_fwd_residuals_and_bwd_match_pallas(three_pass):
    """The training forward's carries and the reversible backward vs the JAX
    package's ``_cheb_fwd_with_residuals`` / ``_cheb_bwd`` (interpret mode):
    the port is fed the conjugate cotangent (torch's convention) and its
    Mbar is the conjugate of JAX's; cbar is real and equal as is.  The JAX
    backward also adds the product with the rebuilt b_degree (~0), which the
    port leaves out; with three_pass both take split-bf16 products whose
    operands can round to bf16 differently."""
    from admmnet_tpu.kernels.cheb_filter import _cheb_bwd, _cheb_fwd_with_residuals

    B, m, D = 3, 12, 10
    M = _hermitian(B, m, 11)
    rng = np.random.default_rng(12)
    c = (rng.normal(size=(B, D)) * 0.3).astype(np.float32)
    g = (rng.normal(size=(B, m, m)) + 1j * rng.normal(size=(B, m, m))).astype(np.complex64)
    out_j, res_j = _cheb_fwd_with_residuals(jnp.asarray(M), jnp.asarray(c), D, kblk=3,
                                            interpret=True)
    out_t, res_t = kc.cheb_filter_matrices_plain_with_residuals(
        torch.from_numpy(M), torch.from_numpy(c), D)
    assert _rel(out_t.numpy(), out_j) < TOL
    for rj, rt in zip(res_j, res_t):
        assert _rel(rt.numpy(), np.asarray(rj)[:B, :m, :m]) < TOL
    Mbar_j, cbar_j = _cheb_bwd(jnp.asarray(M), jnp.asarray(c), res_j, jnp.asarray(g), D,
                               kblk=3, interpret=True, three_pass=three_pass)
    Abar, cbar = kc.cheb_bwd_plain(torch.from_numpy(M), torch.from_numpy(c), res_t,
                                   torch.from_numpy(np.conj(g)), D, three_pass)
    Mbar = kc.normalization_backward(torch.from_numpy(M), Abar)
    tol = 3e-4 if three_pass else TOL
    assert _rel(Mbar.numpy(), np.conj(np.asarray(Mbar_j))) < tol
    assert _rel(cbar.numpy(), cbar_j) < tol


def test_cheb_filter_fn_matches_autograd_of_plain_forward():
    """Gradients through ``cheb_filter_matrices`` (the reversible backward)
    vs torch autograd through the plain forward: equal on the Hermitian
    part of Mbar (the kernel symmetrizes the cotangent, plain autograd runs
    the adjoint of every re-projection) and on cbar; measured ~2e-7."""
    B, m, D = 3, 12, 10
    M = torch.from_numpy(_hermitian(B, m, 13))
    rng = np.random.default_rng(14)
    c = torch.from_numpy((rng.normal(size=(B, D)) * 0.3).astype(np.float32))
    W = torch.from_numpy((rng.normal(size=(B, m, m))
                          + 1j * rng.normal(size=(B, m, m))).astype(np.complex64))
    grads = []
    for fn in (kc.cheb_filter_matrices, kc.cheb_filter_matrices_plain):
        Mg, cg = M.clone().requires_grad_(True), c.clone().requires_grad_(True)
        (fn(Mg, cg, D) * W.conj()).real.sum().backward()
        grads.append((_herm_t(Mg.grad).numpy(), cg.grad.numpy()))
    assert _rel(grads[0][0], grads[1][0]) < TOL
    assert _rel(grads[0][1], grads[1][1]) < TOL


def test_cheb_filter_fn_gradcheck_float64():
    """``ChebFilterFn`` in fp64 on the plain path against finite differences,
    on Hermitian inputs (X -> herm(X), where the recurrence is the
    polynomial and the reversible backward is its exact adjoint)."""
    rng = np.random.default_rng(15)
    X = torch.from_numpy(rng.normal(size=(2, 6, 6)) + 1j * rng.normal(size=(2, 6, 6)))
    c = torch.from_numpy(rng.normal(size=(2, 6)) * 0.3)
    assert torch.autograd.gradcheck(
        lambda X, c: kc.ChebFilterFn.apply(_herm_t(X), c, 6),
        (X.requires_grad_(True), c.requires_grad_(True)))


def test_glayer_parameter_gradients_match_jax():
    """The chebyshev GLayer with the Clenshaw engine (cheb_impl="pallas"):
    jax.grad of the JAX layer (off the TPU: fp32 with per-step re-projection
    through XLA autodiff) vs the port's backward through ``ChebFilterFn``.
    Real parameters: no conjugation.  The lambda parameter only reaches the
    output through a stop-gradient: zero in both."""
    import flax.linen  # noqa: F401  (the JAX layer is a flax module)

    from admmnet_tpu.models.layers import GLayer as JGLayer
    from admmnet_tpu_torch.core.convert import flax_to_state_dict
    from admmnet_tpu_torch.models.layers import GLayer as TGLayer

    n, B, D = 15, 4, 12
    rng = np.random.default_rng(16)
    phi = (rng.normal(size=(B, n)) + 1j * rng.normal(size=(B, n))).astype(np.complex64)
    h = (rng.uniform(0.01, 0.1, size=(B, n))).astype(np.float32)
    Z = _hermitian(B, n + 1, 17) * np.float32(0.1)
    W = (rng.normal(size=(B, n + 1, n + 1))
         + 1j * rng.normal(size=(B, n + 1, n + 1))).astype(np.complex64)
    jl = JGLayer(dim=n, mode="chebyshev", cheb_degree=D, cheb_impl="pallas")
    params = jl.init(jax.random.PRNGKey(0), phi, h, Z)

    def loss(p):
        return jnp.sum(jnp.real(jl.apply(p, phi, h, Z) * jnp.conj(W)))

    gj = flax_to_state_dict(jax.jit(jax.grad(loss))(params)["params"])
    tl = TGLayer(n, mode="chebyshev", cheb_degree=D, cheb_impl="pallas")
    tl.load_state_dict(flax_to_state_dict(params["params"]))
    out = tl(torch.from_numpy(phi), torch.from_numpy(h), torch.from_numpy(Z))
    (out * torch.from_numpy(W).conj()).real.sum().backward()
    for name, p in tl.named_parameters():
        g = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        ref = np.asarray(gj[name])
        scale = max(float(np.max(np.abs(ref))), 1e-30)
        assert float(np.max(np.abs(g - ref))) <= 1e-4 * scale + 1e-7, name
