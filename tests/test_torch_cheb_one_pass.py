"""The Clenshaw kernels' precision tiers (K4/K5 forward, K6 backward) on the CPU.

On the TPU the Clenshaw forward's products are ``Precision.DEFAULT``,
one-pass bf16 on the MXU, the closing one HIGHEST with ``final_hi``; the
backward's are the 3-pass split-bf16 ``_mm3`` (``bwd_three_pass=True``,
the default), whose three products are DEFAULT too, so the MXU rounds the
residuals to bf16 as well.  The card's kernels compute the same: one-pass
bf16 products in K4/K5, split-bf16 ones with rounded residuals in K6.  On
the CPU both packages compute DEFAULT in fp32, so here the JAX kernels run
in interpret mode with ``_mm`` of ``admmnet_tpu.kernels.cheb_filter`` and
``admmnet_tpu.kernels.fused_admm_fast`` patched to the card's rounding
(the ``card_default`` fixture; the JAX package's files are not edited), and
the port's plain versions run with ``one_pass=True``, the emulation the
card's kernels are held to.

Tolerances, with their reasons (inputs: m <= 32, degree <= 12, B = 8, half
the matrices with a dominant eigenvalue, as the GLayer's lifted matrices
have):
- The first real product (degree 3: the first step multiplies by c I, the
  closing product by a real b_1): every term is an exact product of bf16
  values and only the order of the fp32 sums differs, so the median matrix
  within 1e-5 (measured 0 without final_hi, 8.7e-8 with it), where the
  fp32 tier sits 5.7e-4 away.
- The whole recurrence: a sum in another order flips a bf16 rounding of an
  intermediate operand now and then (one entry moves 2^-9 relative) and
  the later steps carry it, so the median matrix within 1e-5 (measured 0 /
  2.1e-7) and every matrix within 5e-3 (measured: output 3.1e-4, carries
  2.4e-3; the emulation's own float32-vs-float64 spread 1.2e-4), where the
  fp32 tier's median sits 1.0e-3-1.5e-3 away.
- K6 against JAX's ``_cheb_bwd`` on the same carries: the port multiplies
  in torch's complex convention (the conjugate of JAX's), so Karatsuba's
  operand sums differ and their residuals round differently, ~2^-17 per
  product: Mbar and cbar within 2e-4 per matrix (measured 3.4e-5 / 5.4e-5).
  The residuals' rounding itself is held per product (within 1e-6 of
  JAX's ``_mm3`` on the same operands; the fp32 residuals sit ~5e-6 away).
- The GLayer engine's gradients against JAX's (fp32 products on both
  sides): the split tier within 3e-4 (the same convention effect),
  HIGHEST within 1e-5, as tests/test_torch_cheb.py holds it.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admmnet_tpu.kernels.cheb_filter as jc
import admmnet_tpu.kernels.fused_admm_fast as jf
from admmnet_tpu_torch.kernels import cheb_filter as kc
from admmnet_tpu_torch.kernels import polar as kp
from admmnet_tpu_torch.ops.chebyshev import filter_coefficients, spectral_bound
from test_torch_one_pass import fake_card  # noqa: F401 (a fixture)

torch.set_num_threads(1)  # JAX and torch share the cores of one test worker


def _inputs(B, m, D, seed):
    """Hermitian complex64 M (the second half with a dominant eigenvalue),
    coefficients (B, D) and a cotangent."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(B, m, m)) + 1j * rng.normal(size=(B, m, m))
    M = (X + np.conj(np.swapaxes(X, -1, -2))) / 2
    v = rng.normal(size=(B // 2, m)) + 1j * rng.normal(size=(B // 2, m))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    M[B // 2:] += 30.0 * m * v[:, :, None] * np.conj(v)[:, None, :]
    c = (rng.normal(size=(B, D)) * 0.3).astype(np.float32)
    g = (rng.normal(size=(B, m, m)) + 1j * rng.normal(size=(B, m, m))).astype(np.complex64)
    return M.astype(np.complex64), c, g


def _rel(a, b):
    """Per-matrix relative error of a against b."""
    a, b = np.asarray(a), np.asarray(b)
    a, b = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
    return np.linalg.norm(a - b, axis=-1) / np.linalg.norm(b, axis=-1)


def _bf16(x):
    return x.astype(jnp.bfloat16).astype(jnp.float32)


@pytest.fixture
def card_default(monkeypatch):
    """The JAX kernels' DEFAULT products as the card computes them: each
    operand rounded to nearest-even bf16, the exact products summed in
    fp32.  JAX's caches are cleared on both sides, so no trace of the
    patched kernels outlives the test."""
    cheb_mm, fast_mm = jc._mm, jf._mm

    def one_pass_cheb(a, b, hi=False):
        return cheb_mm(a, b, True) if hi else cheb_mm(_bf16(a), _bf16(b))

    def one_pass_fast(a, b, hi=False):
        return fast_mm(a, b, True) if hi else fast_mm(_bf16(a), _bf16(b))

    jax.clear_caches()
    monkeypatch.setattr(jc, "_mm", one_pass_cheb)
    monkeypatch.setattr(jf, "_mm", one_pass_fast)
    yield monkeypatch
    monkeypatch.undo()
    jax.clear_caches()


def _jax_forward(M, c, D, final_hi):
    """JAX's training forward (the inference forward's kernel body, which
    also writes the carries): the output and the carries, cropped."""
    out, res = jc._cheb_fwd_with_residuals(jnp.asarray(M), jnp.asarray(c), D, kblk=4,
                                           interpret=True, final_hi=final_hi)
    return np.asarray(out), [np.asarray(r)[:M.shape[0], :M.shape[1], :M.shape[1]] for r in res]


@pytest.mark.parametrize("final_hi", [False, True])
def test_first_real_product_matches_the_card(card_default, final_hi):
    M, c, _ = _inputs(8, 32, 3, 1)
    ref, _ = _jax_forward(M, c, 3, final_hi)
    Mt, ct = torch.from_numpy(M), torch.from_numpy(c)
    out = kc.cheb_filter_matrices_plain(Mt, ct, 3, one_pass=True, final_hi=final_hi)
    assert np.median(_rel(out.numpy(), ref)) < 1e-5
    assert _rel(out.numpy(), ref).max() < 1e-3
    # the tier shows: the fp32 products sit far from the card's
    fp32 = kc.cheb_filter_matrices_plain(Mt, ct, 3)
    assert np.median(_rel(fp32.numpy(), ref)) > 1e-4


@pytest.mark.parametrize("m, final_hi", [(24, False), (32, False), (32, True)])
def test_recurrence_and_carries_match_the_card(card_default, m, final_hi):
    D = 12
    M, c, _ = _inputs(8, m, D, 1)
    ref, res_j = _jax_forward(M, c, D, final_hi)
    Mt, ct = torch.from_numpy(M), torch.from_numpy(c)
    out, res_t = kc.cheb_filter_matrices_plain_with_residuals(Mt, ct, D, one_pass=True,
                                                              final_hi=final_hi)
    e = _rel(out.numpy(), ref)
    assert np.median(e) < 1e-5 and e.max() < 5e-3
    for rt, rj in zip(res_t, res_j):
        er = _rel(rt.numpy(), rj)
        assert np.median(er) < 1e-5 and er.max() < 5e-3
    fp32 = kc.cheb_filter_matrices_plain(Mt, ct, D)
    assert np.median(_rel(fp32.numpy(), ref)) > 1e-4


def test_split_product_rounds_the_residuals_as_the_mxu(card_default):
    """``mm(split=True, one_pass_round=bf16_rn)`` is ``_mm3`` with DEFAULT
    inner products on the MXU; with fp32 residuals it is ``_mm3`` on a CPU."""
    rng = np.random.default_rng(5)
    a = rng.normal(size=(3, 32, 32)).astype(np.float32)
    b = rng.normal(size=(3, 32, 32)).astype(np.float32)
    ref = np.asarray(jax.vmap(jf._mm3)(jnp.asarray(a), jnp.asarray(b)))
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    scale = np.abs(ref).max()
    rounded = kp.mm(at, bt, True, kp.bf16_rn).numpy()
    assert np.abs(rounded - ref).max() / scale < 1e-6
    assert np.abs(kp.mm(at, bt, True).numpy() - ref).max() / scale > 1e-6


def test_k6_split_emulation_matches_the_card(card_default):
    """K6's emulation (``three_pass=True, one_pass=True``) against the JAX
    backward with its ``_mm3`` on the card's rounding, on the carries of
    the one-pass forward (whose rebuilt b_degree is not zero: both add its
    term)."""
    B, m, D = 6, 16, 10
    M, c, g = _inputs(B, m, D, 2)
    _, res = jc._cheb_fwd_with_residuals(jnp.asarray(M), jnp.asarray(c), D, kblk=3,
                                         interpret=True)
    Mbj, cbj = jc._cheb_bwd(jnp.asarray(M), jnp.asarray(c), res, jnp.asarray(g), D, kblk=3,
                            interpret=True, three_pass=True)
    carries = [torch.from_numpy(np.asarray(r)[:B, :m, :m].copy()) for r in res]
    Mt = torch.from_numpy(M)
    Abar, cbar = kc.cheb_bwd_plain(Mt, torch.from_numpy(c), carries,
                                   torch.from_numpy(np.conj(g)), D, three_pass=True,
                                   one_pass=True)
    Mbar = kc.normalization_backward(Mt, Abar)
    assert _rel(Mbar.numpy(), np.conj(np.asarray(Mbj))).max() < 2e-4
    assert _rel(cbar.numpy(), np.asarray(cbj)).max() < 2e-4
    with pytest.raises(ValueError, match="needs three_pass"):
        kc.cheb_bwd_plain(Mt, torch.from_numpy(c), carries, torch.from_numpy(g), D,
                          one_pass=True)


def _jax_engine(M, thr, D, three_pass):
    """apply_spectral_filter_pallas's math with the backward's tier chosen."""
    from admmnet_tpu.ops.chebyshev import chebyshev_nodes, coefficient_matrix

    r = jnp.maximum(jnp.sqrt(jnp.sum(jnp.abs(M) ** 2, axis=(-1, -2), keepdims=True)), 1e-20)
    rr = jnp.real(r)[..., 0, 0][..., None]
    g = jax.nn.softplus(rr * jnp.asarray(chebyshev_nodes(D)) - thr) / rr
    c = jnp.einsum("kj,...j->...k", jnp.asarray(coefficient_matrix(D)), g)
    out = jc.cheb_filter_matrices_ad(M, c, D, kblk=2, interpret=True, bwd_three_pass=three_pass)
    return out * r.astype(M.dtype)


@pytest.mark.parametrize("three_pass, tol", [(True, 3e-4), (False, 1e-5)])
def test_glayer_engine_gradients_match_jax_at_each_tier(three_pass, tol):
    """The GLayer's Clenshaw engine (``apply_spectral_filter_kernel``'s
    math) with ``bwd_three_pass`` set, against JAX's custom VJP at the same
    tier: the gradients wrt the (Hermitian) input and the filter's
    threshold."""
    B, m, D = 4, 12, 10
    M, _, W = _inputs(B, m, D, 3)
    thr0 = 0.2

    def jloss(X, thr):
        H = 0.5 * (X + jnp.conj(jnp.swapaxes(X, -1, -2)))
        return jnp.sum(jnp.real(_jax_engine(H, thr, D, three_pass) * jnp.conj(W)))

    gM_j, gthr_j = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(M), jnp.float32(thr0))
    X = torch.from_numpy(M).requires_grad_(True)
    thr = torch.tensor(thr0, requires_grad=True)
    H = 0.5 * (X + torch.conj(X.transpose(-1, -2)))
    # apply_spectral_filter_kernel with the backward's tier chosen
    r = spectral_bound(H)
    c = filter_coefficients(r, lambda w: torch.nn.functional.softplus(w - thr), D)
    out = kc.cheb_filter_matrices(H, c, D, bwd_three_pass=three_pass) * r.to(H.dtype)
    (out * torch.from_numpy(W).conj()).real.sum().backward()
    # torch's gradient of a real loss wrt a complex input is the conjugate of JAX's
    assert _rel(X.grad.numpy(), np.conj(np.asarray(gM_j))).max() < tol
    assert abs(float(thr.grad) - float(gthr_j)) <= tol * abs(float(gthr_j))


@pytest.mark.parametrize("final_hi", [False, True])
def test_the_forward_launchers_pass_final_hi(fake_card, final_hi):
    M = torch.empty((4, 101, 101), dtype=torch.complex64, device="meta")
    c = torch.empty((4, 48), dtype=torch.float32, device="meta")
    kc.cheb_filter_planes(M, c, 48, final_hi)
    kc.cheb_filter_planes(M, c, 48, final_hi, carries=True)
    for name, a in fake_card.calls:
        assert name == "cheb_filter_launch"
        assert a["final_hi"] == int(final_hi) and (a["P"], a["m"], a["degree"]) == (112, 101, 48)
    assert [a["b1r"] is None for _, a in fake_card.calls] == [True, False]


@pytest.mark.parametrize("kw, three_pass", [({}, 1), ({"three_pass": False}, 0)])
def test_the_backward_launcher_defaults_to_the_split_tier(fake_card, kw, three_pass):
    M = torch.empty((4, 120, 120), dtype=torch.complex64, device="meta")
    c = torch.empty((4, 48), dtype=torch.float32, device="meta")
    carries = [torch.empty((4, 128, 128), dtype=torch.float32, device="meta")] * 4
    kc.cheb_bwd_planes(M, c, carries, M, 48, **kw)
    (name, a), = fake_card.calls
    assert name == "cheb_bwd_launch"
    assert a["three_pass"] == three_pass and a["P"] == 128


def test_the_device_tier_of_the_backward():
    """``bwd_three_pass=None``: the split tier on the card, fp32 on the CPU
    (the JAX GLayer's XLA fallback off the TPU); explicit values stand."""
    cpu = torch.empty(1, dtype=torch.complex64)
    card = types.SimpleNamespace(device=torch.device("cuda", 0))
    assert kc._bwd_tier(cpu, None) is False and kc._bwd_tier(card, None) is True
    assert kc._bwd_tier(cpu, True) is True and kc._bwd_tier(card, False) is False
