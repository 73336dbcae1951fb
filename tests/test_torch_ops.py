"""Port parity: atoms, lifted-matrix helpers and projections vs JAX.

Inputs are made with numpy from fixed seeds and fed to both packages.
Tolerances: elementwise float32 ops agree to a few ulps (2e-6); the
projections' reductions and complex products run in another order
(relative 1e-5); eigh-based results differ by the eigensolver (1e-5).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import admmnet_tpu.ops.atoms as jat
import admmnet_tpu.ops.linalg as jla
import admmnet_tpu.ops.projections as jpr
import admmnet_tpu_torch.ops.atoms as tat
import admmnet_tpu_torch.ops.linalg as tla
import admmnet_tpu_torch.ops.projections as tpr

torch.set_num_threads(1)  # JAX and torch share the cores of one test worker


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _hermitian(rng, B, m):
    X = rng.normal(size=(B, m, m)) + 1j * rng.normal(size=(B, m, m))
    return ((X + np.conj(np.swapaxes(X, -1, -2))) / 2).astype(np.complex64)


def test_atoms_match_jax():
    rng = np.random.default_rng(0)
    tau = rng.uniform(0, 1, (4, 3)).astype(np.float32)
    f = rng.uniform(-0.5, 0.5, (4, 3)).astype(np.float32)
    g = (rng.normal(size=(4, 3)) + 1j * rng.normal(size=(4, 3))).astype(np.complex64)
    pairs = [
        (jat.doppler_steering(f, 10), tat.doppler_steering(f, 10)),
        (jat.delay_steering(tau, 10), tat.delay_steering(tau, 10)),
        (jat.atom(tau, f, 10, 10), tat.atom(tau, f, 10, 10)),
        (jat.target_signal(tau, f, g, 10, 10), tat.target_signal(tau, f, g, 10, 10)),
    ]
    for j, t in pairs:
        assert t.dtype == tat.COMPLEX == torch.complex64
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=2e-6, rtol=2e-6)


def test_linalg_helpers_match_jax():
    rng = np.random.default_rng(1)
    h = rng.normal(size=(3, 7)).astype(np.float32)
    phi = (rng.normal(size=(3, 7)) + 1j * rng.normal(size=(3, 7))).astype(np.complex64)
    Mj = jla.assemble_lifted(jnp.asarray(h), jnp.asarray(phi), 0.25)
    Mt = tla.assemble_lifted(torch.from_numpy(h), torch.from_numpy(phi), 0.25)
    np.testing.assert_array_equal(Mt.numpy(), np.asarray(Mj))
    M = _hermitian(rng, 3, 8) + 0.1j
    for jf, tf in ((jla.lifted_topleft, tla.lifted_topleft),
                   (jla.lifted_corner_vec, tla.lifted_corner_vec),
                   (jla.hermitianize, tla.hermitianize),
                   (jla.fro_norm, tla.fro_norm)):
        np.testing.assert_allclose(tf(torch.from_numpy(M)).numpy(),
                                   np.asarray(jf(jnp.asarray(M))), rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(tla.vec_norm(torch.from_numpy(phi)).numpy(),
                               np.asarray(jla.vec_norm(jnp.asarray(phi))), rtol=2e-6)


def test_project_l1_ball_and_sum_inf_match_jax():
    rng = np.random.default_rng(2)
    v = rng.normal(size=(5, 100)).astype(np.float32) * 3
    r = np.abs(rng.normal(size=5)).astype(np.float32) * 10
    np.testing.assert_allclose(
        tpr.project_l1_ball(torch.from_numpy(v), torch.from_numpy(r)).numpy(),
        np.asarray(jpr.project_l1_ball(jnp.asarray(v), jnp.asarray(r))),
        rtol=1e-5, atol=1e-5)
    # binding and feasible rows: positive entries violate, small ones are feasible
    t = np.concatenate([np.abs(v[:3]), 1e-4 * v[3:]]).astype(np.float32)
    A = (2 * 10 * 1.5 + 1.5**2) * np.ones(5, np.float32)
    hj = np.asarray(jpr.project_sum_inf(jnp.asarray(t), jnp.asarray(A)))
    ht = tpr.project_sum_inf(torch.from_numpy(t), torch.from_numpy(A)).numpy()
    np.testing.assert_allclose(ht, hj, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ht[3:], t[3:])  # feasible rows pass through
    assert np.all(A * np.abs(ht).max(-1) + ht.sum(-1) <= 1 + 1e-4)


@pytest.mark.parametrize("which", ["eigh", "polar", "polar_bf16", "newton_schulz"])
def test_psd_projections_match_jax(which):
    M = _hermitian(np.random.default_rng(3), 3, 101)
    Mj, Mt = jnp.asarray(M), torch.from_numpy(M)
    if which == "eigh":
        j, t = jpr.psd_project_eigh(Mj), tpr.psd_project_eigh(Mt)
    elif which == "polar":
        j, t = jpr.psd_project_polar(Mj), tpr.psd_project_polar(Mt)
    elif which == "polar_bf16":
        j = jpr.psd_project_polar(Mj, schedule=jpr.POLAR_BF16_SCHEDULE)
        t = tpr.psd_project_polar(Mt, schedule=tpr.POLAR_BF16_SCHEDULE)
    else:
        j, t = jpr.psd_project_newton_schulz(Mj), tpr.psd_project_newton_schulz(Mt)
    assert _rel(t.numpy(), j) < 1e-5
