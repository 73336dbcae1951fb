"""Port parity: the atom helpers (``vander_vec``, ``khatri_rao``,
``atom_matrix``) against the JAX package's, with the checks of
``tests/test_ops_atoms.py``, and the subpackages' re-exported names.

Tolerances: complex64 on both sides; the numpy oracles run in float64.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from admmnet_tpu.ops import atoms as jatoms
from admmnet_tpu_torch.ops import atoms

# Names a JAX subpackage re-exports that the port leaves out on purpose:
# the port names its kernels ``*_kernel``.
EXCLUDED = {("kernels", "psd_project_polar_pallas")}
SUBPACKAGES = ("bench", "core", "data", "kernels", "models", "ops", "parallel", "peaks",
               "solver", "train", "utils")
EXPORTS = [(sub, name) for sub in SUBPACKAGES
           for name in getattr(importlib.import_module(f"admmnet_tpu.{sub}"), "__all__", ())
           if (sub, name) not in EXCLUDED]


def np_vander(x, y, length):
    return np.exp(1j * 2 * np.pi * np.linspace(x, y, length))


@pytest.mark.parametrize("start, stop, length", [(0.0, 9 * 0.14, 10), (-0.3, 0.77, 7)])
def test_vander_vec_matches_numpy_and_jax(start, stop, length):
    got = atoms.vander_vec(start, stop, length)
    assert got.dtype == torch.complex64 and got.shape == (length,)
    np.testing.assert_allclose(got.numpy(), np_vander(start, stop, length), atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(jatoms.vander_vec(start, stop, length)),
                               atol=1e-6)


def test_khatri_rao_matches_columnwise_kron_and_jax():
    rng = np.random.default_rng(0)
    A = (rng.normal(size=(4, 3)) + 1j * rng.normal(size=(4, 3))).astype(np.complex64)
    B = (rng.normal(size=(5, 3)) + 1j * rng.normal(size=(5, 3))).astype(np.complex64)
    got = atoms.khatri_rao(torch.from_numpy(A), torch.from_numpy(B)).numpy()
    want = np.stack([np.kron(A[:, i], B[:, i]) for i in range(3)], axis=1)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jatoms.khatri_rao(jnp.asarray(A), jnp.asarray(B))),
                               atol=1e-6)


def test_khatri_rao_rejects_a_column_mismatch():
    for mod, wrap in ((atoms, torch.zeros), (jatoms, jnp.zeros)):
        with pytest.raises(ValueError, match="column mismatch 3 vs 2"):
            mod.khatri_rao(wrap((4, 3)), wrap((5, 2)))


def test_atom_matrix_matches_jax():
    taus, fs = np.linspace(0, 0.9, 7), np.linspace(-0.4, 0.4, 7)
    A = atoms.atom_matrix(torch.from_numpy(taus), torch.from_numpy(fs), 10, 10)
    assert A.shape == (7, 100) and A.dtype == torch.complex64
    np.testing.assert_allclose(np.abs(A.numpy()), 1.0, atol=1e-5)
    want = np.asarray(jatoms.atom_matrix(jnp.asarray(taus), jnp.asarray(fs), 10, 10))
    np.testing.assert_allclose(A.numpy(), want, atol=1e-5)
    # row i is the atom of (taus[i], fs[i]): kron(s(f), conj(d(tau)))
    s = np_vander(0, 9 * fs[3], 10)
    d = np_vander(0, 9 * taus[3], 10)
    np.testing.assert_allclose(A[3].numpy(), np.kron(s, np.conj(d)), atol=1e-5)


@pytest.mark.parametrize("sub, name", EXPORTS, ids=[f"{s}.{n}" for s, n in EXPORTS])
def test_port_reexports_the_jax_name(sub, name):
    port = importlib.import_module(f"admmnet_tpu_torch.{sub}")
    assert name in port.__all__ and getattr(port, name) is not None
