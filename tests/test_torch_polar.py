"""Polar PSD kernel (kernels/polar.py): plain version vs the JAX Pallas
kernel in interpret mode, and the wrapper's input checks.  The CUDA kernel
itself is checked on the card by tests/test_torch_cuda.py and chip_smoke.py.

Tolerance: both sides compute every product in float32 (interpret mode
evaluates the kernel's DEFAULT products at f32), with sums in another
order; the accurate schedule's first-step coefficients (a = 8.5, c = 18.6)
amplify that to ~4e-6 relative, so the bound is 2e-5.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from admmnet_tpu.kernels.polar import psd_project_polar_pallas
from admmnet_tpu_torch.kernels import polar as kp

torch.set_num_threads(1)  # JAX and torch share the cores of one test worker


def _hermitian(rng, shape, m):
    X = rng.normal(size=(*shape, m, m)) + 1j * rng.normal(size=(*shape, m, m))
    return ((X + np.conj(np.swapaxes(X, -1, -2))) / 2).astype(np.complex64)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    a, b = a.reshape(-1, a.shape[-2] * a.shape[-1]), b.reshape(-1, b.shape[-2] * b.shape[-1])
    return float((np.linalg.norm(a - b, axis=-1) / np.linalg.norm(b, axis=-1)).max())


@pytest.mark.parametrize("mode, hi_steps", [("accurate", None), ("fast", None), ("fast", 1)])
def test_plain_matches_pallas_interpret(mode, hi_steps):
    M = _hermitian(np.random.default_rng(11), (3,), 101)
    Pj = psd_project_polar_pallas(jnp.asarray(M), interpret=True, mode=mode, hi_steps=hi_steps)
    before = kp.launches.count
    Pt = kp.psd_project_polar_kernel(torch.from_numpy(M), mode=mode, hi_steps=hi_steps)
    assert kp.launches.count == before  # a CPU tensor never launches
    assert Pt.dtype == torch.complex64 and Pt.shape == M.shape
    assert _rel(Pt.numpy(), Pj) < 2e-5


def test_odd_batch_and_leading_dims():
    """Batch not a multiple of the JAX kernel's kblk, and two leading dims."""
    M = _hermitian(np.random.default_rng(7), (5,), 33)
    Pj = psd_project_polar_pallas(jnp.asarray(M), interpret=True, kblk=2)
    Pt = kp.psd_project_polar_kernel(torch.from_numpy(M.reshape(5, 1, 33, 33)))
    assert Pt.shape == (5, 1, 33, 33)
    assert _rel(Pt.numpy().reshape(5, 33, 33), Pj) < 2e-5


def test_zero_matrix_projects_to_exact_zero():
    M = torch.zeros((2, 101, 101), dtype=torch.complex64)
    for mode in ("accurate", "fast"):
        assert torch.all(kp.psd_project_polar_kernel(M, mode=mode) == 0)


def test_wrapper_input_checks():
    M = torch.zeros((2, 101, 101), dtype=torch.complex64)
    with pytest.raises(TypeError):
        kp.psd_project_polar_kernel(M.to(torch.complex128))
    with pytest.raises(ValueError):
        kp.psd_project_polar_kernel(torch.zeros((2, 101, 100), dtype=torch.complex64))
    with pytest.raises(ValueError, match="exceeds"):
        kp.psd_project_polar_kernel(torch.zeros((1, 129, 129), dtype=torch.complex64))
    with pytest.raises(ValueError, match="unsupported device"):
        kp.psd_project_polar_kernel(torch.zeros((1, 8, 8), dtype=torch.complex64,
                                                device="meta"))
    with pytest.raises(ValueError, match="unknown mode"):
        kp.psd_project_polar_kernel(M, mode="exact")
    assert [kp.padded_side(m) for m in (1, 101, 112, 113, 128)] == [112, 112, 112, 128, 128]


@pytest.mark.parametrize("m", [120, 1])
def test_plain_matches_pallas_interpret_at_the_edge_sides(m):
    """The plain version at the sides where the card's kernel changes shape:
    m = 120 (plane side 128, a cluster of two CTAs on the card) and m = 1
    (one entry, the rest padding).  The error is taken against ||M||, as a
    1 x 1 projection of a negative entry is exactly 0."""
    M = _hermitian(np.random.default_rng(12), (2,), m)
    Pj = np.asarray(psd_project_polar_pallas(jnp.asarray(M), interpret=True, mode="accurate"))
    Pt = kp.psd_project_polar_kernel(torch.from_numpy(M)).numpy()
    assert Pt.shape == M.shape
    err = np.linalg.norm((Pt - Pj).reshape(2, -1), axis=-1) / np.linalg.norm(M.reshape(2, -1),
                                                                              axis=-1)
    assert float(err.max()) < 2e-5
