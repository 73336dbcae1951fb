"""Port parity: the classical solver (solver/admm.py) vs the JAX package.

The fixed-iteration modes eigh / polar / polar_fast / newton_schulz are
compared with the JAX scan path on the same anchor instances.  Tolerances
(max per-instance relative error of phi after 20 iterations): float32
sums in another order, amplified along the trajectory; polar's K1 step uses
3-product Karatsuba where XLA multiplies complex matrices, and the
quintic's large first-step coefficients amplify that difference most
(measured 8.5e-5; the JAX package's own kernel-vs-scan band is 5e-4).
"""

from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from admmnet_tpu.core.config import ADMMOptions as JOptions
from admmnet_tpu.data.anchor import load_anchor, make_anchor_batch
from admmnet_tpu.solver import admm_solve as jax_solve
from admmnet_tpu.solver import admm_solve_fixed as jax_fixed
from admmnet_tpu_torch.core.config import ADMMOptions
from admmnet_tpu_torch.core.convert import options_from_jax
from admmnet_tpu_torch.peaks import phi_nmse
from admmnet_tpu_torch.solver import ADMMResult, admm_solve, admm_solve_fixed
from admmnet_tpu_torch.solver.reference_oracle import reference_admm

torch.set_num_threads(1)  # JAX and torch share the cores of one test worker

GOLDEN = Path(__file__).parent / "golden" / "anchor_refcompat_phi.npy"


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float((np.linalg.norm(a - b, axis=-1) / np.linalg.norm(b, axis=-1)).max())


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("g_update, iters, tol", [
    # few eigh iterations: JAX's CPU eigh crawls when test workers share cores
    ("eigh", 8, 2e-5), ("polar", 20, 5e-4), ("polar_fast", 20, 1e-4),
    ("newton_schulz", 20, 2e-5),
])
def test_fixed_modes_match_jax_scan_path(g_update, iters, tol):
    y, b, s = make_anchor_batch(2, mode="redemod", seed=5)
    o = JOptions(g_update=g_update)
    pj = jax_fixed(jnp.asarray(y), jnp.asarray(b), jnp.asarray(s), iters, 1.0, o)
    pt = admm_solve_fixed(*_t(y, b, s), iters, 1.0, options_from_jax(o))
    assert pt.dtype == torch.complex64 and pt.shape == y.shape
    assert _rel(pt.numpy(), pj) < tol


def test_ref_compat_matches_golden_snapshot():
    """The reference-compat pin (dense phi-update, identity G-step): same
    golden and bounds as tests/test_golden.py."""
    sc = load_anchor(mode="fixed_e", rng=np.random.default_rng(0))
    res = admm_solve(
        torch.from_numpy(sc.y.astype(np.complex64)),
        torch.from_numpy(sc.b.astype(np.complex64)),
        torch.tensor(np.float32(sc.sigma)), 1.0,
        ADMMOptions(phi_update="ref_dense", g_update="ref_identity", max_iter=100),
    )
    assert isinstance(res, ADMMResult)
    assert phi_nmse(res.phi.numpy(), np.load(GOLDEN)) < 1e-8
    assert int(res.iterations) == 5 and bool(res.converged)
    # and against the float64 numpy oracle of the reference's semantics
    phi_oracle, _ = reference_admm(sc.y, sc.b, 1.0, sc.sigma, max_iter=100, phi_mode="dense")
    assert phi_nmse(res.phi.numpy(), phi_oracle) < 1e-8


def test_masked_convergence_loop_matches_jax():
    """Per-instance iterations, convergence flags and phi of the masked loop."""
    # at eta 3e-2 these instances stop at 26-28 iterations (measured in JAX);
    # the masking does not depend on the G-step, newton_schulz keeps it cheap
    y, b, s = make_anchor_batch(4, mode="redemod", seed=2, snr_w=10.0)
    o = JOptions(g_update="newton_schulz", max_iter=40, eta_abs=3e-2, eta_rel=3e-2)
    rj = jax_solve(jnp.asarray(y), jnp.asarray(b), jnp.asarray(s), 1.0, o)
    rt = admm_solve(*_t(y, b, s), 1.0, options_from_jax(o))
    np.testing.assert_array_equal(rt.iterations.numpy(), np.asarray(rj.iterations))
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    assert _rel(rt.phi.numpy(), rj.phi) < 2e-5
    assert bool(rt.converged.all()) and len(set(rt.iterations.tolist())) > 1


@pytest.mark.parametrize("phi_update", ["diag", "ref_dense"])
def test_ref_dense_and_leading_batch_dims(phi_update):
    y, b, s = make_anchor_batch(4, mode="redemod", seed=9)
    o = JOptions(g_update="newton_schulz", phi_update=phi_update)
    pj = np.asarray(jax_fixed(jnp.asarray(y), jnp.asarray(b), jnp.asarray(s), 6, 1.0, o))
    yt, bt, st = _t(y.reshape(2, 2, 100), b.reshape(2, 2, 100), s.reshape(2, 2))
    pt = admm_solve_fixed(yt, bt, st, 6, 1.0, options_from_jax(o))
    assert pt.shape == (2, 2, 100)
    assert _rel(pt.numpy().reshape(4, 100), pj) < 2e-5


@pytest.mark.parametrize("g_update", ["fused_fast", "fused_exact"])
def test_fused_modes_fall_back_for_the_dense_phi_update(g_update):
    """The fused solve implements phi_update="diag": with "ref_dense" the
    port warns and runs the loop with polar_fast (polar for fused_exact)
    and the dense phi-update, as the JAX package does off the TPU.
    Tolerance: the loop's, test_fixed_modes_match_jax_scan_path's 1e-4 /
    5e-4 at 20 iterations (fp32 with the sums in another order)."""
    y, b, s = make_anchor_batch(2, mode="redemod", seed=1)
    o = JOptions(g_update=g_update, phi_update="ref_dense")
    with pytest.warns(UserWarning, match="falling back"):
        pj = np.asarray(jax_fixed(jnp.asarray(y), jnp.asarray(b), jnp.asarray(s), 20, 1.0, o))
    fallback = "polar" if g_update == "fused_exact" else "polar_fast"
    with pytest.warns(UserWarning, match=f"g_update={fallback!r}: phi_update='ref_dense'"):
        pt = admm_solve_fixed(*_t(y, b, s), 20, 1.0, options_from_jax(o))
    assert pt.shape == y.shape and bool(torch.all(torch.isfinite(torch.view_as_real(pt))))
    assert _rel(pt.numpy(), pj) < (5e-4 if g_update == "fused_exact" else 1e-4)


@pytest.mark.parametrize("g_update", ["fused_fast", "fused_exact"])
def test_fused_modes_fall_back_above_the_kernel_side(g_update):
    """n = 144 (Nb = Nd = 12) lifts to 145 > 128, beyond the fused kernel's
    planes: the port warns with the JAX package's message and runs the loop
    with polar_fast (polar for fused_exact), as JAX's fallback does.
    Tolerance 1e-5 relative: both run the plain schedule in fp32 with sums
    in another order (measured 1.7e-6 / 2.8e-6)."""
    rng = np.random.default_rng(0)
    n = 144
    y = (rng.normal(size=(4, n)) + 1j * rng.normal(size=(4, n))).astype(np.complex64)
    b = np.exp(2j * np.pi * rng.uniform(size=(4, n))).astype(np.complex64)
    s = rng.uniform(0.05, 0.2, size=4).astype(np.float32)
    o = JOptions(g_update=g_update)
    with pytest.warns(UserWarning, match="falling back"):
        pj = np.asarray(jax_fixed(jnp.asarray(y), jnp.asarray(b), jnp.asarray(s), 5, 1.0, o))
    fallback = "polar" if g_update == "fused_exact" else "polar_fast"
    with pytest.warns(UserWarning, match=f"g_update={fallback!r}: lifted size 145 > 128"):
        pt = admm_solve_fixed(*_t(y, b, s), 5, 1.0, options_from_jax(o))
    assert pt.shape == (4, n) and bool(torch.all(torch.isfinite(torch.view_as_real(pt))))
    assert _rel(pt.numpy(), pj) < 1e-5
