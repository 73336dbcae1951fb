"""Whole-solve variants of the port vs the JAX package on the CPU: the lists
layout (K3) and the unfolded carry of the lean layout (K2), the
first-generation fused solve (K7, ``kernels/fused_admm.py``) and the polar
kernel's bf16 iterate storage (K1 ``bf16_store``).  Each plain version is
held against the JAX Pallas kernel in interpret mode on the same numpy
inputs; the CUDA kernels themselves are checked on the card by
tests/test_torch_cuda.py and chip_smoke.py.  Also: the JAX wrapper's
argument guards, the solver's option mapping and the bench_time CLI.

Tolerances, with their reasons:
- K3 and the unfolded carry, 15 iterations: fp32 sums in another order
  (measured ~2e-6); the band of tests/test_fused_fast.py, 5e-5.
- K7: the quintic schedule's large first-step coefficients amplify
  last-bit differences over the iterations: at B = 3 x 15 the port is
  9.3e-5 from the JAX kernel, and the JAX package's own two routes of the
  same math (the kernel and the per-step polar solve) are 1.04e-4 apart, so
  the bound is 2e-4 there and 1e-4 at the 8-iteration point (measured 1.3e-5).
- bf16 storage: a product whose fp32 sums run in another order can round to
  the neighbouring bf16 value (2^-8 relative), which the later low steps
  carry.  At m = 101 (B = 3) the port is 2.6e-4 / 0 / 3.6e-3 from the JAX
  kernel at hi_steps 0 and 9.9e-5 / 8.9e-8 / 2.4e-3 at 1: bound 1e-2 on the
  worst matrix and 1e-3 on the median one, where the fp32 store sits
  4.2e-3-4.4e-3 (2.9e-3-3.0e-3) away.  At m = 24 (B = 8) no rounding flips:
  every matrix is bitwise equal (hi_steps 0) or within 8.8e-8 (1), bound
  1e-6, against 3.4e-3-1.1e-2 for the fp32 store.  Against eigh the JAX
  test's 8e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admmnet_tpu.ops.projections as jpr
from admmnet_tpu.data.anchor import make_anchor_batch
from admmnet_tpu.kernels.fused_admm import _project_sum_inf_row
from admmnet_tpu.kernels.fused_admm import admm_solve_fused as jax_k7
from admmnet_tpu.kernels.fused_admm_fast import admm_solve_fused_fast as jax_fused
from admmnet_tpu.kernels.polar import psd_project_polar_pallas
from admmnet_tpu_torch.core.config import ADMMOptions
from admmnet_tpu_torch.kernels import fused_admm as k7
from admmnet_tpu_torch.kernels import fused_admm_fast as kf
from admmnet_tpu_torch.kernels import polar as kp
from admmnet_tpu_torch.ops.projections import psd_project_eigh
from admmnet_tpu_torch.solver import admm_solve_fixed
from admmnet_tpu_torch.solver.admm import fused_kernel_options

torch.set_num_threads(1)  # JAX and torch share the cores of one test worker

# bench.py's pinned control knobs: sched2, a 4/3 cold root, final_hi off
PINNED = dict(hi_steps=0, outer_iters=4, inner_iters=3, schedule=jpr.POLAR_BF16_SCHED2,
              final_hi=False)


def _rel(a, b, reduce=np.max):
    """Per-instance relative error of a against b, reduced over instances."""
    a, b = np.asarray(a), np.asarray(b)
    a, b = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
    return float(reduce(np.linalg.norm(a - b, axis=-1) / np.linalg.norm(b, axis=-1)))


def _tensors(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("rho", [1.0, 1.7])
@pytest.mark.parametrize("layout", ["lists", "lean"])
def test_unfolded_layouts_match_interpret(layout, rho):
    """K3 (lists) and the lean layout's unfolded carry, cold root."""
    y, b, s = make_anchor_batch(3, mode="redemod", seed=3)
    j = jax_fused(jnp.asarray(y), jnp.asarray(b), jnp.asarray(s), 15, rho, 1.0, kblk=2,
                  interpret=True, layout=layout, fold_diag=False, **PINNED)
    t = kf.admm_solve_fused_fast(*_tensors(y, b, s), 15, rho, 1.0, layout=layout,
                                 fold_diag=False, **PINNED)
    assert t.dtype == torch.complex64 and t.shape == y.shape
    assert _rel(t.numpy(), j) < 5e-5


@pytest.mark.parametrize("ablate", kf.ABLATE[1:])
def test_ablate_variants_match_interpret(ablate):
    """K2's profiling variants (B6) on the unfolded lean layout, at
    runs/profile_lean.py's knobs (the ablations change the values that flow
    on, not the order of any sum), with the unfolded carry's bound."""
    y, b, s = make_anchor_batch(2, mode="redemod", seed=4)
    j = jax_fused(jnp.asarray(y), jnp.asarray(b), jnp.asarray(s), 3, 1.0, 1.0, kblk=2,
                  interpret=True, layout="lean", fold_diag=False, ablate=ablate, **PINNED)
    t = kf.admm_solve_fused_fast(*_tensors(y, b, s), 3, 1.0, 1.0, layout="lean",
                                 fold_diag=False, ablate=ablate, **PINNED)
    assert t.dtype == torch.complex64 and t.shape == y.shape
    assert bool(np.all(np.isfinite(np.asarray(j))))
    assert _rel(t.numpy(), j) < 5e-5


@pytest.mark.parametrize("B, iters, rho, lam, tol", [(3, 15, 1.0, 1.0, 2e-4),
                                                     (2, 8, 2.0, 0.5, 1e-4)])
def test_k7_plain_matches_interpret(B, iters, rho, lam, tol):
    y, b, s = make_anchor_batch(B, mode="redemod", seed=3 if B == 3 else 1)
    j = jax_k7(jnp.asarray(y), jnp.asarray(b), jnp.asarray(s), iters, rho=rho,
               lambda_val=lam, interpret=True)
    t = k7.admm_solve_fused(*_tensors(y, b, s), iters, rho, lam)
    assert t.dtype == torch.complex64 and t.shape == y.shape
    assert _rel(t.numpy(), j) < tol


def test_k7_plain_matches_interpret_at_plane_side_128():
    """K7's plain version at n = 119 (lifted side 120: plane side 128, where
    the card's kernel runs as a cluster of two CTAs): the anchor's three
    targets on a 7 x 17 grid with QPSK symbols and 20 dB noise, 2 instances
    x 4 iterations, the bound of the short solve above."""
    from admmnet_tpu_torch.data.anchor import ANCHOR_C, ANCHOR_F, ANCHOR_TAU, _psi

    rng = np.random.default_rng(5)
    n = 7 * 17
    b = np.exp(1j * (np.pi / 2 * rng.integers(0, 4, size=(2, n)) + np.pi / 4))
    clean = b * _psi(ANCHOR_TAU, ANCHOR_F, ANCHOR_C, 7, 17)[None]
    scale = np.linalg.norm(clean, axis=-1, keepdims=True) / np.sqrt(200.0 * n)
    y = clean + scale * (rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n)))
    y, b = y.astype(np.complex64), b.astype(np.complex64)
    s = np.full(2, 1.5, np.float32)
    j = jax_k7(jnp.asarray(y), jnp.asarray(b), jnp.asarray(s), 4, interpret=True)
    t = k7.admm_solve_fused(*_tensors(y, b, s), 4)
    assert t.shape == y.shape and bool(np.all(np.isfinite(np.asarray(j))))
    assert _rel(t.numpy(), j) < 1e-4


def test_k7_plain_matches_the_polar_solve():
    """tests/test_fused_kernel.py's bound, against the port's per-step
    g_update="polar" solve."""
    yt, bt, st = _tensors(*make_anchor_batch(3, mode="redemod", seed=0))
    phi_k = k7.admm_solve_fused(yt, bt, st, 15)
    phi_x = admm_solve_fixed(yt, bt, st, 15, 1.0, ADMMOptions(g_update="polar"))
    assert _rel(phi_k.numpy(), phi_x.numpy()) < 5e-4


def test_nested_projection_matches_the_row_projection():
    rng = np.random.default_rng(7)
    n, lane_ok = 100, jnp.asarray((np.arange(128) < 100).astype(np.float32)[None])
    rows = jax.jit(jax.vmap(
        lambda t, A: _project_sum_inf_row(t[None], A, lane_ok, 32, 32)[0]))
    # feasible rows, then infeasible ones at two constraint weights
    t = np.concatenate([rng.normal(size=(4, n)) * s for s in (1e-3, 3.0, 2.0)])
    t = t.astype(np.float32)
    A = np.repeat(np.float32([2.0, 2.0, 40.0]), 4)
    hj = np.asarray(rows(jnp.asarray(np.pad(t, ((0, 0), (0, 128 - n)))), jnp.asarray(A)))
    ht = k7.project_sum_inf_nested(torch.from_numpy(t), torch.from_numpy(A)[:, None], 32, 32)
    np.testing.assert_allclose(ht.numpy(), hj[:, :n], rtol=1e-4, atol=1e-6)


def _bf16_store_pair(B, m, hi_steps):
    """(port, JAX interpret, port with the fp32 store, M) for seeded
    Hermitian (B, m, m) matrices."""
    rng = np.random.default_rng(12)
    X = (rng.normal(size=(B, m, m)) + 1j * rng.normal(size=(B, m, m))).astype(np.complex64)
    M = (X + np.conj(np.swapaxes(X, -1, -2))) / 2
    Pj = psd_project_polar_pallas(jnp.asarray(M), interpret=True, mode="fast",
                                  hi_steps=hi_steps, bf16_store=True)
    Mt = torch.from_numpy(M)
    Pt = kp.psd_project_polar_kernel(Mt, mode="fast", hi_steps=hi_steps, bf16_store=True)
    P32 = kp.psd_project_polar_kernel(Mt, mode="fast", hi_steps=hi_steps)
    return Pt.numpy(), np.asarray(Pj), P32.numpy(), Mt


@pytest.mark.parametrize("hi_steps", [0, 1])
def test_bf16_store_plain_matches_interpret(hi_steps):
    Pt, Pj, P32, Mt = _bf16_store_pair(3, 101, hi_steps)
    assert _rel(Pt, Pj) < 1e-2
    assert _rel(Pt, Pj, np.median) < 1e-3
    assert _rel(P32, Pj, np.median) > 2e-3  # the rounding shows at this size
    assert _rel(Pt, psd_project_eigh(Mt).numpy()) < 8e-3
    # the knob takes effect only in fast mode (as in the JAX wrapper)
    assert torch.equal(kp.psd_project_polar_kernel(Mt[:1], bf16_store=True),
                       kp.psd_project_polar_kernel(Mt[:1]))


@pytest.mark.parametrize("hi_steps", [0, 1])
def test_bf16_store_rounding_points_match_interpret(hi_steps):
    """At m = 24 the fp32 sums are short enough that no bf16 rounding flips,
    so every rounding point of the port must be the JAX kernel's: the
    matrices agree to fp32 noise, where the fp32 store is ~5e-3 away."""
    Pt, Pj, P32, _ = _bf16_store_pair(8, 24, hi_steps)
    assert _rel(Pt, Pj) < 1e-6
    assert _rel(P32, Pj, np.min) > 2e-3


@pytest.mark.parametrize("kw", [
    {"layout": "stacked"},
    {"layout": "lists", "ablate": "h"},
    {"ablate": "h", "fold_diag": True},
    {"layout": "lists", "fold_diag": True},
    {"layout": "lists", "warm_root": True},
    {"layout": "lists", "all_hi": True},
    {"layout": "lists", "three_pass": True},
])
def test_argument_guards_are_the_jax_wrappers(kw):
    y, b, s = make_anchor_batch(2, mode="redemod", seed=1)
    with pytest.raises(ValueError) as jax_err:
        jax_fused(jnp.asarray(y), jnp.asarray(b), jnp.asarray(s), 2, interpret=True, **kw)
    with pytest.raises(ValueError) as port_err:
        kf.admm_solve_fused_fast(*_tensors(y, b, s), 2, **kw)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("kw", [dict(layout="lists"),
                                dict(layout="lean", fold_diag=True, warm_root=True)])
def test_loop_unroll_changes_nothing(kw):
    y, b, s = _tensors(*make_anchor_batch(2, mode="redemod", seed=4))
    one = kf.admm_solve_fused_fast(y, b, s, 5, **kw)
    assert torch.equal(kf.admm_solve_fused_fast(y, b, s, 5, loop_unroll=2, **kw), one)


def test_fused_kernel_options_keep_the_production_kernel():
    """The production option sets map to the folded lean kernel, as the JAX
    dispatch maps them; the escape hatch needs both lean-only knobs off."""
    for g in ("fused_fast", "fused_exact"):
        kw = fused_kernel_options(ADMMOptions(g_update=g))
        assert kw["layout"] == "lean" and kw["fold_diag"] is True, g
    assert fused_kernel_options(ADMMOptions(g_update="fused_fast"))["loop_unroll"] == 1
    assert "loop_unroll" not in fused_kernel_options(ADMMOptions(g_update="fused_exact"))
    y, b, s = _tensors(*make_anchor_batch(2, mode="redemod", seed=2))
    with pytest.raises(ValueError, match="lean-layout options"):
        admm_solve_fixed(y, b, s, 2, 1.0, ADMMOptions(g_update="fused_fast",
                                                      fused_layout="lists"))
    hatch = ADMMOptions(g_update="fused_fast", fused_layout="lists", fused_fold_diag=False,
                        fused_warm_root=False, fused_proj_iters=4, fused_inner_iters=3)
    kw = fused_kernel_options(hatch)
    assert (kw["layout"], kw["fold_diag"], kw["warm_root"]) == ("lists", False, False)
    assert torch.equal(admm_solve_fixed(y, b, s, 3, 1.0, hatch),
                       kf.admm_solve_fused_fast_plain(y, b, s, 3, 1.0, 1.0, **kw))


def test_bench_time_admm(capsys, tmp_path):
    from admmnet_tpu_torch.cli.bench_time import main

    out = tmp_path / "t.txt"
    main(["--what", "admm", "--runs", "8", "--iters", "3", "--out", str(out),
          "--device", "cpu"])
    txt = capsys.readouterr().out
    assert "classical ADMM (3 iters, newton_schulz)" in txt and "batched x8" in txt
    assert out.exists() and np.loadtxt(out).shape == (8,)


def test_bench_time_repeat(capsys):
    from admmnet_tpu_torch.cli.bench_time import main

    main(["--what", "admm", "--runs", "4", "--iters", "2", "--repeat", "2",
          "--device", "cpu"])
    txt = capsys.readouterr().out
    assert "batched x4" in txt
    calls = [ln for ln in txt.splitlines() if ln.startswith("timed calls:")]
    assert len(calls) == 1 and len(calls[0].split()[2:]) == 2


def test_bench_time_fused_layout(capsys, monkeypatch):
    """--fused-layout lists times K3's escape hatch: the solver's lists
    layout with the lean-only defaults off and a 4/3 cold root."""
    import admmnet_tpu_torch.solver as solver
    from admmnet_tpu_torch.cli import bench_time

    seen, solve = [], solver.admm_solve_fixed

    def spy(y, b, s, iters, rho, opts):
        seen.append(opts)
        return solve(y, b, s, iters, rho, opts)

    monkeypatch.setattr(solver, "admm_solve_fixed", spy)
    bench_time.main(["--what", "admm", "--g-update", "fused_fast", "--fused-layout", "lists",
                     "--runs", "2", "--iters", "2", "--device", "cpu"])
    txt = capsys.readouterr().out
    assert "fused_fast, lists layout, unfolded, 4/3 cold root" in txt
    assert seen and all(
        (o.fused_layout, o.fused_fold_diag, o.fused_warm_root, o.fused_proj_iters,
         o.fused_inner_iters) == ("lists", False, False, 4, 3) for o in seen)


def test_bench_time_e2e(capsys):
    from admmnet_tpu_torch.cli.bench_time import main

    main(["--what", "e2e", "--runs", "4", "--layers", "1", "--g-mode", "chebyshev",
          "--device", "cpu"])
    txt = capsys.readouterr().out
    assert "ADMM-Net e2e detection" in txt and "spectrum head" in txt
