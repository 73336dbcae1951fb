"""Fused ADMM solve kernel (kernels/fused_admm_fast.py): plain version vs the
JAX Pallas kernel in interpret mode (lean layout, fold_diag), the solver
dispatch and the variants that were refused before they were ported (their
parity with JAX is in tests/test_torch_fused_variants.py).  The CUDA kernel itself is checked on
the card by tests/test_torch_cuda.py and chip_smoke.py.

The port's CPU result is held against the JAX kernel's interpret mode, not
against the JAX scan path (which the JAX dispatch uses off-TPU, with a cold
32/8 root-finder).  Tolerances: the production knobs stay within the band
of tests/test_fused_fast.py (5e-5 relative; measured ~2e-6); the
fused_exact knobs amplify last-bit differences through the quintic's large
first-step coefficients (measured 1.5e-5 at 8 iterations), bound 1e-4.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import admmnet_tpu.ops.projections as jpr
from admmnet_tpu.core.config import ADMMOptions as JOptions
from admmnet_tpu.data.anchor import make_anchor_batch
from admmnet_tpu.kernels.fused_admm_fast import (
    _project_sum_inf_block,
    admm_solve_fused_fast as jax_fused,
)
from admmnet_tpu_torch.core.config import ADMMOptions
from admmnet_tpu_torch.core.convert import options_from_jax
from admmnet_tpu_torch.kernels import fused_admm_fast as kf
from admmnet_tpu_torch.solver import admm_solve_fixed
from admmnet_tpu_torch.solver.admm import fused_kernel_options

torch.set_num_threads(1)  # JAX and torch share the cores of one test worker

PROD = dict(hi_steps=0, outer_iters=2, inner_iters=2, schedule=jpr.POLAR_BF16_SCHED2,
            final_hi=False, warm_root=True, all_hi=False, three_pass=False)
EXACT = dict(hi_steps=0, outer_iters=16, inner_iters=8, schedule=jpr.POLAR_QUINTIC_SCHEDULE,
             final_hi=True, warm_root=False, all_hi=True, three_pass=True)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float((np.linalg.norm(a - b, axis=-1) / np.linalg.norm(b, axis=-1)).max())


def _both(y, b, s, iters, rho, kw):
    j = np.asarray(jax_fused(jnp.asarray(y), jnp.asarray(b), jnp.asarray(s), iters, rho, 1.0,
                             kblk=2, interpret=True, layout="lean", fold_diag=True, **kw))
    t = kf.admm_solve_fused_fast(torch.from_numpy(y), torch.from_numpy(b),
                                 torch.from_numpy(s), iters, rho, 1.0, fold_diag=True, **kw)
    assert t.dtype == torch.complex64 and t.shape == y.shape
    return t.numpy(), j


@pytest.mark.parametrize("rho", [1.0, 1.7])
def test_production_knobs_match_interpret(rho):
    y, b, s = make_anchor_batch(3, mode="redemod", seed=3)
    t, j = _both(y, b, s, 15, rho, PROD)
    assert _rel(t, j) < 5e-5


def test_fused_exact_knobs_match_interpret():
    y, b, s = make_anchor_batch(3, mode="redemod", seed=5)
    t, j = _both(y, b, s, 8, 1.0, EXACT)
    assert _rel(t, j) < 1e-4


def test_solver_dispatch_runs_the_plain_fused_solve_on_cpu():
    """admm_solve_fixed maps ADMMOptions onto the kernel's knobs exactly as
    the JAX dispatch does; on CPU tensors it is the plain fused solve."""
    y, b, s = make_anchor_batch(2, mode="redemod", seed=6)
    yt, bt, st = map(torch.from_numpy, (y, b, s))
    for g in ("fused_fast", "fused_exact"):
        opts = options_from_jax(JOptions(g_update=g))
        got = admm_solve_fixed(yt, bt, st, 4, 1.0, opts)
        want = kf.admm_solve_fused_fast_plain(yt, bt, st, 4, 1.0, 1.0,
                                              **fused_kernel_options(opts))
        assert torch.equal(got, want), g
    kw = fused_kernel_options(ADMMOptions(g_update="fused_fast"))
    assert kw["schedule"] == jpr.POLAR_BF16_SCHED2 and kw["warm_root"] is True
    assert (kw["outer_iters"], kw["inner_iters"], kw["final_hi"]) == (2, 2, False)
    kw = fused_kernel_options(ADMMOptions(g_update="fused_exact"))
    assert kw["schedule"] == jpr.POLAR_QUINTIC_SCHEDULE and kw["all_hi"] and kw["three_pass"]
    assert (kw["outer_iters"], kw["inner_iters"], kw["warm_root"]) == (16, 8, False)


@pytest.mark.parametrize("kw", [
    {"layout": "lists"}, {"ablate": "h"}, {"loop_unroll": 2}, {"fold_diag": False},
])
def test_unported_variants_raise(kw):
    """Every variant is ported: the lists layout, an ablate profiling
    variant (on the unfolded carry, as the JAX guard requires), loop_unroll
    and the unfolded carry run their plain version on CPU tensors
    (loop_unroll changes no arithmetic)."""
    y, b, s = map(torch.from_numpy, make_anchor_batch(2, mode="redemod", seed=1))
    if "ablate" in kw:
        kw = dict(kw, fold_diag=False)
    got = kf.admm_solve_fused_fast(y, b, s, 2, **kw)
    plain_kw = {k: v for k, v in kw.items() if k != "loop_unroll"}
    assert torch.equal(got, kf.admm_solve_fused_fast_plain(y, b, s, 2, **plain_kw))
    assert bool(torch.all(torch.isfinite(torch.view_as_real(got))))


@pytest.mark.parametrize("opts", [
    ADMMOptions(g_update="fused_fast", fused_layout="lists"),
    ADMMOptions(g_update="fused_fast", fused_unroll=2),
    ADMMOptions(g_update="fused_exact", fused_fold_diag=False),
    ADMMOptions(g_update="polar_fast", polar_bf16_store=True),
])
def test_solver_rejects_unported_options(opts):
    """The solver refuses what the JAX dispatch refuses: the lists layout
    with the lean-only defaults (fused_fold_diag, fused_warm_root) raises its
    ValueError.  The other options run: fused_unroll as fused_unroll=1, the
    unfolded fused_exact as its plain version, polar_bf16_store as the
    bf16-store polar_fast solve."""
    y, b, s = map(torch.from_numpy, make_anchor_batch(2, mode="redemod", seed=1))
    if opts.fused_layout == "lists":
        with pytest.raises(ValueError, match="lean-layout options"):
            admm_solve_fixed(y, b, s, 2, 1.0, opts)
        return
    got = admm_solve_fixed(y, b, s, 2, 1.0, opts)
    assert bool(torch.all(torch.isfinite(torch.view_as_real(got))))
    if opts.g_update == "fused_fast":
        base = ADMMOptions(g_update="fused_fast")
        assert torch.equal(got, admm_solve_fixed(y, b, s, 2, 1.0, base))
    elif opts.g_update == "fused_exact":
        want = kf.admm_solve_fused_fast_plain(y, b, s, 2, 1.0, 1.0,
                                              **fused_kernel_options(opts))
        assert fused_kernel_options(opts)["fold_diag"] is False
        assert torch.equal(got, want)
    else:
        fp32 = admm_solve_fixed(y, b, s, 2, 1.0, ADMMOptions(g_update="polar_fast"))
        assert not torch.equal(got, fp32)
        assert float(torch.max(torch.abs(got - fp32))) < 1e-2 * float(torch.max(torch.abs(fp32)))


def test_warm_bracket_matches_jax_over_a_drifting_sequence():
    """The carried (lo, hi) bracket and h agree with the JAX block projection
    step by step, including the feasible reset and the re-widening."""
    rng = np.random.default_rng(0)
    K, n = 4, 100
    A = np.full((K, 1), 2.0, np.float32)
    jb = (jnp.zeros((K, 1)), jnp.full((K, 1), 3e37))
    tb = (torch.zeros((K, 1)), torch.full((K, 1), 3e37))
    lane_ok = jnp.asarray((np.arange(128) < n).astype(np.float32)[None])
    for step in range(16):
        scale = (2.0 if step < 8 else 3.0) if step % 5 else 1e-4  # feasible every 5th
        t = (np.abs(rng.normal(size=(K, n))) * scale).astype(np.float32)
        tp = np.zeros((K, 128), np.float32)
        tp[:, :n] = t
        hj, jb = _project_sum_inf_block(jnp.asarray(tp), jnp.asarray(A), lane_ok, 2, 3,
                                        bracket=jb)
        ht, tb = kf.project_sum_inf_block(torch.from_numpy(t), torch.from_numpy(A), 2, 3,
                                          bracket=tb)
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj)[:, :n], rtol=1e-4, atol=1e-6)
        for a, b in zip(tb, jb):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4)


def test_kernel_inputs_and_schedule():
    y, b, s = map(torch.from_numpy, make_anchor_batch(2, mode="redemod", seed=2))
    yob_r, yob_i, w, A = kf.solve_inputs(y, b, s, 1.0)
    assert all(x.dtype == torch.float32 for x in (yob_r, yob_i, w, A))
    np.testing.assert_allclose(A.numpy(), 20.0 * s.numpy() + s.numpy() ** 2, rtol=1e-6)
    sched = kf.full_schedule(jpr.POLAR_BF16_SCHEDULE, 1, False)
    assert sched[-1] == jpr.POLAR_BF16_POLISH and len(sched) == 7
    assert kf.full_schedule(jpr.POLAR_QUINTIC_SCHEDULE, 1, True) == jpr.POLAR_QUINTIC_SCHEDULE
