"""The one-pass precision tier of K1, K2 and K3 on the CPU.

On the card the port runs the products of a schedule step that is not hi,
and K2's closing products when ``final_hi`` is off, as one-pass products:
each operand rounded, the exact products summed in fp32.  K1 rounds to
nearest-even bf16, which is what ``jax.lax.Precision.DEFAULT`` computes on
the MXU; K2 and K3 round to tf32 (ties away from zero), since with bf16
they failed the card's gate (``kernels/fused_admm_fast.py``).
On the CPU both packages compute those products in fp32, so here the JAX
kernels run in interpret mode with ``_mm`` of ``admmnet_tpu.kernels.polar``
and ``admmnet_tpu.kernels.fused_admm_fast`` patched to the card's
arithmetic (the ``card_default`` fixture; the JAX package's files are not
edited), and the port's plain versions run with ``one_pass=True``, the
emulation the card's kernels are held to.

Tolerances, with their reasons:
- The first low step (a one-step schedule; for K2 the second iteration's
  phi, the first that reads a product): the terms are exact and only the
  order of the fp32 sums differs, so within 1e-5 (measured 3.5e-7 for K1
  at m = 101, 9.8e-8 for K2), where the fp32 tier sits 7.5e-4 (K1) and
  2.6e-5 (K2: tf32 rounds 8x finer than bf16) away.
- A whole projection at m = 24 (B = 8), where the fp32 sums are short
  enough that two summation orders rarely flip a bf16 rounding: median
  matrix within 1e-4 and every matrix within 8e-3 (measured 1.3e-7 /
  8.8e-6), where the fp32 tier's median sits 2.3e-3-2.6e-3 away.  8e-3 is
  the JAX package's ceiling for the fast tier's hardware noise
  (tests/test_polar.py).
- A whole projection at m = 101: two summation orders re-roll the
  eigenvalues in the one-pass noise band (~3e-3 ||M||_F), so the port and
  JAX sit ~2e-3 apart, as far as the fp32 tier sits from either; held to
  the 8e-3 ceiling, against JAX and against eigh.
- K2 at 30 iterations (sched2, final_hi off): the JAX package's band for
  the fast mode's phi accuracy floor, max per-instance 0.05
  (tests/test_fused_fast.py; measured 3.5e-3).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admmnet_tpu.kernels.fused_admm_fast as jax_fast
import admmnet_tpu.kernels.polar as jax_polar
import admmnet_tpu.ops.projections as jpr
from admmnet_tpu.data.anchor import make_anchor_batch
from admmnet_tpu_torch.core.config import DETECTION_BUDGET_ITERS, ADMMOptions
from admmnet_tpu_torch.kernels import _build
from admmnet_tpu_torch.kernels import fused_admm_fast as kf
from admmnet_tpu_torch.kernels import polar as kp
from admmnet_tpu_torch.ops.projections import psd_project_eigh
from admmnet_tpu_torch.solver import admm
from admmnet_tpu_torch.solver.admm import fused_kernel_options

torch.set_num_threads(1)  # JAX and torch share the cores of one test worker

PINNED = dict(hi_steps=0, outer_iters=4, inner_iters=3, schedule=jpr.POLAR_BF16_SCHED2,
              final_hi=False)


def _rel(a, b, reduce=np.max):
    """Per-instance relative error of a against b, reduced over instances."""
    a, b = np.asarray(a), np.asarray(b)
    a, b = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
    return float(reduce(np.linalg.norm(a - b, axis=-1) / np.linalg.norm(b, axis=-1)))


def _hermitian(B, m, seed=12):
    rng = np.random.default_rng(seed)
    X = (rng.normal(size=(B, m, m)) + 1j * rng.normal(size=(B, m, m))).astype(np.complex64)
    return np.ascontiguousarray((X + np.conj(np.swapaxes(X, -1, -2))) / 2)


def _tf32(x):
    """x rounded to tf32, ties away from zero (the kernel's to_tf32)."""
    u = jax.lax.bitcast_convert_type(x, jnp.int32)
    return jax.lax.bitcast_convert_type((u + 0x1000) & ~0x1FFF, jnp.float32)


@pytest.fixture
def card_default(monkeypatch):
    """The JAX kernels' DEFAULT products as the card computes them: K1's
    operands rounded to bf16 (the MXU's arithmetic; bf16 operands stay as
    they are), K2's and K3's to tf32, the exact products summed in fp32.
    JAX's caches are cleared on both sides, so no trace of the patched
    kernels outlives the test."""
    polar_mm, fast_mm = jax_polar._mm, jax_fast._mm

    def one_pass_polar(a, b, hi, out_dtype=jnp.float32):
        if not hi:
            a, b = a.astype(jnp.bfloat16), b.astype(jnp.bfloat16)
        return polar_mm(a, b, hi, out_dtype)

    def one_pass_fast(a, b, hi=False):
        if not hi:
            a, b = _tf32(a), _tf32(b)
        return fast_mm(a, b, hi)

    jax.clear_caches()
    monkeypatch.setattr(jax_polar, "_mm", one_pass_polar)
    monkeypatch.setattr(jax_fast, "_mm", one_pass_fast)
    yield monkeypatch
    monkeypatch.undo()
    jax.clear_caches()


def _jax_polar(M, **kw):
    return np.asarray(jax_polar.psd_project_polar_pallas(jnp.asarray(M), interpret=True,
                                                         mode="fast", **kw))


def test_k1_first_low_step_matches_the_card(card_default):
    one = (jpr.POLAR_BF16_SCHEDULE[0],)
    card_default.setattr(jax_polar, "POLAR_BF16_SCHEDULE", one)
    M = _hermitian(3, 101)
    Pj = _jax_polar(M, hi_steps=0)
    Mt = torch.from_numpy(M)
    assert _rel(kp.polar_plain_schedule(Mt, one, 0, False, True).numpy(), Pj) < 1e-5
    assert _rel(kp.polar_plain_schedule(Mt, one, 0, False, False).numpy(), Pj) > 1e-4


@pytest.mark.parametrize("fold_diag", [True, False])
def test_k2_first_low_step_matches_the_card(card_default, fold_diag):
    """One schedule step and final_hi off: the second iteration's phi reads
    the first iteration's one-pass products (the first phi reads none)."""
    y, b, s = make_anchor_batch(4, mode="redemod", seed=3)
    kw = dict(PINNED, schedule=(jpr.POLAR_BF16_SCHED2[0],), layout="lean",
              fold_diag=fold_diag, warm_root=fold_diag)
    j = jax_fast.admm_solve_fused_fast(jnp.asarray(y), jnp.asarray(b), jnp.asarray(s), 2, 1.0,
                                       1.0, kblk=2, interpret=True, **kw)
    rows = [torch.from_numpy(x) for x in (y, b, s)]
    t = kf.admm_solve_fused_fast_plain(*rows, 2, 1.0, 1.0, one_pass=True, **kw)
    t32 = kf.admm_solve_fused_fast_plain(*rows, 2, 1.0, 1.0, **kw)
    assert _rel(t.numpy(), j) < 1e-5
    assert _rel(t32.numpy(), j) > 1e-5


@pytest.mark.parametrize("bf16_store", [False, True])
@pytest.mark.parametrize("hi_steps", [0, 1])
def test_k1_fast_matches_the_card(card_default, hi_steps, bf16_store):
    """At m = 24 every rounding point of the port is the card's."""
    M = _hermitian(8, 24)
    Pj = _jax_polar(M, hi_steps=hi_steps, bf16_store=bf16_store)
    Mt = torch.from_numpy(M)
    Pt = kp.psd_project_polar_plain(Mt, "fast", hi_steps, bf16_store, one_pass=True).numpy()
    assert _rel(Pt, Pj, np.median) <= 1e-4
    assert _rel(Pt, Pj) < 8e-3
    if not bf16_store:  # the fp32 tier does not pass for the one-pass one
        P32 = kp.psd_project_polar_plain(Mt, "fast", hi_steps).numpy()
        assert _rel(P32, Pj, np.median) > 1e-3


@pytest.mark.parametrize("hi_steps", [0, 1])
def test_k1_fast_at_the_lifted_side_stays_under_the_noise_ceiling(card_default, hi_steps):
    M = _hermitian(3, 101)
    Pj = _jax_polar(M, hi_steps=hi_steps)
    Mt = torch.from_numpy(M)
    Pt = kp.psd_project_polar_plain(Mt, "fast", hi_steps, one_pass=True).numpy()
    assert _rel(Pt, Pj) < 8e-3
    assert _rel(Pt, psd_project_eigh(Mt).numpy()) < 8e-3


@pytest.mark.parametrize("layout, fold_diag", [("lean", True), ("lean", False),
                                               ("lists", False)])
def test_k2_k3_match_the_mxu(card_default, layout, fold_diag):
    """K2 (folded: the production carry; unfolded) and K3 at bench.py's
    pinned knobs, 30 iterations."""
    y, b, s = make_anchor_batch(4, mode="redemod", seed=3)
    kw = dict(PINNED, layout=layout, fold_diag=fold_diag, warm_root=fold_diag)
    j = jax_fast.admm_solve_fused_fast(jnp.asarray(y), jnp.asarray(b), jnp.asarray(s), 30, 1.0,
                                       1.0, kblk=2, interpret=True, **kw)
    t = kf.admm_solve_fused_fast_plain(*(torch.from_numpy(x) for x in (y, b, s)), 30, 1.0, 1.0,
                                       one_pass=True, **kw)
    assert bool(np.all(np.isfinite(np.asarray(j))))
    assert _rel(t.numpy(), j) < 0.05


def test_the_tier_follows_the_device():
    """A CPU tensor runs every product in fp32, as DEFAULT does in JAX on
    the CPU: the wrappers are the plain versions without one_pass."""
    Mt = torch.from_numpy(_hermitian(2, 24))
    assert torch.equal(kp.psd_project_polar_kernel(Mt, mode="fast"),
                       kp.psd_project_polar_plain(Mt, "fast"))
    assert not torch.equal(kp.psd_project_polar_kernel(Mt, mode="fast"),
                           kp.psd_project_polar_plain(Mt, "fast", one_pass=True))
    rows = [torch.from_numpy(x) for x in make_anchor_batch(2, mode="redemod", seed=1)]
    kw = fused_kernel_options(ADMMOptions(g_update="fused_fast"))
    assert torch.equal(kf.admm_solve_fused_fast(*rows, 3, **kw),
                       kf.admm_solve_fused_fast_plain(*rows, 3, **kw))


class _FakeLaunches:
    """Records the entry point and the named arguments of each launch."""

    def __init__(self):
        self.calls = []

    def __call__(self, entry, counter, **args):
        assert set(args) == set(_build.ARGS[entry]), entry
        self.calls.append((entry, args))


@pytest.fixture
def fake_card(monkeypatch):
    """Meta tensors stand in for the card's: the wrappers take the launch
    branch, and ``_build.launch`` records their launches (_FakeLaunches)."""
    launches = _FakeLaunches()
    monkeypatch.setattr(_build, "launch", launches)
    return launches


def _meta_rows(B=4, n=100):
    return (torch.empty((B, n), dtype=torch.complex64, device="meta"),
            torch.empty((B, n), dtype=torch.complex64, device="meta"),
            torch.empty((B,), dtype=torch.float32, device="meta"))


@pytest.mark.parametrize("g_update, iters, one_pass", [
    ("fused_fast", 100, True),                      # the production solve
    ("fused_fast", DETECTION_BUDGET_ITERS, True),   # the classical deploy point
    ("fused_exact", 100, False),                    # the phi-faithful contract
])
def test_the_fused_dispatch_launches_its_tier(fake_card, g_update, iters, one_pass):
    admm.admm_solve_fixed(*_meta_rows(), iters, 1.0, ADMMOptions(g_update=g_update))
    (name, a), = fake_card.calls
    assert name == "fused_admm_fast_launch"
    assert a["num_iters"] == iters
    low = kf.one_pass_products(a["nsteps"], a["hi_steps"], bool(a["all_hi"]),
                               bool(a["final_hi"]))
    # sched2 at the production point: 2 low steps and the closing products
    assert low == (21 if one_pass else 0)


@pytest.mark.parametrize("knobs", [
    dict(all_hi=False, hi_steps=0, final_hi=True),   # low steps
    dict(all_hi=False, hi_steps=1, final_hi=True),   # low steps before the polish step
    dict(all_hi=True, hi_steps=0, final_hi=False),   # one-pass closing products
])
def test_three_pass_with_low_products_is_refused_on_the_card(fake_card, knobs):
    """The card's three_pass kernel has no one-pass product, so a launch
    that would need one raises instead of computing a tier the JAX package
    does not have; the CPU's plain version runs it."""
    with pytest.raises(ValueError, match="three_pass only with every product hi"):
        kf.admm_solve_fused_fast(*_meta_rows(), 3, three_pass=True, **knobs)
    assert fake_card.calls == []
    rows = [torch.from_numpy(x) for x in make_anchor_batch(2, mode="redemod", seed=1)]
    phi = kf.admm_solve_fused_fast(*rows, 3, three_pass=True, **knobs)
    assert bool(torch.all(torch.isfinite(torch.view_as_real(phi))))


@pytest.mark.parametrize("g_update, bf16_store, low_steps", [
    ("polar_fast", False, 6),    # the fast mode: every step low
    ("polar_fast", True, 6),     # with bf16 iterate storage
    ("polar", False, 0),         # accurate: every step hi
])
def test_the_polar_dispatch_launches_its_tier(fake_card, g_update, bf16_store, low_steps):
    M = torch.empty((4, 101, 101), dtype=torch.complex64, device="meta")
    admm._g_step(M, ADMMOptions(g_update=g_update, polar_bf16_store=bf16_store))
    (name, a), = fake_card.calls
    assert name == "polar_psd_launch"
    assert a["bf16_store"] == int(bf16_store)
    assert a["nsteps"] - a["hi_steps"] == low_steps


@pytest.mark.parametrize("change", ["missing", "unknown"])
def test_launch_checks_the_names_before_loading_the_library(monkeypatch, change):
    """``_build.launch`` takes exactly the names of the entry point's
    ``SIGNATURES`` row: a missing or an unknown one raises TypeError, naming
    it, before the library loads."""
    def no_library():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(_build, "lib", no_library)
    args = dict.fromkeys(_build.ARGS["eigh_jacobi_launch"], 0)
    if change == "missing":
        del args["smem"]
    else:
        args["stream"] = 0
    counter = types.SimpleNamespace(count=0)
    with pytest.raises(TypeError, match="smem" if change == "missing" else "stream"):
        _build.launch("eigh_jacobi_launch", counter, **args)
    assert counter.count == 0


def test_refine_one_pass_rounds_the_operands():
    """The peak search's refine products on the card: the real and
    imaginary parts of both operands rounded to bf16, the exact products
    summed in float32 (against float64 sums of the same rounded parts)."""
    from admmnet_tpu_torch.peaks.search import refine_product

    rng = np.random.default_rng(3)
    a = (rng.normal(size=(2, 3, 11, 10)) + 1j * rng.normal(size=(2, 3, 11, 10)))
    b = (rng.normal(size=(2, 1, 10, 10)) + 1j * rng.normal(size=(2, 1, 10, 10)))
    at, bt = (torch.from_numpy(x.astype(np.complex64)) for x in (a, b))

    def rn(x):
        return torch.complex(x.real.to(torch.bfloat16).double(),
                             x.imag.to(torch.bfloat16).double())

    ref = (rn(at) @ rn(bt)).numpy()
    got = refine_product(at, bt, True).numpy()
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 1e-6
    assert np.max(np.abs(refine_product(at, bt, False).numpy() - ref)) / np.max(np.abs(ref)) > 1e-4
    assert torch.equal(refine_product(at, bt, False), at @ bt)


def test_refine_default_is_float32_on_the_cpu():
    import dataclasses

    from admmnet_tpu_torch.core.config import PRODUCTION_PEAKS
    from admmnet_tpu_torch.peaks import find_peaks

    y, b, s = make_anchor_batch(2, mode="redemod", seed=0)
    phi = kf.admm_solve_fused_fast(*(torch.from_numpy(x) for x in (y, b, s)), 5,
                                   **fused_kernel_options(ADMMOptions(g_update="fused_fast")))
    hi = dataclasses.replace(PRODUCTION_PEAKS, refine_precision="highest")
    for x, z in zip(find_peaks(phi, 10, 10, PRODUCTION_PEAKS), find_peaks(phi, 10, 10, hi)):
        assert torch.equal(x, z)
