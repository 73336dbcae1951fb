"""Each cell's comparison catches the faults that cell can have, and its
control: a run on the CPU at a small size, with the timed path broken
underneath, comes out not correct; the reference one tier below the
configuration's, put in the program's place, fails a number.  A sound run
of the same size is correct (test_gpubench_harness)."""

import time

import pytest
import torch

from conftest import small_cell
from gpubench import harness


def run(name, seed=2**31 + 1):
    return harness.run_cell(small_cell(name), seed, 0.2, False, torch.device("cpu"),
                            time.monotonic())


# ---- faults planted in the program --------------------------------------------


def solve_unchanged(monkeypatch):
    import admmnet_tpu_torch.solver as solver

    monkeypatch.setattr(solver, "admm_solve_fixed",
                        lambda y, b, sigma, *a, **k: torch.zeros_like(y))


def solve_half(monkeypatch):
    import admmnet_tpu_torch.solver as solver

    orig = solver.admm_solve_fixed

    def half(y, b, sigma, *a, **k):
        h = max(y.shape[0] // 2, 1)
        phi = torch.zeros_like(y)
        phi[:h] = orig(y[:h], b[:h], sigma[:h], *a, **k)
        return phi

    monkeypatch.setattr(solver, "admm_solve_fixed", half)


def peaks_altered(monkeypatch):
    import admmnet_tpu_torch.peaks as peaks

    orig = peaks.find_peaks

    def altered(phi, *a, **k):
        out = orig(phi, *a, **k)
        tau = out.tau.clone()
        tau[0, 0] = torch.remainder(tau[0, 0] + 0.05, 1.0)
        return out._replace(tau=tau)

    monkeypatch.setattr(peaks, "find_peaks", altered)


def zlayer_unchanged(monkeypatch):
    from admmnet_tpu_torch.models import layers

    monkeypatch.setattr(layers.ZLayer, "forward", lambda self, phi, h, G, Z_prev, k: Z_prev)


def net_half(monkeypatch):
    from admmnet_tpu_torch.models import nets

    orig = nets.ADMMNet.forward

    def half(self, y, b, sigma):
        h = max(y.shape[0] // 2, 1)
        outs = orig(self, y[:h], b[:h], sigma[:h])
        return tuple(torch.cat([o, torch.zeros((y.shape[0] - h, *o.shape[1:]), dtype=o.dtype)])
                     for o in outs)

    monkeypatch.setattr(nets.ADMMNet, "forward", half)


def head_altered(monkeypatch):
    from admmnet_tpu_torch.models import peak_head

    orig = peak_head.SpectrumPeakHead.forward

    def altered(self, phi):
        tau, f, conf = orig(self, phi)
        tau = tau.clone()
        tau[0, 0] = tau[0, 0] + 0.05
        return tau, f, conf

    monkeypatch.setattr(peak_head.SpectrumPeakHead, "forward", altered)


def step_unchanged(monkeypatch):
    from admmnet_tpu_torch.train import trainer

    orig = trainer.make_optimizer

    def frozen(model, tcfg):
        opt = orig(model, tcfg)
        opt.step = lambda *a, **k: None
        return opt

    monkeypatch.setattr(trainer, "make_optimizer", frozen)


def loss_half(monkeypatch):
    from admmnet_tpu_torch.train import trainer

    orig = trainer.basic_anm_loss

    def half(tau, f, conf, phi, tau_t, f_t, L, **k):
        h = tau.shape[0] // 2
        return orig(tau[:h], f[:h], conf[:h], phi[:h], tau_t[:h], f_t[:h], L[:h], **k)

    monkeypatch.setattr(trainer, "basic_anm_loss", half)


def glayer_backward(scale):
    """The gradient leaving the GLayer's Clenshaw evaluation (K6's
    output, in the kernel's place) scaled: 0 zeroed, -1 negated."""

    def fault(monkeypatch):
        from admmnet_tpu_torch.kernels import cheb_filter

        orig = cheb_filter.apply_spectral_filter_kernel

        class Scaled(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return x.view_as(x)

            @staticmethod
            def backward(ctx, g):
                return g * scale

        monkeypatch.setattr(cheb_filter, "apply_spectral_filter_kernel",
                            lambda *a, **k: Scaled.apply(orig(*a, **k)))

    fault.__name__ = f"glayer_backward_times_{scale:g}"
    return fault


FAULTS = [
    ("classical-bulk", solve_unchanged), ("classical-bulk", solve_half),
    ("classical-bulk", peaks_altered),
    ("classical-single", solve_unchanged), ("classical-single", peaks_altered),
    ("learned-bulk", zlayer_unchanged), ("learned-bulk", net_half),
    ("learned-bulk", head_altered),
    ("train-step", step_unchanged), ("train-step", loss_half),
    ("train-step", glayer_backward(0.0)), ("train-step", glayer_backward(-1.0)),
]


@pytest.mark.parametrize("name,fault", FAULTS, ids=[f"{n}-{f.__name__}" for n, f in FAULTS])
def test_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    res = run(name)
    assert res["correct"] is False, res["checks"]


# ---- the control ----------------------------------------------------------------


def control_fails(cell, device, seed):
    cell.limits = harness.load_cell(cell.name).limits
    driver = cell.driver()
    st = driver.setup(cell, seed, device, harness.Spans(False))
    verdict = driver.control(st)
    return any(c["value"] > c["limit"] for c in verdict["checks"].values()), verdict


@pytest.mark.parametrize("name", ["classical-bulk", "classical-single", "learned-bulk",
                                  "train-step"])
def test_control_fails_on_cpu(name):
    failed, verdict = control_fails(small_cell(name), torch.device("cpu"), 2**31 + 9)
    assert failed, verdict["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["classical-bulk", "classical-single", "learned-bulk",
                                  "train-step"])
def test_control_fails_at_the_cells_size(name, cuda):
    for seed in (2**31 + 21, 2**31 + 22, 2**31 + 23):
        failed, verdict = control_fails(harness.load_cell(name), cuda, seed)
        assert failed, verdict["checks"]
