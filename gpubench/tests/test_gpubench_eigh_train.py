"""The training cell of upstream's training step, ``train10-eigh-step`` (ten
eigh GLayers, the attention head in training mode), on the CPU at small
sizes.
A sound run is correct and reports its metrics; each planted fault and the
control come out not correct; the frozen counts of the step."""

import time

import pytest
import torch

from conftest import small_cell
from gpubench import harness
from gpubench.flops import learned_eigh_deploy as eigh_fl

EIGH = "train10-eigh-step"


def test_eigh_train_flops():
    """Per step at B = 256, m = 101: nine GLayers of eigh (36 m^3) and the
    rebuild (8 m^3) forward, M_bar and the rebuild's gradient (8 m^3 each)
    backward, and the head three times; the eigensolves' bytes."""
    cell = harness.load_cell(EIGH)
    counts = cell.flops().per_call(cell.config, cell.traffic)
    B, m = 256, 101
    assert counts["eigh"] == (eigh_fl.eigh_flops(B, m), eigh_fl.eigh_bytes(B, m))
    assert counts["backward"][0] == pytest.approx(B * 16.0 * m**3)
    head = eigh_fl.head_flops(B, cell.config["model"], cell.config["spec"])
    assert counts["call"][0] == pytest.approx(9 * B * (36 + 8 + 16) * m**3 + 3 * head)
    assert counts["call"][1] == 9 * eigh_fl.eigh_bytes(B, m)


@pytest.mark.parametrize("trace", [False, True])
def test_eigh_train_cell_sound_run(trace, monkeypatch):
    if trace:  # the card's autograd route, whose backward opens models.eigh_bwd
        from admmnet_tpu_torch.kernels import eigh as ke
        from admmnet_tpu_torch.models import layers

        orig = layers.hermitian_eigh
        monkeypatch.setattr(ke, "_solve", lambda A: tuple(
            x.to(t) for x, t in zip(orig(A), (torch.float32, torch.complex64))))
        monkeypatch.setattr(layers, "hermitian_eigh", ke.eigh_detached)
    res = harness.run_cell(small_cell(EIGH), 2**31 + 11, 0.2, trace, torch.device("cpu"),
                           time.monotonic())
    assert res["correct"] is True, res["checks"]
    if trace:
        assert {"train_host_ms.backward", "eigh_bwd_host_ms.train"} <= set(res["metrics"])
    else:
        assert set(res["metrics"]) == {"train_step_ms", "setup_s"}


def eigh_backward(scale):
    """The gradient leaving each eigendecomposition (M_bar, the kernel's
    backward on the card) scaled: 0 zeroed, -1 negated."""

    def fault(monkeypatch):
        from admmnet_tpu_torch.models import layers

        orig = layers.hermitian_eigh

        class Scaled(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return x.view_as(x)

            @staticmethod
            def backward(ctx, g):
                return g * scale

        monkeypatch.setattr(layers, "hermitian_eigh", lambda M: orig(Scaled.apply(M)))

    fault.__name__ = f"eigh_backward_times_{scale:g}"
    return fault


def loss_half(monkeypatch):
    from admmnet_tpu_torch.train import trainer

    orig = trainer.basic_anm_loss

    def half(tau, f, conf, phi, tau_t, f_t, L, **k):
        h = tau.shape[0] // 2
        return orig(tau[:h], f[:h], conf[:h], phi[:h], tau_t[:h], f_t[:h], L[:h], **k)

    monkeypatch.setattr(trainer, "basic_anm_loss", half)


@pytest.mark.parametrize("fault", [eigh_backward(0.0), eigh_backward(-1.0), loss_half],
                         ids=lambda f: f.__name__)
def test_eigh_train_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    res = harness.run_cell(small_cell(EIGH), 2**31 + 13, 0.2, False, torch.device("cpu"),
                           time.monotonic())
    assert res["correct"] is False, res["checks"]


def test_eigh_train_control_and_reference_faults_fail_on_cpu():
    cell = small_cell(EIGH)
    driver = cell.driver()
    st = driver.setup(cell, 2**31 + 9, torch.device("cpu"), harness.Spans(False))
    verdict = driver.control(st)
    lim = cell.limits
    assert any(c["value"] > c["limit"] for c in verdict["checks"].values()), verdict["checks"]
    assert verdict["failed"] == cell.traffic["checked_steps"]
    for name, numbers in verdict["faults"].items():
        assert any(v > lim[k] for k, v in numbers.items()), (name, numbers)
