"""The cell of upstream's published net (``learned10-eigh-bulk``) on the CPU
at small sizes: a sound run is correct and reports its metrics, each
planted fault and the control come out not correct; and the frozen counts
of the eigensolve."""

import time

import pytest
import torch

from conftest import small_cell
from gpubench import harness
from gpubench.flops import learned_eigh_deploy as fl

EIGH = "learned10-eigh-bulk"


def test_eigh_flops_and_bytes():
    """36 m^3 a matrix (Golub and Van Loan's 9 n^3, x4 complex); M in, w and
    V out; at the cell's B = 4096 and m = 101."""
    assert fl.eigh_flops(4096, 101) == pytest.approx(1.519e11, rel=1e-3)
    assert fl.eigh_bytes(4096, 101) == 4096 * (2 * 101 * 101 * 8 + 101 * 4)
    cell = harness.load_cell(EIGH)
    counts = cell.flops().per_call(cell.config, cell.traffic)
    assert counts["eigh"] == (fl.eigh_flops(4096, 101), fl.eigh_bytes(4096, 101))
    assert counts["call"][0] == pytest.approx(
        9 * (counts["eigh"][0] + counts["rebuild"][0]) + counts["head"][0])


@pytest.mark.parametrize("trace", [False, True])
def test_eigh_cell_sound_run(trace):
    res = harness.run_cell(small_cell(EIGH), 2**31 + 11, 0.2, trace, torch.device("cpu"),
                           time.monotonic())
    assert res["correct"] is True, res["checks"]
    if trace:
        assert "eigh_host_ms.deploy" in res["metrics"]
    else:
        assert set(res["metrics"]) == {"scenes_per_s", "setup_s"}


def eigenvalues_reversed(monkeypatch):
    from admmnet_tpu_torch.models import layers

    orig = layers.hermitian_eigh
    monkeypatch.setattr(layers, "hermitian_eigh",
                        lambda M: (lambda w, V: (torch.flip(w, dims=(-1,)), V))(*orig(M)))


def v_unconjugated(monkeypatch):
    from admmnet_tpu_torch.models import layers

    orig = layers.hermitian_eigh
    monkeypatch.setattr(layers, "hermitian_eigh",
                        lambda M: (lambda w, V: (w, torch.conj(V)))(*orig(M)))


def softmax_heads(monkeypatch):
    from admmnet_tpu_torch.models import peak_head

    def forward(self, x, kv):
        H, D = self.num_heads, self.head_dim
        q = self.query(x).reshape(*x.shape[:-1], H, D) / D**0.5
        k = self.key(kv).reshape(kv.shape[0], H, D)
        v = self.value(kv).reshape(kv.shape[0], H, D)
        w = torch.softmax(torch.einsum("...hd,khd->...hk", q, k), dim=-2)
        return self.out(torch.einsum("...hk,khd->...hd", w, v).reshape(*x.shape[:-1], H * D))

    monkeypatch.setattr(peak_head._Attention, "forward", forward)


@pytest.mark.parametrize("fault", [eigenvalues_reversed, v_unconjugated, softmax_heads],
                         ids=lambda f: f.__name__)
def test_eigh_cell_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    res = harness.run_cell(small_cell(EIGH), 2**31 + 13, 0.2, False, torch.device("cpu"),
                           time.monotonic())
    assert res["correct"] is False, res["checks"]


def test_eigh_cell_control_and_reference_faults_fail_on_cpu():
    cell = small_cell(EIGH)
    driver = cell.driver()
    st = driver.setup(cell, 2**31 + 9, torch.device("cpu"), harness.Spans(False))
    verdict = driver.control(st)
    lim = cell.limits
    assert any(c["value"] > c["limit"] for c in verdict["checks"].values()), verdict["checks"]
    for name, numbers in verdict["faults"].items():
        assert any(v > lim[k] for k, v in numbers.items()), (name, numbers)


@pytest.mark.cuda
def test_eigh_cell_control_fails_at_the_cells_size(cuda):
    cell = harness.load_cell(EIGH)
    for seed in (2**31 + 21, 2**31 + 22):
        st = cell.driver().setup(cell, seed, cuda, harness.Spans(False))
        verdict = cell.driver().control(st)
        assert any(c["value"] > c["limit"] for c in verdict["checks"].values())

