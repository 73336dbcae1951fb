"""The port's host-boundary helpers (``utils/host.py``) and device retries
(``utils/retry.py``), with the checks of ``tests/test_host_utils.py`` and
against the JAX package's retry classification."""

import numpy as np
import pytest
import torch

from admmnet_tpu.utils import retry as jretry
from admmnet_tpu_torch.utils import cjit, retry, to_device, to_host

MESSAGES = [
    "UNAVAILABLE: worker restarting", "TPU worker process crashed or restarted",
    "DEADLINE_EXCEEDED", "INTERNAL: remote compile", "Socket closed",
    "TPU backend error (FailedPrecondition)", "FAILED_PRECONDITION: buffer donated",
    "CUDA error: an illegal memory access was encountered", "shape mismatch",
]


def test_cjit_roundtrips_complex_args():
    y = (np.arange(6) + 1j * np.ones(6)).astype(np.complex64)

    @cjit(device="cpu")
    def f(y, scale):
        assert isinstance(y, torch.Tensor) and y.dtype == torch.complex64
        return torch.abs(y) * scale, y * 2

    mag, doubled = f(y, np.float32(2.0))
    np.testing.assert_allclose(mag.numpy(), 2 * np.abs(y), rtol=1e-6)
    np.testing.assert_allclose(to_host(doubled), 2 * y, rtol=1e-6)
    g = cjit(lambda a: a.device.type, device="cpu")
    assert g(np.ones(2)) == "cpu"


def test_to_host_handles_mixed_tree():
    tree = {"a": torch.ones(3), "b": (torch.tensor([1 + 2j]), 5), "c": [torch.ones(2).conj()]}
    host = to_host(tree)
    np.testing.assert_allclose(host["a"], 1.0)
    np.testing.assert_allclose(host["b"][0], [1 + 2j])
    assert host["b"][1] == 5 and isinstance(host["b"], tuple) and isinstance(host["c"][0],
                                                                             np.ndarray)


def test_to_device_and_back():
    rng = np.random.default_rng(0)
    x = {"phi": (rng.normal(size=4) + 1j * rng.normal(size=4)).astype(np.complex64),
         "n": 3, "t": torch.zeros(2)}
    dev = to_device(x, "cpu")
    assert isinstance(dev["phi"], torch.Tensor) and dev["phi"].is_complex() and dev["n"] == 3
    np.testing.assert_array_equal(to_host(dev)["phi"], x["phi"])


@pytest.mark.parametrize("msg", MESSAGES)
def test_is_retryable_matches_jax(msg):
    exc = RuntimeError(msg)
    assert retry.is_retryable(exc) == jretry.is_retryable(exc)


def test_device_retry_retries_transient_failures_only():
    calls, logs = [], []

    @retry.device_retry(attempts=3, cooldown_s=0.0, log_fn=logs.append)
    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("UNAVAILABLE: worker restarting")
        return 7

    assert flaky() == 7 and len(calls) == 3 and len(logs) == 2

    def broken():
        calls.append(1)
        raise ValueError("shape mismatch")

    calls.clear()
    with pytest.raises(ValueError):
        retry.device_retry(broken, cooldown_s=0.0, log_fn=logs.append)()
    assert len(calls) == 1

    def down():
        calls.append(1)
        raise RuntimeError("Socket closed")

    calls.clear()
    with pytest.raises(RuntimeError, match="Socket closed"):
        retry.device_retry(down, attempts=2, cooldown_s=0.0, log_fn=logs.append)()
    assert len(calls) == 2


class _FlakyNet(torch.nn.Module):
    """phi = w y, failing with a transient device error on chosen calls."""

    def __init__(self, fail_on):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor(0.5))
        self.fail_on, self.calls = set(fail_on), 0

    def forward(self, y, b, sigma):
        self.calls += 1
        if self.calls in self.fail_on:
            raise RuntimeError("UNAVAILABLE: worker restarting")
        return self.w * y


def test_trainer_retries_the_steps_but_not_the_update(monkeypatch):
    """The train step's forward fails once: the gradients are recomputed
    and the update applied once, as in a run without the failure; the eval
    step is retried too."""
    import functools

    from admmnet_tpu_torch.train import trainer

    monkeypatch.setattr(trainer, "device_retry",
                        functools.partial(retry.device_retry, cooldown_s=0.0))
    rng = np.random.default_rng(1)
    y = torch.from_numpy((rng.normal(size=(4, 6)) + 1j * rng.normal(size=(4, 6))).astype(
        np.complex64))
    batch = {"y": y, "b": y, "sigma": torch.ones(4), "phi": 0.8 * y}
    ws, logs = [], []
    for fail_on in ((), (1, 3)):
        net = _FlakyNet(fail_on)
        opt = torch.optim.AdamW([{"params": [net.w], "scale": 1.0}], lr=0.1)
        train_step, eval_step = trainer.build_steps(net, opt, "phi", lambda s: 0.1,
                                                    log_fn=logs.append)
        loss = train_step(batch, 0)
        total, _ = eval_step(batch)
        ws.append((net.w.item(), float(loss), float(total)))
    assert ws[0] == ws[1] and len(logs) == 2
