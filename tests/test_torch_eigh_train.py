"""Upstream's training step for its published ADMM-Net (eigh GLayers, the
attention head in training mode, BasicANMLoss with slot pairing, the
global-norm clip and AdamW in two groups) through the port's
``build_steps(mode="e2e")``, against the benchmark's plain reference
(gpubench/reference/learned_eigh_train.py) on seeded random weights at a
small size: the loss of each step, every leaf's clipped gradient and the
parameters after two steps.

Two routes of the port's eigendecomposition: the CPU's own (complex128
``hermitian_eigh``, as the reference's LAPACK), and the card's autograd
function ``_EighDetached`` with the kernel's algorithm in complex64 (its
plain version, ``eigh_jacobi_plain``, in the kernel's place).

Tolerances, relative, each about ten times the reading: the complex128
route agrees with the reference to float32 rounding carried through three
layers and two AdamW steps (readings: loss 1.3e-7; a leaf's gradient 9.5e-9
and its change 6.6e-7 of the largest leaf's norm; limits 1e-6, 1e-6,
1e-5).  The complex64 Jacobi's eigenvalues carry ~1e-6 of the spectrum's
scale (tests/card_checks.py's EIGH_W_TOL reading), which reaches the
gradient (2.9e-7) and, through AdamW's sign-like first steps, the change
(5.1e-6): limits 1e-6, 1e-5, 1e-4.
The change is compared on the leaves whose gradient is at least a
thousandth of the median leaf's (``learned_train.steady_leaves``): the
others, such as the attention key's bias (the softmax over the grid does
not see it), have gradients of round-off alone, which AdamW turns into
steps of full size.
"""

import sys
from pathlib import Path

import pytest
import torch

from admmnet_tpu_torch.core.config import ModelConfig, ProblemSpec, TrainConfig
from admmnet_tpu_torch.kernels import eigh as ke
from admmnet_tpu_torch.models import ADMMNet
from admmnet_tpu_torch.train.schedules import sgdr_schedule
from admmnet_tpu_torch.train.trainer import build_steps, make_optimizer
from admmnet_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gpubench.reference import learned_eigh_train as ref  # noqa: E402
from gpubench.reference import learned_train as train_ref  # noqa: E402

SPEC = {"Nb": 4, "Nd": 4, "L_max": 2}
MODEL = {"num_layers": 3, "hidden_dim": 32, "num_heads": 4, "correction_hidden": 16,
         "value_net_hidden": 8, "scale_net_hidden": 8, "with_peak_head": True,
         "epsilon": 1e-8, "ref_stop_gradients": True, "learned_sensing": False,
         "g_mode": "eigh", "cheb_degree": 48, "head": "attention"}
TRAIN = {"batch_size": 8, "epochs": 4, "lr": 1e-3, "admm_lr_scale": 0.5, "weight_decay": 1e-3,
         "grad_clip": 1.0, "sgdr_t0": 1, "sgdr_t_mult": 2, "lr_min": 1e-6,
         "assignment": "slot", "spectral_weight": 0.0, "conf_threshold": 0.5}
CONFIG = {"spec": SPEC, "model": MODEL, "train": TRAIN,
          "tiers": {"eigh": "fp32", "rebuild": "fp32", "head": "fp32", "backward": "fp32"}}
B, STEPS, PER_EPOCH, DROPOUT_SEED = 8, 2, 3, 11
TOLS = {"complex128": (1e-6, 1e-6, 1e-5), "jacobi": (1e-6, 1e-5, 1e-4)}


def _batches():
    g = torch.Generator().manual_seed(5)
    n, L = SPEC["Nb"] * SPEC["Nd"], SPEC["L_max"]

    def cplx(*shape):
        return torch.complex(torch.randn(*shape, generator=g), torch.randn(*shape, generator=g))

    return [{"y": cplx(B, n), "b": cplx(B, n) + 1.5,
             "sigma": 1.0 + 0.5 * torch.rand(B, generator=g),
             "tau": 0.1 + 0.8 * torch.rand(B, L, generator=g),
             "f": 0.8 * torch.rand(B, L, generator=g) - 0.4,
             "L_true": torch.randint(0, L + 1, (B,), generator=g, dtype=torch.int32)}
            for _ in range(STEPS)]


def _params():
    """A seeded random net: the port's init plus noise, so the scalars
    leave their initial values."""
    torch.manual_seed(3)
    net = ADMMNet(ModelConfig(spec=ProblemSpec(**SPEC), **MODEL))
    g = torch.Generator().manual_seed(1)
    return {k: v.detach() + 0.1 * torch.randn(v.shape, generator=g)
            for k, v in net.state_dict().items()}


def _port_steps(params, batches):
    """(losses, first clipped gradient, parameters after) of the port's
    step; the dropout's generator seeded as the reference's."""
    net = ADMMNet(ModelConfig(spec=ProblemSpec(**SPEC), **MODEL))
    net.load_state_dict(params)
    net.peak_head.attention.dropout_generator = torch.Generator().manual_seed(DROPOUT_SEED)
    tcfg = TrainConfig(**TRAIN)
    opt = make_optimizer(net, tcfg)
    schedule = sgdr_schedule(tcfg.lr, PER_EPOCH, tcfg.epochs, tcfg.sgdr_t0, tcfg.sgdr_t_mult,
                             tcfg.lr_min)
    step, _ = build_steps(net, opt, "e2e", schedule, grad_clip=tcfg.grad_clip,
                          assignment="slot", spectral_weight=0.0)
    losses, first_grad = [], None
    for i, batch in enumerate(batches):
        losses.append(float(step(batch, i)))
        if first_grad is None:
            first_grad = {k: p.grad.detach().clone() for k, p in net.named_parameters()}
    return losses, first_grad, {k: p.detach().clone() for k, p in net.named_parameters()}


def _jacobi_route(monkeypatch):
    """The eigh GLayer through ``_EighDetached`` with the kernel's
    algorithm, as a CUDA tensor takes it."""
    import admmnet_tpu_torch.models.layers as layers

    monkeypatch.setattr(ke, "_solve", lambda A: ke.eigh_jacobi_plain(A.contiguous()))
    monkeypatch.setattr(layers, "hermitian_eigh", ke.eigh_detached)


def _leaf_gaps(x, r):
    """Each leaf's distance from the reference's over the largest leaf norm
    of the reference."""
    top = max(float(torch.linalg.vector_norm(v)) for v in r.values())
    return {k: float(torch.linalg.vector_norm(x[k] - r[k])) / top for k in r}


@pytest.mark.parametrize("route", ["complex128", "jacobi"])
def test_eigh_train_step_matches_the_plain_reference(route, monkeypatch):
    if route == "jacobi":
        _jacobi_route(monkeypatch)
    params, batches = _params(), _batches()
    losses, grad, after = _port_steps(params, batches)
    r_losses, _, r_grad, r_after = ref.run_steps(params, batches, CONFIG, PER_EPOCH,
                                                 CONFIG["tiers"], DROPOUT_SEED)
    loss_tol, grad_tol, step_tol = TOLS[route]
    for a, b in zip(losses, r_losses):
        assert abs(a - b) <= loss_tol * abs(b)
    assert set(grad) == set(r_grad)
    assert max(_leaf_gaps(grad, r_grad).values()) <= grad_tol
    keep = train_ref.steady_leaves(r_grad, r_grad, r_grad)
    change = {k: after[k] - params[k] for k in keep}
    r_change = {k: r_after[k] - params[k] for k in keep}
    assert max(_leaf_gaps(change, r_change).values()) <= step_tol


def test_eigh_bwd_span_in_snapshot(monkeypatch):
    """Under a profiler, one training step of the eigh net on the kernel's
    route opens ``models.eigh_bwd`` once per GLayer backward, inside
    ``models.glayer_bwd``, which covers the eigh GLayer's whole backward."""
    _jacobi_route(monkeypatch)
    params, batches = _params(), _batches()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _port_steps(params, batches[:1])
    snap = profiling.snapshot()
    glayers = MODEL["num_layers"] - 1
    assert snap["models.eigh_bwd"]["count"] == glayers
    assert snap["models.glayer_bwd"]["count"] == glayers
    assert snap["models.eigh"]["count"] == glayers
    assert 0 < snap["models.eigh_bwd"]["host_s"] <= snap["models.glayer_bwd"]["host_s"]
    assert snap["train.step"]["count"] == 1
