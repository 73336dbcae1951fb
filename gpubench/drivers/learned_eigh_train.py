"""Driver of upstream's training step for its published ADMM-Net: ten
layers with eigh GLayers and the attention head, trained end to end by the
program's ``train.trainer.build_steps(mode="e2e")`` at B = 256, fed by the
program's ``data.loader.PrefetchLoader`` over training rows made from the
seed.

As ``learned_train``: set-up builds the net from the configuration's
weights, its AdamW and the step, and drives them through the first
``checked_steps`` steps by the window's own call and feed, keeping the
losses, the first trunk output, the first gradient as AdamW got it and the
parameters after the last checked step; the window goes on with the same
objects.  The attention head trains with dropout, its masks drawn from a
generator on the card seeded from the run's seed, which the reference
draws again.  Once the window has closed, the reference follows the checked
steps from the same weights on the same batches with the same masks.

The cell needs the program's batched eigensolver (``kernels/eigh.py``),
as ``learned_eigh_deploy`` does."""

from __future__ import annotations

from types import SimpleNamespace

import torch

from gpubench import attention_weights
from gpubench.drivers.learned_deploy import hook_spans, program
from gpubench.drivers.learned_eigh_deploy import require_solver
from gpubench.drivers.learned_train import (  # noqa: F401  (the harness calls them)
    batches,
    end_to_end,
    first_gradient,
    make_rows,
    readings,
    reference_batches,
    release,
    step,
    verdict,
)
from gpubench.harness import ROOT
from gpubench.reference import learned_eigh_train as ref
from gpubench.reference import learned_train as train_ref
from gpubench.reference.rounding import BELOW

TRAIN_KEYS = ("batch_size", "epochs", "lr", "admm_lr_scale", "weight_decay", "grad_clip",
              "sgdr_t0", "sgdr_t_mult", "lr_min", "assignment", "spectral_weight",
              "conf_threshold")


def dropout_seed(seed: int) -> int:
    return int(seed) + 1


def build(cell, params: dict, device, spans, seed: int):
    """(model, optimizer, train_step, steps an epoch) of the program: the
    model with the configuration's weights in ``params``, the attention
    head's dropout generator seeded from ``seed``, AdamW in two groups, the
    warm-restart schedule and ``build_steps(mode="e2e")``."""
    from admmnet_tpu_torch.core.config import TrainConfig
    from admmnet_tpu_torch.train.schedules import sgdr_schedule
    from admmnet_tpu_torch.train.trainer import build_steps, make_optimizer

    tcfg = TrainConfig(**{k: cell.config["train"][k] for k in TRAIN_KEYS})
    model = program(cell, params, device)
    model.peak_head.attention.dropout_generator = torch.Generator(
        device=device).manual_seed(dropout_seed(seed))
    hook_spans(model, spans, backward=True)
    optimizer = make_optimizer(model, tcfg)
    per_epoch = cell.traffic["rows"] // cell.traffic["batch"]
    schedule = sgdr_schedule(tcfg.lr, per_epoch, tcfg.epochs, tcfg.sgdr_t0, tcfg.sgdr_t_mult,
                             tcfg.lr_min)
    train_step, _ = build_steps(model, optimizer, "e2e", schedule, grad_clip=tcfg.grad_clip,
                                assignment=tcfg.assignment,
                                spectral_weight=tcfg.spectral_weight,
                                conf_threshold=tcfg.conf_threshold)
    return model, optimizer, train_step, per_epoch


def checked_steps(st) -> None:
    """The first ``checked_steps`` steps, keeping what the comparison reads."""
    phis = []
    hook = st.model.trunk.register_forward_hook(lambda m, a, out: phis.append(out.detach()))
    for i in range(st.cell.traffic["checked_steps"]):
        step(st, i, keep=True)
        if i == 0:
            hook.remove()
            st.first_phi = phis[0]
            st.first_grad = first_gradient(st.model, st.optimizer)
    st.losses = [float(x) for x in st.losses]
    st.after = {k: v.detach().clone() for k, v in st.model.named_parameters()}


def setup(cell, seed: int, device, spans):
    require_solver(device)
    rows = make_rows(cell, seed, device)
    params = attention_weights.state_dict(ROOT / cell.config["weights"])
    model, optimizer, train_step, per_epoch = build(cell, params, device, spans, seed)
    st = SimpleNamespace(cell=cell, rows=rows, params=params, model=model,
                         optimizer=optimizer, train_step=train_step, device=device,
                         spans=spans, batch=cell.traffic["batch"], per_epoch=per_epoch,
                         dropout_seed=dropout_seed(seed), checked=[], losses=[],
                         first_phi=None, first_grad=None, after=None, step=0)
    st.stream = batches(st)
    checked_steps(st)
    return st


def run_reference(st, tiers=None, steps=None, **faults):
    """The reference's first ``steps`` checked steps (all if None) from the
    configuration's weights on the checked batches, at ``tiers`` (the
    configuration's if None)."""
    conf = st.cell.config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p0 = {k: v.to(st.device) for k, v in st.params.items()}
    return ref.run_steps(p0, reference_batches(st)[:steps], conf, st.per_epoch,
                         tiers or conf["tiers"], st.dropout_seed, **faults)


def below(st) -> dict:
    return {k: BELOW[v] for k, v in st.cell.config["tiers"].items()}


def compared_leaves(st, ref_run) -> list:
    """The leaves whose gradient and change are compared: the reference's
    first gradient worked out again a tier below the configuration's
    decides (``learned_train.steady_leaves``; the configuration's tier is
    float32, the rule's upper reading is the reference's own)."""
    low = run_reference(st, tiers=below(st), steps=1)[2]
    return train_ref.steady_leaves(ref_run[2], ref_run[2], low)


def check(st) -> dict:
    ref_run = run_reference(st)
    keep = compared_leaves(st, ref_run)
    run = (st.losses, st.first_phi, st.first_grad, st.after)
    return verdict(st.cell, readings(st, run, ref_run, keep))


def control(st) -> dict:
    """The reference one tier below the configuration's (the eigensolve,
    the rebuild, M_bar's product and the head on TF32-rounded operands) put
    in the program's place, judged as a run is; and, planted in the
    reference, the faults of half the batch left out, of a step that
    leaves the state unchanged and of the eigensolve's backward zeroed or
    negated."""
    ref_run = run_reference(st)
    keep = compared_leaves(st, ref_run)
    out = {}
    for name, kw in (("control", dict(tiers=below(st))),
                     ("half_batch", dict(half_batch=True)),
                     ("unchanged", dict(skip_update=True)),
                     ("eigh_bwd_zeroed", dict(eigh_grad=0.0)),
                     ("eigh_bwd_negated", dict(eigh_grad=-1.0))):
        out[name] = readings(st, run_reference(st, **kw), ref_run, keep)
    return {**verdict(st.cell, out["control"]), "faults": out}
