"""Driver of the learned training step: the net-3 recipe's step from the
program's ``train.trainer.build_steps`` at B = 256, fed by the program's
``data.loader.PrefetchLoader`` over training rows made from the seed.

Set-up builds one model (the configuration's weights), its AdamW and the
step, and drives them through their first ``checked_steps`` steps by the
window's own call and feed: the losses, the first step's trunk output, the
first gradient as AdamW got it and the parameters after the last checked
step are kept.  The window then goes on
with the same objects.  Once it has closed, the reference follows the
checked steps from the same weights on the same batches."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from gpubench import traffic as gen
from gpubench.drivers.learned_deploy import hook_spans, load_weights, program
from gpubench.reference import learned_train as ref
from gpubench.reference.rounding import BELOW


def make_rows(cell, seed: int, device) -> dict:
    """The training rows as host numpy arrays (the loader's input)."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    data = dict(cell.config["data"], snr_db=cell.traffic["snr_db"])
    with torch.no_grad():
        sc = gen.scenes(data, cell.config["spec"], cell.traffic["rows"], g, device)
    return {k: v.cpu().numpy() for k, v in sc.items()}


def batches(st):
    """Minibatches epoch after epoch from the program's ``PrefetchLoader``,
    each epoch shuffled by its own seed, as the trainer draws them (the short
    last batch of an epoch left out)."""
    from admmnet_tpu_torch.data import loader

    if not loader.native_available():
        raise RuntimeError("the program's native loader (data/loader.py) did not build: "
                           "the cell measures its PrefetchLoader and runs no other feed")
    epoch = 0
    while True:
        yield from loader.PrefetchLoader(st.rows, st.batch, shuffle=True, seed=epoch,
                                         drop_remainder=True)
        epoch += 1


def first_gradient(model, optimizer) -> dict:
    """Each leaf's gradient as AdamW got it in its first step, worked out
    from its state: the first moment after one step is (1 - beta1) g."""
    out = {}
    for group in optimizer.param_groups:
        beta1 = group["betas"][0]
        for p in group["params"]:
            s = optimizer.state.get(p, {})
            out[p] = s["exp_avg"] / (1.0 - beta1) if "exp_avg" in s else torch.zeros_like(p)
    return {k: out[v].detach().clone() for k, v in model.named_parameters()}


def setup(cell, seed: int, device, spans):
    from admmnet_tpu_torch.core.config import TrainConfig
    from admmnet_tpu_torch.train.schedules import sgdr_schedule
    from admmnet_tpu_torch.train.trainer import build_steps, make_optimizer

    tr = cell.config["train"]
    rows = make_rows(cell, seed, device)
    params = load_weights(cell)
    model = program(cell, params, device)
    hook_spans(model, spans, backward=True)
    tcfg = TrainConfig(**{k: tr[k] for k in ("batch_size", "epochs", "lr", "admm_lr_scale",
                                             "weight_decay", "grad_clip", "sgdr_t0",
                                             "sgdr_t_mult", "lr_min", "assignment",
                                             "spectral_weight", "conf_threshold")})
    optimizer = make_optimizer(model, tcfg)
    per_epoch = cell.traffic["rows"] // cell.traffic["batch"]
    schedule = sgdr_schedule(tcfg.lr, per_epoch, tcfg.epochs, tcfg.sgdr_t0, tcfg.sgdr_t_mult,
                             tcfg.lr_min)
    train_step, _ = build_steps(model, optimizer, "e2e", schedule, grad_clip=tcfg.grad_clip,
                                assignment=tcfg.assignment,
                                spectral_weight=tcfg.spectral_weight,
                                conf_threshold=tcfg.conf_threshold)
    st = SimpleNamespace(cell=cell, rows=rows, params=params, model=model,
                         optimizer=optimizer, train_step=train_step, device=device,
                         spans=spans, batch=cell.traffic["batch"], per_epoch=per_epoch,
                         checked=[], losses=[], first_phi=None, first_grad=None,
                         after=None, step=0)
    st.stream = batches(st)
    phis = []
    hook = model.trunk.register_forward_hook(lambda m, a, out: phis.append(out.detach()))
    for i in range(cell.traffic["checked_steps"]):
        step(st, i, keep=True)
        if i == 0:
            hook.remove()
            st.first_phi = phis[0]
            st.first_grad = first_gradient(model, optimizer)
    st.losses = [float(x) for x in st.losses]
    st.after = {k: v.detach().clone() for k, v in model.named_parameters()}
    return st


def step(st, i: int, keep: bool = False) -> int:
    from admmnet_tpu_torch.train.trainer import batch_to_device

    with st.spans.span("call"):
        with st.spans.span("feed"):
            batch = next(st.stream)
            dev_batch = batch_to_device(batch, st.device)
        with st.spans.span("step"):
            loss = st.train_step(dev_batch, st.step)
    st.step += 1
    if keep:
        st.checked.append(batch)
        st.losses.append(loss)
    return 1


def end_to_end(cell, record) -> dict:
    return {"train_step_ms": 1e3 * record.window_s / record.units}


def release(st) -> None:
    st.model = st.optimizer = st.train_step = st.stream = None


def reference_batches(st):
    out = []
    for b in st.checked:
        d = {}
        for k in ("y", "b", "sigma", "tau", "f", "L_true"):
            t = torch.from_numpy(np.ascontiguousarray(b[k]))
            d[k] = (t.to(torch.complex64) if t.is_complex() else t).to(st.device)
        out.append(d)
    return out


def readings(st, run, ref_run, keep) -> dict:
    """The numbers of a set of checked steps, ``run`` = (losses, first
    phi, first gradient, parameters after), against the reference's: the
    worst step's loss, the first step's phi (the training forward's trunk
    output; over the rows both have), and by the worst of the ``keep``
    leaves the norm of the first gradient and of the parameters' change
    after the last checked step."""
    from gpubench.reference.classical_deploy import phi_gaps

    losses, first_phi, first_grad, after = run
    r_losses, r_phi, r_grad, r_after = ref_run
    n = min(first_phi.shape[0], r_phi.shape[0])
    p0 = {k: v.to(st.device) for k, v in st.params.items()}

    def change(params):
        return {k: params[k].to(st.device) - p0[k] for k in keep}

    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, r_losses)),
            "phi_gap": float(phi_gaps(first_phi[:n].to(st.device), r_phi[:n]).max()),
            "grad_gap": ref.leaf_gap({k: first_grad[k].to(st.device) for k in keep}, r_grad,
                                     keep),
            "update_gap": ref.leaf_gap(change(after), change(r_after), keep)}


def run_reference(st, fwd_tier=None, bwd_tier=None, steps=None, **faults):
    """The reference's first ``steps`` checked steps (all of them if None)
    from the configuration's weights on the checked batches."""
    conf = st.cell.config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p0 = {k: v.to(st.device) for k, v in st.params.items()}
    return ref.run_steps(p0, reference_batches(st)[:steps], conf, st.per_epoch,
                         fwd_tier or conf["tiers"]["cheb"], bwd_tier, **faults)


def compared_leaves(st, ref_run) -> list:
    """The leaves whose gradient and change are compared: the reference's
    first gradient worked out again with the Clenshaw products in float32
    and a tier below the configuration's decides (``ref.steady_leaves``)."""
    conf = st.cell.config
    above = run_reference(st, fwd_tier="fp32", steps=1)[2]
    below = run_reference(st, fwd_tier=BELOW[conf["tiers"]["cheb"]], bwd_tier="bf16",
                          steps=1)[2]
    return ref.steady_leaves(ref_run[2], above, below)


def verdict(cell, numbers: dict) -> dict:
    """The numbers beside their limits; a failed comparison fails every
    checked step."""
    lim = cell.limits
    bad = any(not v <= lim.get(k, float("nan")) for k, v in numbers.items())
    return {"checks": {k: {"value": v, "limit": lim.get(k)} for k, v in numbers.items()},
            "failed": cell.traffic["checked_steps"] if bad else 0}


def check(st) -> dict:
    ref_run = run_reference(st)
    keep = compared_leaves(st, ref_run)
    run = (st.losses, st.first_phi, st.first_grad, st.after)
    return verdict(st.cell, readings(st, run, ref_run, keep))


def control(st) -> dict:
    """The reference one tier below the configuration's (forward products
    fp8, backward products one-pass bf16) put in the program's place,
    judged as a run is; and, planted in the reference, the faults of half
    the batch left out, of a step that leaves the state unchanged and of a
    GLayer backward (K6's place) zeroed or negated."""
    conf = st.cell.config
    ref_run = run_reference(st)
    keep = compared_leaves(st, ref_run)
    out = {}
    for name, kw in (("control", dict(fwd_tier=BELOW[conf["tiers"]["cheb"]], bwd_tier="bf16")),
                     ("half_batch", dict(half_batch=True)),
                     ("unchanged", dict(skip_update=True)),
                     ("glayer_bwd_zeroed", dict(glayer_grad=0.0)),
                     ("glayer_bwd_negated", dict(glayer_grad=-1.0))):
        out[name] = readings(st, run_reference(st, **kw), ref_run, keep)
    return {"checks": {k: {"value": v, "limit": st.cell.limits.get(k)}
                       for k, v in out["control"].items()},
            "failed": 0, "faults": out}
