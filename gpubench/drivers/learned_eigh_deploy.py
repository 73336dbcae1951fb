"""Driver of upstream's published ADMM-Net deployment: host-resident scenes
in, (tau, f, confidence) out, through the program's ``models.ADMMNet``
forward (ten layers, eigh GLayers, the attention head) with the
configuration's weights.

A call is ``learned_deploy``'s: the next ``batch`` scenes of the pool
(pinned host memory) copied to the card, the net on the whole batch (the
ZLayer's batch mean makes the batch part of the input), phi kept on the
card and the answers copied back.  Once the window has closed, each call's
phi is held against the reference trunk's on the same batch (both from the
inputs), and its answers against the reference head's on that call's own
phi.  phi and the head's outputs are compared, never eigenvectors: inside a
cluster of near-equal eigenvalues V is not unique, V f(w) V^H is.

The cell needs the program's batched eigensolver (``kernels/eigh.py``): a
program without it solves each eigenproblem on its own (36,864 a call),
minutes a call, so set-up refuses such a program at once."""

from __future__ import annotations

from types import SimpleNamespace

import torch

from gpubench import attention_weights
from gpubench.drivers.classical_deploy import make_pool
from gpubench.drivers.learned_deploy import (  # noqa: F401  (the harness calls them)
    end_to_end,
    hook_spans,
    program,
    release,
    step,
)
from gpubench.harness import ROOT, Kept, scene_verdict
from gpubench.reference import learned_deploy as ref_common
from gpubench.reference import learned_eigh_deploy as ref
from gpubench.reference.rounding import BELOW

WARM_CALLS = 2


def require_solver(device) -> None:
    if device.type != "cuda":
        return
    import importlib.util

    if importlib.util.find_spec("admmnet_tpu_torch.kernels.eigh") is None:
        raise RuntimeError("the program has no batched eigensolver (kernels/eigh.py): its eigh "
                           "GLayer would solve each of a call's 36,864 eigenproblems alone")


def setup(cell, seed: int, device, spans):
    require_solver(device)
    pool = make_pool(cell, seed, device)
    pinned = device.type == "cuda"
    host = {k: (pool[k].cpu().pin_memory() if pinned else pool[k].cpu())
            for k in ("y", "b", "sigma")}
    params = attention_weights.state_dict(ROOT / cell.config["weights"])
    net = program(cell, params, device)
    hook_spans(net, spans)
    st = SimpleNamespace(cell=cell, pool=pool, host=host, net=net, params=params,
                         device=device, spans=spans, batch=cell.traffic["batch"],
                         slots=cell.traffic["pool"] // cell.traffic["batch"],
                         kept=Kept(cell.traffic["batch"]))
    for i in range(WARM_CALLS):
        step(st, i)
    st.kept.clear()
    return st


def judge(st, kept, fault=None):
    """(phi gap, head gap) per scene of ``kept``, (slot, phi, answers) a call,
    against the reference at the configuration's tiers (``fault`` planted in
    the reference: the tests' stand-in for a faulty program)."""
    conf = st.cell.config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p = {k: v.to(st.device) for k, v in st.params.items()}
    phi_ref = {}
    gp, gh = [], []
    with torch.no_grad():
        for j, phi, out in kept:
            if j not in phi_ref:
                sl = slice(j * st.batch, (j + 1) * st.batch)
                phi_ref[j] = ref.trunk(st.pool["y"][sl], st.pool["b"][sl], st.pool["sigma"][sl],
                                       p, conf, conf["tiers"])
            out_ref = ref.head(phi, p, conf, conf["tiers"]["head"])
            a, c = ref_common.gaps(phi, out, phi_ref[j], out_ref)
            gp.append(a)
            gh.append(c)
    return torch.cat(gp).cpu(), torch.cat(gh).cpu()


def check(st) -> dict:
    phi_gap, head_gap = judge(st, st.kept.calls())
    return scene_verdict(st.cell.limits, phi_gap=phi_gap, head_gap=head_gap)


def stand_in(st, tiers: dict, fault=None) -> list:
    """Every pool batch answered by the reference at ``tiers`` (with
    ``fault``) in the program's place, as kept calls."""
    conf = st.cell.config
    p = {k: v.to(st.device) for k, v in st.params.items()}
    kept = []
    with torch.no_grad():
        for j in range(st.slots):
            sl = slice(j * st.batch, (j + 1) * st.batch)
            phi = ref.trunk(st.pool["y"][sl], st.pool["b"][sl], st.pool["sigma"][sl], p, conf,
                            tiers, fault)
            out = ref.head(phi, p, conf, tiers["head"], fault)
            kept.append((j, phi, tuple(x.cpu() for x in out)))
    return kept


def control(st) -> dict:
    """The reference one tier below the configuration's (the eigensolve and
    the rebuild on TF32-rounded operands, the head's products TF32) put in
    the program's place on every pool batch, judged as a run is; and, in
    the same place, the reference with each planted fault."""
    tiers = {k: BELOW[v] for k, v in st.cell.config["tiers"].items()}
    out = scene_verdict(st.cell.limits, **dict(zip(("phi_gap", "head_gap"),
                                                   judge(st, stand_in(st, tiers)))))
    faults = {}
    for fault in ("eigenvalues_reversed", "v_unconjugated", "softmax_heads"):
        v = scene_verdict(st.cell.limits, **dict(zip(
            ("phi_gap", "head_gap"), judge(st, stand_in(st, st.cell.config["tiers"], fault)))))
        faults[fault] = {k: c["value"] for k, c in v["checks"].items()}
    out["faults"] = faults
    return out
