"""Driver of the learned deployment: host-resident scenes in, (tau, f,
confidence) out, through the program's ``models.ADMMNet`` forward (trunk and
spectrum head) with the configuration's weights.

One call takes the next ``batch`` scenes of the pool (pinned host memory),
copies them to the card, runs the net on the whole batch (the ZLayer's
batch mean makes the batch part of the input) and copies the answers back;
the pool's batches are taken in turn.  Every call's phi (on the card) and
answers (on the host) are kept.  Once the window has closed, each call's
phi is held against the reference trunk's on the same batch, and its
answers against the reference head's on that call's own phi: the head's
top-k is discontinuous at near ties, so it is judged from the trunk's
output it was given, the trunk from the inputs."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from gpubench import weights
from gpubench.drivers.classical_deploy import make_pool
from gpubench.harness import ROOT, Kept, scene_verdict
from gpubench.reference import learned_deploy as ref
from gpubench.reference.rounding import BELOW

WARM_CALLS = 2


def load_weights(cell) -> dict:
    return weights.state_dict(ROOT / cell.config["weights"])


def program(cell, params: dict, device):
    """The program's net with the configuration's weights, in eval mode."""
    from admmnet_tpu_torch.core.config import ModelConfig, ProblemSpec
    from admmnet_tpu_torch.models import ADMMNet

    cfg = ModelConfig(spec=ProblemSpec(**cell.config["spec"]), **cell.config["model"])
    net = ADMMNet(cfg)
    net.load_state_dict(params)
    return net.to(device).eval()


def glayers(net):
    from admmnet_tpu_torch.models.layers import GLayer

    return [m for m in net.modules() if isinstance(m, GLayer)]


def hook_spans(net, spans, backward: bool = False):
    """``glayer`` spans around each GLayer forward (and ``glayer_bwd``
    around its backward) when the run is traced."""
    if not spans.on:
        return
    for m in glayers(net):
        m.register_forward_pre_hook(lambda *_: spans.begin("glayer"))
        m.register_forward_hook(lambda *_: spans.end("glayer"))
        if backward:
            m.register_full_backward_pre_hook(lambda *_: spans.begin("glayer_bwd"))
            m.register_full_backward_hook(lambda *_: spans.end("glayer_bwd"))


def setup(cell, seed: int, device, spans):
    pool = make_pool(cell, seed, device)
    pinned = device.type == "cuda"
    host = {k: (pool[k].cpu().pin_memory() if pinned else pool[k].cpu())
            for k in ("y", "b", "sigma")}
    params = load_weights(cell)
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


def step(st, i: int) -> int:
    j = i % st.slots
    sl = slice(j * st.batch, (j + 1) * st.batch)
    sp = st.spans
    with torch.no_grad(), sp.span("call"):
        with sp.span("h2d"):
            y, b, sigma = (st.host[k][sl].to(st.device, non_blocking=True)
                           for k in ("y", "b", "sigma"))
        with sp.span("net"):
            tau, f, conf, phi = st.net(y, b, sigma)
        with sp.span("d2h"):
            st.kept.add(j, phi, (tau, f, conf))
    return st.batch


def end_to_end(cell, record) -> dict:
    # both deployment metrics, so that a cell of another traffic mix (one
    # scene a request) needs a traffic file alone
    return {"scenes_per_s": record.units / record.window_s,
            "latency_p95_ms": 1e3 * float(np.percentile(record.call_s, 95))}


def release(st) -> None:
    st.net = None


def reference_params(st) -> dict:
    return {k: v.to(st.device) for k, v in st.params.items()}


def judge(st, kept):
    """(phi gap, head gap) per scene of ``kept``, (slot, phi, answers) a call,
    against the reference at the configuration's tiers."""
    conf = st.cell.config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p = reference_params(st)
    phi_ref = {}
    gp, gh = [], []
    with torch.no_grad():
        for j, phi, out in kept:
            if j not in phi_ref:
                sl = slice(j * st.batch, (j + 1) * st.batch)
                phi_ref[j] = ref.trunk(st.pool["y"][sl], st.pool["b"][sl], st.pool["sigma"][sl],
                                       p, conf, conf["tiers"]["cheb"])
            out_ref = ref.head(phi, p, conf, conf["tiers"]["head"])
            a, c = ref.gaps(phi, out, phi_ref[j], out_ref)
            gp.append(a)
            gh.append(c)
    return torch.cat(gp).cpu(), torch.cat(gh).cpu()


def check(st) -> dict:
    phi_gap, head_gap = judge(st, st.kept.calls())
    return scene_verdict(st.cell.limits, phi_gap=phi_gap, head_gap=head_gap)


def control(st) -> dict:
    """The reference one tier below the configuration's (trunk and head) put
    in the program's place on every pool batch, judged as a run is."""
    conf = st.cell.config
    cheb_c, head_c = BELOW[conf["tiers"]["cheb"]], BELOW[conf["tiers"]["head"]]
    p = reference_params(st)
    kept = []
    with torch.no_grad():
        for j in range(st.slots):
            sl = slice(j * st.batch, (j + 1) * st.batch)
            phi = ref.trunk(st.pool["y"][sl], st.pool["b"][sl], st.pool["sigma"][sl], p, conf,
                            cheb_c)
            kept.append((j, phi, tuple(x.cpu() for x in ref.head(phi, p, conf, head_c))))
    phi_gap, head_gap = judge(st, kept)
    return scene_verdict(st.cell.limits, phi_gap=phi_gap, head_gap=head_gap)
