"""Driver of the classical deployment: host-resident scenes in, peak lists
out, through the program's ``solver.admm_solve_fixed`` and
``peaks.find_peaks``.

One call takes the next ``batch`` scenes of the pool (pinned host memory),
copies them to the card, solves, searches the peaks and copies the lists
back; the pool's batches are taken in turn.  Every call's phi (on the card)
and peak lists (on the host) are kept, and once the window has closed each
is held against the reference's for its scenes."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from gpubench import traffic as gen
from gpubench.harness import Kept, scene_verdict
from gpubench.reference import classical_deploy as ref
from gpubench.reference.rounding import BELOW

WARM_CALLS = 2
JUDGE_CHUNK = 16384  # scenes judged at once


def make_pool(cell, seed: int, device) -> dict:
    g = torch.Generator(device=device).manual_seed(int(seed))
    data = dict(cell.config["data"], snr_db=cell.traffic["snr_db"])
    with torch.no_grad():
        return gen.scenes(data, cell.config["spec"], cell.traffic["pool"], g, device)


def program(cell):
    """The program's two stages as the configuration states them."""
    from admmnet_tpu_torch.core.config import ADMMOptions, PeakSearchConfig
    from admmnet_tpu_torch.peaks import find_peaks
    from admmnet_tpu_torch.solver import admm_solve_fixed

    spec, s = cell.config["spec"], cell.config["solver"]
    opts = ADMMOptions(rho=s["rho"], g_update=s["g_update"], fused_schedule=s["schedule_name"],
                       fused_proj_iters=s["proj_iters"], fused_inner_iters=s["inner_iters"],
                       fused_warm_root=s["warm_root"], fused_final_hi=s["final_hi"])
    pcfg = PeakSearchConfig(**{k: v for k, v in cell.config["peaks"].items() if k != "tier"})

    def solve(y, b, sigma):
        return admm_solve_fixed(y, b, sigma, s["iters"], s["lambda"], opts)

    def peaks(phi):
        return tuple(find_peaks(phi, spec["Nb"], spec["Nd"], pcfg))

    return solve, peaks


def setup(cell, seed: int, device, spans):
    pool = make_pool(cell, seed, device)
    pinned = device.type == "cuda"
    host = {k: (pool[k].cpu().pin_memory() if pinned else pool[k].cpu())
            for k in ("y", "b", "sigma")}
    solve, peaks = program(cell)
    st = SimpleNamespace(cell=cell, pool=pool, host=host, solve=solve, peaks=peaks,
                         device=device, spans=spans, batch=cell.traffic["batch"],
                         slots=cell.traffic["pool"] // cell.traffic["batch"],
                         kept=Kept(cell.traffic["batch"]))
    for i in range(WARM_CALLS):
        step(st, i)
    st.kept.clear()
    return st


def step(st, i: int) -> int:
    """One call: the next batch of the pool in, the peak lists out."""
    j = i % st.slots
    sl = slice(j * st.batch, (j + 1) * st.batch)
    sp = st.spans
    with torch.no_grad(), sp.span("call"):
        with sp.span("h2d"):
            y, b, sigma = (st.host[k][sl].to(st.device, non_blocking=True)
                           for k in ("y", "b", "sigma"))
        with sp.span("solve"):
            phi = st.solve(y, b, sigma)
        with sp.span("peaks"):
            pk = st.peaks(phi)
        with sp.span("d2h"):
            st.kept.add(j, phi, pk)
    return st.batch


def end_to_end(cell, record) -> dict:
    return {"scenes_per_s": record.units / record.window_s,
            "latency_p95_ms": 1e3 * float(np.percentile(record.call_s, 95))}


def release(st) -> None:
    st.solve = st.peaks = None


def judge(st, phi, peaks, rows):
    """(phi gap, peak gap) per scene: phi against the reference solve's on
    the same scene, the peak lists against the reference search's on the
    same phi (the peak list is discontinuous in phi at near ties of the
    coarse grid, so the search is judged from the phi it was given, the
    solve from the inputs)."""
    conf = st.cell.config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    used = torch.unique(rows)
    pool = {k: st.pool[k][used.to(st.pool[k].device)] for k in ("y", "b", "sigma")}
    radius = max(conf["peaks"]["delay_step"], conf["peaks"]["doppler_step"])
    Nb, Nd = conf["spec"]["Nb"], conf["spec"]["Nd"]
    with torch.no_grad():
        phi_ref = ref.run_solve(pool["y"], pool["b"], pool["sigma"], conf, conf["solver"]["tier"])
        where = torch.searchsorted(used, rows).to(phi_ref.device)
        gp, gk = [], []
        for s in range(0, rows.numel(), JUDGE_CHUNK):
            ph = phi[s:s + JUDGE_CHUNK].to(phi_ref.device)
            pk = tuple(p[s:s + JUDGE_CHUNK] for p in peaks)
            gp.append(ref.phi_gaps(ph, phi_ref[where[s:s + JUDGE_CHUNK]]))
            gk.append(ref.peak_gaps(ph, pk, ref.run_peaks(ph, conf, conf["peaks"]["tier"]),
                                    Nb, Nd, radius))
    return torch.cat(gp).cpu(), torch.cat(gk).cpu()


def check(st) -> dict:
    rows, phi, peaks = st.kept.stacked()
    phi_gap, peak_gap = judge(st, phi, peaks, rows)
    return scene_verdict(st.cell.limits, phi_gap=phi_gap, peak_gap=peak_gap)


def control(st) -> dict:
    """The reference one tier below the configuration's (solve and refine)
    put in the program's place over every pool batch, judged as a run is."""
    conf = st.cell.config
    rows = torch.arange(st.slots * st.batch)
    with torch.no_grad():
        phi = ref.run_solve(st.pool["y"], st.pool["b"], st.pool["sigma"], conf,
                            BELOW[conf["solver"]["tier"]])
        peaks = ref.run_peaks(phi, conf, BELOW[conf["peaks"]["tier"]])
    phi_gap, peak_gap = judge(st, phi, tuple(p.cpu() for p in peaks), rows)
    return scene_verdict(st.cell.limits, phi_gap=phi_gap, peak_gap=peak_gap)
