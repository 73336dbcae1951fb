"""The port's spans (``utils.profiling``): nothing but one check while no
profiler records; under ``torch.profiler`` an ``admmnet:<name>`` range in
the trace and a count and host seconds in the registry, for the newest
session only; the spans the trainer, the loader, the peak search, the solve
and the GLayer open; the kernels' launch counters beside them."""

import contextlib
import json
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import admmnet_tpu_torch.core.config as tcfg
from admmnet_tpu_torch.data import loader
from admmnet_tpu_torch.data.generator import generate_batch
from admmnet_tpu_torch.models import ADMMNet
from admmnet_tpu_torch.models.layers import GLayer
from admmnet_tpu_torch.peaks import find_peaks
from admmnet_tpu_torch.solver import admm_solve_fixed
from admmnet_tpu_torch.train.trainer import batch_to_device, build_steps, make_optimizer
from admmnet_tpu_torch.utils import profiling

SPEC = tcfg.ProblemSpec(Nb=4, Nd=4, L_max=2)
TRAIN_STAGES = ("train.forward", "train.loss", "train.backward", "train.clip",
                "train.optimizer")


@contextlib.contextmanager
def profiled():
    """A CPU profiling session whose registry starts afresh: a span with no
    profiler recording comes first, as a run's set-up calls do."""
    with profiling.span("idle"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        yield prof


def spans():
    """The registry's spans (the launch counters left out)."""
    return {k: v for k, v in profiling.snapshot().items() if not k.startswith("launches.")}


def scenes(n, seed=0):
    return generate_batch(tcfg.DataConfig(spec=SPEC), n, torch.Generator().manual_seed(seed),
                          "cpu")


def tiny_steps():
    torch.manual_seed(0)
    cfg = tcfg.ModelConfig(spec=SPEC, num_layers=2, hidden_dim=16, g_mode="chebyshev",
                           cheb_impl="pallas", cheb_degree=8, head="spectrum")
    model = ADMMNet(cfg)
    opt = make_optimizer(model, tcfg.TrainConfig())
    return build_steps(model, opt, "e2e", lambda step: 1e-3, assignment="perm")


def test_span_off_is_one_check_and_opens_no_range(monkeypatch):
    with profiled():
        with profiling.span("before"):
            pass
    before = profiling.snapshot()
    checks = []

    def counted():
        checks.append(1)
        return torch.autograd._profiler_enabled()

    def no_range(name):
        raise AssertionError(f"a range was opened for {name}")

    monkeypatch.setattr(profiling, "_profiler_enabled", counted)
    monkeypatch.setattr(profiling, "_record_function", no_range)
    with profiling.span("off"):
        pass
    profiling.end(profiling.begin("off"))
    assert len(checks) == 2
    assert profiling.snapshot() == before


def test_train_step_records_each_stage_once():
    train_step, eval_step = tiny_steps()
    batch = batch_to_device(scenes(8), "cpu")
    with profiled():
        train_step(batch, 0)
    got = spans()
    assert got["train.step"]["count"] == 1
    for name in TRAIN_STAGES:
        assert got[name]["count"] == 1, name
    assert sum(got[n]["host_s"] for n in TRAIN_STAGES) <= got["train.step"]["host_s"]
    assert not any(k.startswith("eval.") for k in got)
    # the GLayers' forward and backward (one of each a depth the trunk runs)
    assert got["models.glayer"]["count"] == got["models.glayer_bwd"]["count"] == 1
    with profiled():
        eval_step(batch)
    got = spans()
    assert got["eval.step"]["count"] == got["eval.forward"]["count"] == 1
    assert not any(k.startswith("train.") for k in got)


def test_ranges_nest_in_the_chrome_trace(tmp_path):
    train_step, _ = tiny_steps()
    batch = batch_to_device(scenes(8), "cpu")
    with profiled() as prof:
        with record_function("bench:step"):
            train_step(batch, 0)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    outer = next(e for e in events if e["name"] == "bench:step")
    ours = {e["name"]: e for e in events if e["name"].startswith(profiling.SPAN_PREFIX)}
    assert {profiling.SPAN_PREFIX + n for n in ("train.step",) + TRAIN_STAGES} <= set(ours)
    for e in ours.values():
        assert e["cat"] == "user_annotation"
        assert outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]
    step = ours[profiling.SPAN_PREFIX + "train.step"]
    for n in TRAIN_STAGES:
        e = ours[profiling.SPAN_PREFIX + n]
        assert step["ts"] <= e["ts"] and e["ts"] + e["dur"] <= step["ts"] + step["dur"]


def test_find_peaks_and_solve_record_their_stages():
    d = scenes(3, seed=1)
    y, b, sigma = (torch.from_numpy(d[k]) for k in ("y", "b", "sigma"))
    with profiled():
        for _ in range(2):
            phi = admm_solve_fixed(y, b, sigma, 2)
            find_peaks(phi, SPEC.Nb, SPEC.Nd)
    got = spans()
    assert got["solver.solve"]["count"] == 2
    for name in ("peaks.search", "peaks.coarse", "peaks.select", "peaks.refine"):
        assert got[name]["count"] == 2, name
    stages = sum(got[f"peaks.{n}"]["host_s"] for n in ("coarse", "select", "refine"))
    assert stages <= got["peaks.search"]["host_s"]


def test_prefetch_loader_records_one_wait_a_batch():
    if not loader.native_available():
        pytest.skip("the native loader did not build")
    data = {"x": np.arange(70, dtype=np.float32).reshape(35, 2),
            "L_true": np.arange(35, dtype=np.int32)}
    with profiled():
        batches = list(loader.PrefetchLoader(data, 8, shuffle=True, seed=3))
    assert len(batches) == 5
    assert spans()["loader.wait"]["count"] == 5


def test_glayer_forward_and_backward_spans():
    torch.manual_seed(0)
    layer = GLayer(SPEC.Nb * SPEC.Nd, mode="chebyshev", cheb_impl="pallas", cheb_degree=8)
    n = SPEC.Nb * SPEC.Nd
    phi = torch.randn(2, n, dtype=torch.complex64)
    h = torch.rand(2, n)
    Z = torch.zeros(2, n + 1, n + 1, dtype=torch.complex64)
    with profiled():
        G = layer(phi, h, Z)
        torch.sum(torch.abs(G)).backward()
    got = spans()
    assert got["models.glayer"]["count"] == 1
    assert got["models.glayer_bwd"]["count"] == 1


def test_a_new_session_starts_afresh(tmp_path):
    with profiled():
        for _ in range(3):
            with profiling.span("first"):
                pass
    assert set(spans()) == {"first"} and spans()["first"]["count"] == 3
    with profiling.span("between"):  # no profiler: nothing recorded, the session over
        pass
    assert set(spans()) == {"first"}
    with profile(activities=[ProfilerActivity.CPU]):
        token = profiling.begin("second")
        profiling.end(token)
    assert set(spans()) == {"second"} and spans()["second"]["count"] == 1
    # profiling.trace starts a session of its own, with no span in between
    with profiling.trace(str(tmp_path)):
        with profiling.span("third"):
            pass
    assert set(spans()) == {"third"}


def test_snapshot_reports_every_kernel_launch_counter():
    from admmnet_tpu_torch.kernels import cheb_filter, fused_admm, fused_admm_fast, polar

    counters = {"K1": polar.launches, "K2": fused_admm_fast.launches,
                "K3": fused_admm_fast.lists_launches, "K4": cheb_filter.launches,
                "K5": cheb_filter.fwd_launches, "K6": cheb_filter.bwd_launches,
                "K7": fused_admm.launches}
    snap = profiling.snapshot()
    for kernel, counter in counters.items():
        assert snap[f"launches.{kernel}"] == {"count": counter.count}


def test_registry_counts_every_span_of_many_threads():
    """Spans closing on several threads at once (as a backward's do on the
    autograd engine's) lose no count."""
    threads, per_thread = 16, 400
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiled():
            profiling.end(profiling.begin("start"))

            def work():
                for _ in range(per_thread):
                    profiling._close(profiling._open("hammered"))

            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)
    assert spans()["hammered"]["count"] == threads * per_thread
    assert spans()["start"]["count"] == 1
