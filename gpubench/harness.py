"""The benchmark's machinery: a cell's files found by name, the timed window,
the profiler trace reduced to spans and idle gaps, the per-layer readers and
the result line.

Everything that belongs to one configuration, traffic mix, driver,
per-layer metric or limit sits in a file of its own, found by the name that
``BENCHMARK.json`` gives:

- ``gpubench/configs/<config>.json``: the sizes of a configuration; its
  ``pipeline`` names the driver family;
- ``gpubench/traffic/<traffic>.json``: the parameters of a traffic mix; its
  ``mode`` completes the driver's name;
- ``gpubench/drivers/<pipeline>_<mode>.py``: set-up, one timed call, the
  end-to-end numbers and the comparison with the reference;
- ``gpubench/reference/<pipeline>_<mode>.py``: the plain reference;
- ``gpubench/flops/<pipeline>_<mode>.py``: operations and bytes of a call;
- ``gpubench/layer_metrics/<metric>.py``: ``read(ctx)`` of one per-layer
  metric, ``None`` where the trace holds nothing to read; where there is
  no file of the metric's whole name, the reader of its name up to the
  first dot (``mfu.py`` reads ``mfu.deploy`` and ``mfu.train``);
- ``gpubench/limits/<cell>.json``: the limit of each number compared.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
BENCH_DIR = ROOT / "gpubench"
PROGRAM = "admmnet_tpu_torch"
# top-level module names that may not be loaded in a run (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "admmnet_tpu")

# NVIDIA H100 SXM, dense, without sparsity (NVIDIA's data sheet, 700 W):
# every roofline and mfu divides by these, whatever tier the code runs.
PEAK_FLOPS = 989e12  # bf16 tensor-core FLOP/s
PEAK_BYTES = 3.35e12  # HBM3 bytes/s

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SPAN_PREFIX = "bench:"


def load_json(path: Path):
    return json.loads(Path(path).read_text())


def load_module(path: Path, name: Optional[str] = None) -> ModuleType:
    """The Python file at ``path`` as a module of its own."""
    path = Path(path)
    spec = importlib.util.spec_from_file_location(name or f"gpubench_{path.stem}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One entry of ``workloads`` with the files it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    driver_name: str
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    def driver(self) -> ModuleType:
        return load_module(BENCH_DIR / "drivers" / f"{self.driver_name}.py")

    def flops(self) -> ModuleType:
        return load_module(BENCH_DIR / "flops" / f"{self.driver_name}.py")


def applies(metric: dict, cell_name: str, e2e_names=None) -> bool:
    """Whether a metric is reported in a cell: listed there, or, without a
    ``workloads`` key, everywhere (a per-layer metric: where the end-to-end
    metric it moves is reported)."""
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def load_cell(name: str, bench: Optional[dict] = None) -> Cell:
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = load_json(ROOT / conf_entry["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{entry['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if applies(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if applies(m, name, e2e_names)]
    limits_path = BENCH_DIR / "limits" / f"{name}.json"
    limits = load_json(limits_path) if limits_path.exists() else {}
    return Cell(name=name, chips=int(entry["chips"]), config=config, traffic=traffic,
                driver_name=f"{config['pipeline']}_{traffic['mode']}", limits=limits,
                end_to_end=e2e, per_layer=per_layer)


def program_present() -> bool:
    return (ROOT / PROGRAM / "__init__.py").exists()


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def power_limit_w() -> Optional[float]:
    """The card's power limit as nvidia-smi reads it, None where it cannot."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30).stdout
        return float(out.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


# ---- spans -------------------------------------------------------------------


class Spans:
    """``span(name)``: a ``torch.profiler.record_function`` range named
    ``bench:<name>`` in a traced run, nothing otherwise; ``begin`` / ``end``
    the same for a range opened in one hook and closed in another."""

    def __init__(self, on: bool):
        self.on = on
        self._open: Dict[str, list] = {}

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(SPAN_PREFIX + name)

    def begin(self, name: str) -> None:
        if self.on:
            rf = self.span(name)
            rf.__enter__()
            self._open.setdefault(name, []).append(rf)

    def end(self, name: str) -> None:
        if self.on and self._open.get(name):
            self._open[name].pop().__exit__(None, None, None)


# ---- the trace ---------------------------------------------------------------


@dataclass
class TraceSummary:
    busy_s: float
    window_s: float
    span_device_s: Dict[str, float] = field(default_factory=dict)
    span_count: Dict[str, int] = field(default_factory=dict)
    device_ops: List[list] = field(default_factory=list)
    idle_gaps: List[list] = field(default_factory=list)


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize_trace(events: list, window_span: str = "window") -> TraceSummary:
    """Reduce a Chrome trace's events (torch.profiler, CUPTI) to the busy
    time of the device inside the ``bench:<window_span>`` range, the device
    time of the operations launched inside each ``bench:`` span, the
    operations that took most time and the idle gaps by the innermost span
    the host was in when each began.  Times in the trace are microseconds."""
    spans: Dict[str, list] = {}
    launches = {}
    device = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat == "user_annotation" and e.get("name", "").startswith(SPAN_PREFIX):
            spans.setdefault(e["name"][len(SPAN_PREFIX):], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))))
        elif cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = float(e["ts"])
        elif cat in DEVICE_CATS:
            device.append((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                           e.get("name", cat), e.get("args", {}).get("correlation")))
    if not spans.get(window_span):
        raise ValueError(f"the trace holds no bench:{window_span} range")
    w0 = min(s for s, _ in spans[window_span])
    w1 = max(e for _, e in spans[window_span])
    inside = [(max(s, w0), min(e, w1), n, c) for s, e, n, c in device if e > w0 and s < w1]
    busy = _union([(s, e) for s, e, _, _ in inside])
    busy_us = sum(e - s for s, e in busy)

    per_name: Dict[str, float] = {}
    for s, e, n, _ in inside:
        per_name[n] = per_name.get(n, 0.0) + (e - s)
    ops = sorted(per_name.items(), key=lambda kv: -kv[1])[:10]

    index = {}
    for name, ivs in spans.items():
        ivs.sort()
        index[name] = ([s for s, _ in ivs], [e for _, e in ivs])

    def within(name, t):
        starts, ends = index[name]
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= ends[i]

    span_dev = {name: 0.0 for name in spans}
    for s, e, _, corr in inside:
        t = launches.get(corr)
        if t is None:
            continue
        for name in spans:
            if within(name, t):
                span_dev[name] += e - s

    def host_state(t):
        best = None
        for name, ivs in spans.items():
            if name == window_span or not within(name, t):
                continue
            starts, ends = index[name]
            i = bisect.bisect_right(starts, t) - 1
            width = ends[i] - starts[i]
            if best is None or width < best[1]:
                best = (name, width)
        return best[0] if best else "other host work"

    gaps: Dict[str, float] = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            k = host_state(a)
            gaps[k] = gaps.get(k, 0.0) + (b - a)
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return TraceSummary(
        busy_s=busy_us * 1e-6, window_s=(w1 - w0) * 1e-6,
        span_device_s={k: v * 1e-6 for k, v in span_dev.items()},
        span_count={k: len(v) for k, v in spans.items()},
        device_ops=[[n[:160], v * 1e-6] for n, v in ops],
        idle_gaps=[[n, v * 1e-6] for n, v in idle])


def read_trace(prof) -> TraceSummary:
    """Export the profiler's Chrome trace to a temporary file under TMPDIR,
    summarize it, delete it."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="gpubench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fp:
            events = json.load(fp)["traceEvents"]
        return summarize_trace(events)
    finally:
        os.unlink(path)


# ---- the run -----------------------------------------------------------------


@dataclass
class Record:
    """What the timed window did: calls made, units (scenes, steps)
    completed, its length, each call's host-clock seconds and how many of
    the first calls ran under the profiler."""

    calls: int
    units: int
    window_s: float
    call_s: List[float]
    traced_calls: int = 0


def timed_window(step, seconds: float, sync=None, spans: Optional[Spans] = None,
                 trace_seconds: Optional[float] = None):
    """Closed loop: ``step(i)`` returns the units it completed; calls run
    until ``seconds`` have passed since the first began, and ``sync`` (the
    device's synchronize) closes the window.  With ``spans`` on, the
    profiler traces the calls of the first ``trace_seconds`` (all of them
    if None) inside a ``bench:window`` range.  Returns (Record, the
    profiler or None); ``read_trace`` reduces the profiler's trace once the
    run is over."""
    import torch

    prof = None
    if spans is not None and spans.on:
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                  torch.profiler.ProfilerActivity.CUDA])
        prof.start()
        spans.begin("window")
    tracing = prof is not None
    traced_calls = calls = units = 0
    call_s = []
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        units += step(calls)
        t1 = time.perf_counter()
        call_s.append(t1 - t0)
        calls += 1
        done = t1 - t_start >= seconds
        if tracing and (done or (trace_seconds is not None and t1 - t_start >= trace_seconds)):
            if sync is not None:
                sync()
            spans.end("window")
            prof.stop()
            tracing, traced_calls = False, calls
        if done:
            break
    if sync is not None:
        sync()
    t_end = time.perf_counter()
    return Record(calls=calls, units=units, window_s=t_end - t_start, call_s=call_s,
                  traced_calls=traced_calls), prof


class Kept:
    """Every call's outputs of a deployment cell, in chunks allocated ahead
    (phi on the device, the answers on the host), so that keeping them adds
    no objects per call to the process.  ``add`` copies a call's answers to
    the host: that copy is the answer arriving."""

    CHUNK_SCENES = 65536

    def __init__(self, batch: int):
        self.batch = batch
        self.per_chunk = max(1, self.CHUNK_SCENES // batch)
        self.slots: List[int] = []
        self._phi: list = []
        self._answers: list = []

    def add(self, slot: int, phi, answers) -> None:
        import torch

        c, k = divmod(len(self.slots), self.per_chunk)
        if c == len(self._phi):
            self._phi.append(torch.empty((self.per_chunk, *phi.shape), dtype=phi.dtype,
                                         device=phi.device))
            self._answers.append(tuple(torch.empty((self.per_chunk, *a.shape), dtype=a.dtype)
                                       for a in answers))
        self._phi[c][k].copy_(phi)
        for dst, a in zip(self._answers[c], answers):
            dst[k].copy_(a)
        self.slots.append(slot)

    def clear(self) -> None:
        """Forget the calls, keep the chunks."""
        self.slots = []

    def calls(self):
        """(pool slot, phi, answers) of each call, in order."""
        for i, slot in enumerate(self.slots):
            c, k = divmod(i, self.per_chunk)
            yield slot, self._phi[c][k], tuple(a[k] for a in self._answers[c])

    def stacked(self):
        """(pool row of each scene, phi, answers), every call's scenes in a
        row."""
        import torch

        n = len(self.slots) * self.batch
        slots = torch.tensor(self.slots, dtype=torch.int64)
        rows = (slots[:, None] * self.batch + torch.arange(self.batch)).reshape(-1)
        phi = torch.cat([p.reshape(-1, p.shape[-1]) for p in self._phi])[:n]
        answers = tuple(torch.cat([a[i].reshape(-1, *a[i].shape[2:]) for a in self._answers])[:n]
                        for i in range(len(self._answers[0])))
        return rows, phi, answers


def scene_verdict(limits: dict, **gaps) -> dict:
    """The numbers compared of a deployment cell: each per-scene gap's worst
    scene beside its limit, the scenes that fail any, and each gap's median
    and 99th percentile (``control.py`` prints them)."""
    import torch

    bad = None
    checks, stats = {}, {}
    for name, g in gaps.items():
        g = g.to(torch.float64)
        over = ~(g <= limits.get(name, float("nan")))
        bad = over if bad is None else bad | over
        checks[name] = {"value": float(g.max()), "limit": limits.get(name)}
        q = torch.quantile(g, torch.tensor([0.5, 0.99], dtype=torch.float64))
        stats[name] = {"median": float(q[0]), "p99": float(q[1]), "n": int(g.numel())}
    return {"checks": checks, "failed": int(bad.sum()), "stats": stats}


def roofline_pct(flops: float, nbytes: float, seconds: float) -> Optional[float]:
    """Share of the least time the card could take (operations at the bf16
    peak or bytes at the HBM peak, the larger) in ``seconds``, in %."""
    if not seconds or seconds <= 0:
        return None
    return 100.0 * max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES) / seconds


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float) -> dict:
    """One run of a cell: set-up, the timed window, the trace reduced, the
    program's state freed, then the comparison with the reference.  ``t0``
    is the process's start on ``time.monotonic``'s clock."""
    import torch

    cuda = device.type == "cuda"
    driver = cell.driver()
    spans = Spans(trace)
    state = driver.setup(cell, seed, device, spans)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.monotonic() - t0
    record, prof = timed_window(lambda i: driver.step(state, i), seconds,
                                torch.cuda.synchronize if cuda else None,
                                spans if trace else None, cell.traffic.get("trace_seconds"))
    memory_peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    summary = read_trace(prof) if prof is not None else None
    driver.release(state)
    if cuda:
        torch.cuda.empty_cache()
    verdict = driver.check(state)

    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": memory_peak}
    if cuda:
        dev["power_limit_w"] = power_limit_w()
    result = {"correct": None, "attempted": record.units, "failed": verdict["failed"]}
    if trace:
        fl = cell.flops().per_call(cell.config, cell.traffic)
        ctx = SimpleNamespace(cell=cell, record=record, trace=summary, per_call=fl,
                              peak_flops=PEAK_FLOPS, peak_bytes=PEAK_BYTES)
        result["metrics"] = read_layer_metrics(cell, ctx)
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        result["device"] = dev
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    else:
        values = dict(driver.end_to_end(cell, record), setup_s=setup_s)
        result["metrics"] = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                             for m in cell.end_to_end}
        result["device"] = dev
    checks = verdict["checks"]
    result["correct"] = bool(checks) and all(
        c["limit"] is not None and c["value"] == c["value"] and c["value"] <= c["limit"]
        for c in checks.values()) and verdict["failed"] == 0
    result["checks"] = checks
    return result


def reader_path(name: str) -> Path:
    """The reader of a per-layer metric: the file of its whole name, else
    that of its name up to the first dot."""
    path = BENCH_DIR / "layer_metrics" / f"{name}.py"
    return path if path.exists() else BENCH_DIR / "layer_metrics" / f"{name.split('.')[0]}.py"


def read_layer_metrics(cell: Cell, ctx) -> Dict[str, dict]:
    out = {}
    for i, m in enumerate(cell.per_layer):
        path = reader_path(m["name"])
        value = load_module(path, f"gpubench_metric_{i}").read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
