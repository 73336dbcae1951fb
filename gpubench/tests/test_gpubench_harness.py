"""The harness: the result line's keys, the refusal without a card or
without the program, and a new cell and metric found by their names
without an edit to any file the benchmark has."""

import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from conftest import small_cell
from gpubench import harness

ROOT = harness.ROOT


@pytest.mark.parametrize("name", ["classical-bulk", "classical-single", "learned-bulk",
                                  "train-step"])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(name, trace):
    res = harness.run_cell(small_cell(name), 11, 0.2, trace, torch.device("cpu"),
                           time.monotonic())
    assert list(res)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in res
    assert res["correct"] is True, res["checks"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])
    cell = harness.load_cell(name)
    want = cell.per_layer if trace else cell.end_to_end
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        # a CPU run has no device operations: no roofline, mfu or device time
        assert set(res["metrics"]) <= {m["name"] for m in want}
    else:
        assert set(res["metrics"]) == {m["name"] for m in want}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(res)


def run_cli(cwd, *extra):
    return subprocess.run([sys.executable, "gpubench/run.py", "--workload", "classical-bulk",
                           "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0", *extra],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_exits_nonzero_without_a_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = run_cli(ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_benchmark_alone_exits_nonzero(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = run_cli(tmp_path)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_new_cell_and_metric_found_by_name(tmp_path):
    """A copy of the benchmark gains a traffic file, a metric reader and
    their entries; nothing that was there changes, and a run of the new
    cell reports the new metric, and one that an existing reader reads by
    the name up to its first dot."""
    root = tmp_path / "tree"
    root.mkdir()
    shutil.copytree(ROOT / "gpubench", root / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "gpubench").rglob("*") if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    traffic = json.loads((ROOT / "gpubench/traffic/bulk8192.json").read_text())
    (root / "gpubench/traffic/bulk16.json").write_text(json.dumps(dict(traffic, batch=4, pool=8)))
    (root / "gpubench/layer_metrics/calls_traced.py").write_text(
        "def read(ctx):\n    return ctx.trace.span_count.get('call')\n")
    (root / "gpubench/limits/classical-small.json").write_text(
        (ROOT / "gpubench/limits/classical-bulk.json").read_text())
    bench["workloads"].append({"name": "classical-small", "config": "anm-admm-10x10",
                               "traffic": "bulk16", "chips": 1, "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("classical-small")
    bench["per_layer"].append({"name": "calls_traced", "unit": "calls", "better": "higher",
                               "source": "program_span", "layer": "entry",
                               "moves": "scenes_per_s", "workloads": ["classical-small"]})
    bench["per_layer"].append({"name": "mfu.small", "unit": "%", "better": "higher",
                               "source": "device_trace", "layer": "device",
                               "moves": "scenes_per_s", "workloads": ["classical-small"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys, time, json; sys.path.insert(0, %r); sys.path.append(%r)\n"
            "import torch\n"
            "from gpubench import harness\n"
            "assert harness.ROOT == __import__('pathlib').Path(%r)\n"
            "cell = harness.load_cell('classical-small')\n"
            "res = harness.run_cell(cell, 5, 0.2, True, torch.device('cpu'), time.monotonic())\n"
            "print(json.dumps(res))" % (str(root), str(ROOT), str(root)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=root, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["metrics"]["calls_traced"]["value"] > 0
    assert res["metrics"]["mfu.small"]["value"] > 0
    assert res["correct"] is True
    for p, data in before.items():
        assert p.read_bytes() == data, p
