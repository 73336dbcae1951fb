"""The per-layer metrics read from the program's own spans: traced CPU runs
of the small ``train-step`` and ``classical-single`` cells report each,
positive, and the stages of a call add up to no more than the call."""

import time

import pytest
import torch

from conftest import small_cell
from gpubench import harness, program_spans

NEW = {
    "train-step": ("train_host_ms.forward", "train_host_ms.loss", "train_host_ms.backward",
                   "train_host_ms.clip", "train_host_ms.optimizer", "loader_wait_ms.train"),
    "classical-single": ("peaks_host_ms.coarse", "peaks_host_ms.select",
                         "peaks_host_ms.refine", "solve_host_ms.single"),
}
# the stage metrics of each cell, and the span that encloses them
STAGES = {"train-step": ("train_host_ms.", "train.step"),
          "classical-single": ("peaks_host_ms.", "peaks.search")}


@pytest.mark.parametrize("name", sorted(NEW))
def test_traced_run_reports_the_program_span_metrics(name):
    cell = small_cell(name)
    declared = {m["name"] for m in cell.per_layer}
    assert set(NEW[name]) <= declared
    res = harness.run_cell(cell, 2**31 + 7, 0.3, True, torch.device("cpu"), time.monotonic())
    assert res["correct"] is True, res["checks"]
    got = res["metrics"]
    for metric in NEW[name]:
        assert got[metric]["value"] > 0, metric
        assert got[metric]["unit"] == "ms"
    prefix, enclosing = STAGES[name]
    snap = program_spans.snapshot()
    per_call_ms = 1e3 * snap[enclosing]["host_s"] / snap[enclosing]["count"]
    stages = sum(v["value"] for k, v in got.items() if k.startswith(prefix))
    assert stages <= per_call_ms
    if name == "train-step":
        # every step of the window drew one batch and ran each trunk GLayer
        steps = snap["train.step"]["count"]
        assert snap["loader.wait"]["count"] == steps
        assert snap["models.glayer_bwd"]["count"] == snap["models.glayer"]["count"]
    else:
        assert snap["solver.solve"]["count"] == snap["peaks.search"]["count"]


def test_untraced_run_and_a_program_without_spans_report_none(monkeypatch):
    res = harness.run_cell(small_cell("classical-single"), 3, 0.2, False, torch.device("cpu"),
                           time.monotonic())
    assert not set(NEW["classical-single"]) & set(res["metrics"])
    from admmnet_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "snapshot")
    assert program_spans.snapshot() == {}
    for metric in NEW["train-step"] + NEW["classical-single"]:
        reader = harness.load_module(harness.reader_path(metric))
        assert reader.read(None) is None, metric
