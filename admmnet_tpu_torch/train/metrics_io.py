"""Structured metric logging of a training run, in the JAX package's files:
``training_history.json`` (rewritten once per epoch), ``test_result.json``
(the final test metrics) and the append-only ``metrics.jsonl`` stream, so
curves survive a crash mid-run and external tools can follow progress."""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict


class MetricsWriter:
    def __init__(self, workdir):
        self.workdir = Path(workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)
        self._jsonl = self.workdir / "metrics.jsonl"

    def log(self, kind: str, **metrics: Any) -> None:
        rec = {"kind": kind, "time": time.time(), **metrics}
        with open(self._jsonl, "a") as fp:
            fp.write(json.dumps(rec) + "\n")

    def write_history(self, history: Dict[str, list]) -> None:
        with open(self.workdir / "training_history.json", "w") as fp:
            json.dump(history, fp, indent=2)

    def write_test_result(self, metrics: Dict[str, float]) -> None:
        with open(self.workdir / "test_result.json", "w") as fp:
            json.dump(metrics, fp, indent=2)
