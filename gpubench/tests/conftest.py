"""Shared pieces of the benchmark's tests: the repository root on the path
and small copies of the cells for the CPU."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def small_cell(name: str, **traffic):
    """The cell as BENCHMARK.json defines it, its traffic cut to a size the
    CPU runs in seconds."""
    from gpubench import harness

    cell = harness.load_cell(name)
    sizes = {"deploy": {"batch": 8, "pool": 16}, "train": {"batch": 16, "rows": 48}}
    cell.traffic = dict(cell.traffic, **sizes[cell.traffic["mode"]], **traffic)
    if cell.traffic["batch"] == 1:
        cell.traffic["pool"] = 8
    return cell


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
