"""The frozen operation counts reproduce the kernel table's (PERF.md,
section 6): K2 at B = 8192 x 100 iterations, K4 at B = 8192, K5 and K6 at
B = 256, all at the logical side 101."""

import json

import pytest

from gpubench import harness
from gpubench.flops import classical_deploy, learned_deploy, learned_train


def test_solve_flops_k2():
    assert classical_deploy.solve_flops(8192, 100, 2, 100) == pytest.approx(3.55e13, rel=2e-3)


def test_cheb_flops_k4_k5():
    assert learned_deploy.cheb_flops(8192, 101, 48) == pytest.approx(2.38e12, rel=2e-3)
    assert learned_deploy.cheb_flops(256, 101, 48) == pytest.approx(7.4e10, rel=6e-3)


def test_cheb_bwd_flops_k6():
    assert learned_train.cheb_bwd_flops(256, 101, 48) == pytest.approx(2.23e11, rel=2e-3)


@pytest.mark.parametrize("name", [w["name"] for w in json.loads(
    (harness.ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_per_call_counts_of_every_cell(name):
    cell = harness.load_cell(name)
    counts = cell.flops().per_call(cell.config, cell.traffic)
    assert counts["call"][0] > 0
    for flops, nbytes in counts.values():
        assert flops >= 0 and nbytes >= 0
