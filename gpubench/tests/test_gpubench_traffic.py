"""The generator gives the same scenes for the same seed, and nothing the
benchmark runs loads JAX or the JAX package; the reference loads nothing
of the program either.  Module names are compared by their top-level name,
whole: the program's name begins with the JAX package's."""

import ast
import subprocess
import sys

import torch

from gpubench import traffic
from gpubench.harness import BENCH_DIR, FORBIDDEN, ROOT, PROGRAM

DATA = {"tau_range": [0.1, 0.9], "f_range": [-0.4, 0.4], "gain_std": 0.7, "snr_demod": 7.0,
        "psk_order": 4}
SPEC = {"Nb": 10, "Nd": 10, "L_max": 3}


def draw(seed, snr=(5.0, 25.0), count=64):
    g = torch.Generator().manual_seed(seed)
    return traffic.scenes(dict(DATA, snr_db=list(snr)), SPEC, count, g, torch.device("cpu"))


def test_same_seed_same_scenes():
    a, b = draw(2**31 + 5), draw(2**31 + 5)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    c = draw(2**31 + 6)
    assert not torch.equal(a["y"], c["y"])


def test_fixed_snr_and_shapes():
    s = draw(3, snr=(20.0, 20.0), count=32)
    assert s["y"].shape == (32, 100) and s["y"].dtype == torch.complex64
    assert s["tau"].shape == (32, 3) and bool(torch.all(s["L_true"] == 3))
    assert bool(torch.all((s["tau"] >= 0.1) & (s["tau"] <= 0.9)))
    assert bool(torch.all(s["sigma"] >= 1.0))


def imported_tops(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_reference_imports_nothing_of_the_program_or_jax():
    banned = set(FORBIDDEN) | {PROGRAM}
    for path in sorted((BENCH_DIR / "reference").glob("*.py")):
        assert not imported_tops(path) & banned, path.name
    code = ("import sys; sys.path.insert(0, %r); import importlib, pathlib\n"
            "for p in sorted(pathlib.Path(%r).glob('*.py')):\n"
            "    importlib.import_module('gpubench.reference.' + p.stem)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % (str(ROOT), str(BENCH_DIR / "reference")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT).stdout
    assert not set(eval(out)) & banned


def test_a_run_loads_no_jax():
    """A whole (small, CPU) run of every cell, then the loaded modules."""
    code = (
        "import sys, time; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "import torch, conftest, gpubench.run\n"
        "from gpubench import harness\n"
        "for name in ('classical-bulk', 'learned-bulk', 'train-step'):\n"
        "    harness.run_cell(conftest.small_cell(name), 7, 0.2, False, torch.device('cpu'),"
        " time.monotonic())\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))"
        % (str(ROOT), str(BENCH_DIR / "tests")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT).stdout.strip().splitlines()[-1]
    tops = set(eval(out))
    assert PROGRAM in tops
    assert not tops & set(FORBIDDEN)
