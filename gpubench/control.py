"""Readings for the limits of a cell's comparison: the program's and the
control's numbers on several seeds, in one process.

    python3 gpubench/control.py --workload <name> --seeds <n> [<n> ...]

For each seed the cell is set up as a run sets it up; the program then
answers every batch of the pool once through the timed path's own call,
and the control (the reference one tier below the configuration's, put in
the program's place) answers the same batches.  Both are judged by the
cell's comparison; one JSON line per seed gives each number of both.
Benchmark runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed: int, device) -> dict:
    from gpubench import harness

    driver = cell.driver()
    st = driver.setup(cell, seed, device, harness.Spans(False))
    t0 = time.perf_counter()
    for i in range(getattr(st, "slots", 0)):
        driver.step(st, i)
    program_s = time.perf_counter() - t0
    program = driver.check(st)
    t0 = time.perf_counter()
    control = driver.control(st)
    return {"seed": seed, "program_s": program_s, "control_s": time.perf_counter() - t0,
            "program": {k: c["value"] for k, c in program["checks"].items()},
            "control": {k: c["value"] for k, c in control["checks"].items()},
            "program_failed": program["failed"], "control_failed": control["failed"],
            "program_stats": program.get("stats"), "control_stats": control.get("stats"),
            "faults": control.get("faults")}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from gpubench import harness

    if not torch.cuda.is_available():
        print("gpubench.control: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, torch.device("cuda", 0))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
