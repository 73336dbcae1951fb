"""Run one cell of the benchmark once and print its result line.

    python3 gpubench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell's files are found by the names in
``BENCHMARK.json`` (``gpubench/harness.py``).  With ``--trace 0`` the line
holds the cell's end-to-end metrics, with ``--trace 1`` its per-layer ones,
the profiler's busy and window seconds and a breakdown.  The numbers
compared with the reference are printed beside their limits as the last
lines on standard error and, under ``checks``, last in the result line.

Exit codes: 0 a result was printed (``correct`` may be false); 2 no CUDA
device, or fewer than the cell asks for; 3 the program is not in the
checkout; 4 a forbidden module (JAX or the JAX package) was loaded.
"""

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    os.chdir(ROOT)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    # keep libraries that can load JAX by themselves from doing so, and any
    # kernel cache at a fixed path inside the checkout (the port's own
    # builds go to build/kernels and build/native there already)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    from gpubench import harness

    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"gpubench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if not harness.program_present():
        print(f"gpubench: the program ({harness.PROGRAM}) is not in this checkout",
              file=sys.stderr)
        return 3
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"gpubench: forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct = {result['correct']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
