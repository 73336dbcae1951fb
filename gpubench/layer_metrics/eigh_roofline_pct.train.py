"""Share of the eigensolver's roofline in the training step's eigh GLayer
forwards: ``eigh_roofline_pct.deploy``'s reading (the fixed count of an
eigensolve of the batch times the ``glayer`` spans of the traced window,
over the device time of the operations named ``eigh_jacobi``), in %."""

from gpubench.harness import BENCH_DIR, load_module

read = load_module(BENCH_DIR / "layer_metrics" / "eigh_roofline_pct.deploy.py",
                   "gpubench_metric_eigh_roofline_pct_deploy").read
