"""Port parity: the remaining surface -- the analysis, scaling and MATLAB
CLIs, the plot flags and ``utils.plotting``, ``utils.profiling``,
``utils.debug`` and the port's own ``ops.fit_polar_schedule``.

The checks are those of the JAX package's own tests
(tests/test_cli_extra.py, tests/test_cli.py::test_plotting_writes_files,
tests/test_aux.py, tests/test_polar.py), run on the port, with the JAX
package's outputs beside the port's where both print numbers.  Every CLI
runs with ``--device cpu`` or ``--force-cpu``.
"""

import json

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # JAX and torch share the cores of one test worker

ROOT = __import__("pathlib").Path(__file__).resolve().parent.parent


def test_analyze_times_cli(tmp_path, capsys):
    from admmnet_tpu.cli.analyze_times import analyze as janalyze
    from admmnet_tpu_torch.cli.analyze_times import analyze, main

    f1, f2 = tmp_path / "a.txt", tmp_path / "b.txt"
    np.savetxt(f1, np.full(10, 0.5))
    np.savetxt(f2, np.random.default_rng(0).uniform(0.05, 0.15, 10))
    main([str(f1), str(f2), "--labels", "ADMM", "Net", "--plot", str(tmp_path / "fig")])
    out = capsys.readouterr().out
    assert "speedup ADMM / Net:" in out
    assert (tmp_path / "fig" / "time_cdf.png").exists()
    assert (tmp_path / "fig" / "mean_times.png").exists()
    for r, j in zip(analyze([f1, f2]), janalyze([f1, f2])):
        assert {k: v for k, v in r.items() if k != "times"} == {
            k: v for k, v in j.items() if k != "times"}


def test_bench_scaling_cli_on_cpu_shards(capsys):
    from admmnet_tpu_torch.cli.bench_scaling import main

    main(["--force-cpu", "2", "--devices", "1", "2", "--batch-per-device", "4", "--iters",
          "2", "--json"])
    rows = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rows[0]["devices"] == 1 and rows[1]["devices"] == 2
    assert rows[0]["efficiency"] == 1.0
    assert all(r["throughput_iters_per_s"] > 0 for r in rows)


def test_peaks_from_mat_cli(tmp_path, capsys):
    import scipy.io as sio

    from admmnet_tpu.cli.peaks_from_mat import main as jmain
    from admmnet_tpu_torch.cli.peaks_from_mat import main
    from admmnet_tpu_torch.ops.atoms import atom

    phi = atom(0.33, -0.21, 10, 10).numpy().reshape(-1, 1)
    f = tmp_path / "phi_ad.mat"
    sio.savemat(f, {"phi_ad": phi})
    main([str(f), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[0.33" in out and "-0.21" in out
    jmain([str(f)])
    jout = capsys.readouterr().out
    top, jtop = (np.array(o.splitlines()[1].split("[")[1].rstrip("]").split(", "), float)
                 for o in (out, jout))
    np.testing.assert_allclose(top, jtop, atol=2e-4, rtol=1e-4)


def test_plotting_writes_files(tmp_path):
    import os

    from admmnet_tpu_torch.ops.atoms import atom
    from admmnet_tpu_torch.utils.plotting import plot_peaks, plot_predictions_vs_truth

    phi = atom(0.3, 0.1, 10, 10).numpy()
    p1 = plot_predictions_vs_truth([0.1], [0.3], [[0.3, 0.1, 5.0]], str(tmp_path / "a.png"))
    p2 = plot_peaks(phi, 10, 10, {"tau": np.array([0.3]), "f": np.array([0.1])},
                    str(tmp_path / "b.png"), step=0.02)
    assert os.path.getsize(p1) > 1000 and os.path.getsize(p2) > 1000


def test_cli_plot_flags(tmp_path, capsys):
    from admmnet_tpu_torch.cli import generate_dataset, main_classical, main_net

    main_classical.main(["--mode", "fixed_e", "--deploy", "--device", "cpu", "--json",
                         "--plot", str(tmp_path / "cls")])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[0])["f1"] == 1.0
    for name in ("pred_vs_truth.png", "peaks_surface.png"):
        assert (tmp_path / "cls" / name).stat().st_size > 1000

    main_net.main(["--ckpt", str(ROOT / "runs" / "phi10"), "--device", "cpu", "--json",
                   "--plot", str(tmp_path / "net")])
    assert "peaks" in json.loads(capsys.readouterr().out.strip().splitlines()[0])
    for name in ("net_pred_vs_truth.png", "net_peaks_surface.png"):
        assert (tmp_path / "net" / name).stat().st_size > 1000

    ds = tmp_path / "ds"
    generate_dataset.main(["--out", str(ds), "--total", "40", "--Nb", "4", "--Nd", "4",
                           "--fixed-snr", "20", "--device", "cpu", "--stats-plot"])
    assert (ds / "dataset_statistics.png").stat().st_size > 1000


def test_step_timer_and_timed_fetch():
    from admmnet_tpu_torch.utils.profiling import StepTimer, span, timed_fetch

    t = StepTimer(items_per_step=10)
    for _ in range(3):
        with t.step(), span("step"):
            pass
    s = t.summary()
    assert s["steps"] == 3 and s["items_per_s"] > 0
    assert set(s) == {"steps", "mean_s", "p50_s", "p95_s", "items_per_s"}
    out, dt = timed_fetch(lambda x: (x * 2).sum(), torch.ones(16))
    assert float(out) == 32.0 and dt >= 0


def test_trace_writes_a_trace(tmp_path):
    from admmnet_tpu_torch.utils.profiling import trace

    with trace(str(tmp_path)):
        torch.ones(8).sum()
    assert any(p.name.endswith(".json") for p in tmp_path.iterdir())


def test_check_finite_names_the_leaf():
    from admmnet_tpu_torch.utils.debug import check_finite

    check_finite({"ok": torch.ones(3), "also": [np.zeros(2)]})
    with pytest.raises(FloatingPointError, match=r"tree\['bad'\]: 1/2 non-finite"):
        check_finite({"ok": torch.ones(3), "bad": torch.tensor([1.0, float("nan")])})
    with pytest.raises(FloatingPointError, match=r"p\['w'\]\[1\]"):
        check_finite({"w": [np.ones(2), np.array([np.inf])]}, name="p")


def test_nan_guard_raises_at_the_producing_op():
    from admmnet_tpu_torch.utils.debug import nan_guard

    x = torch.tensor(-1.0)
    with nan_guard():
        with pytest.raises(FloatingPointError, match="log"):
            torch.log(x) + 1
        torch.log(-x)  # finite: passes
    assert torch.isnan(torch.log(x))  # guard lifted
    # a NaN made in the backward raises at its op (anomaly mode)
    w = torch.tensor(0.0, requires_grad=True)
    with nan_guard():
        y = torch.sqrt(w) * 0.0  # forward finite, d sqrt(w) at 0 is inf -> 0 * inf
        with pytest.raises(RuntimeError, match="nan"):
            y.backward()


def test_fit_polar_schedule_reproduces_committed_prefix():
    """The port's fitter reproduces the first steps of the port's
    POLAR_QUINTIC_SCHEDULE (greedy: a shorter fit is a prefix)."""
    from admmnet_tpu_torch.ops.fit_polar_schedule import composed_errors, fit_schedule
    from admmnet_tpu_torch.ops.projections import POLAR_QUINTIC_SCHEDULE

    sched, _ = fit_schedule(3, l0=1e-3)
    for got, want in zip(sched, POLAR_QUINTIC_SCHEDULE):
        assert np.allclose(got, want, atol=2e-5), (got, want)
    band3, _ = composed_errors(sched, 1e-3)
    assert band3 > 1e-2


def test_fit_bf16_schedule_reproduces_committed():
    from admmnet_tpu_torch.ops.fit_polar_schedule import fit_bf16_schedule
    from admmnet_tpu_torch.ops.projections import POLAR_BF16_POLISH, POLAR_BF16_SCHEDULE

    sched, polish = fit_bf16_schedule()
    assert len(sched) == len(POLAR_BF16_SCHEDULE)
    for got, want in zip(sched, POLAR_BF16_SCHEDULE):
        assert np.allclose(got, want, atol=2e-4), (got, want)
    assert np.allclose(polish, POLAR_BF16_POLISH, atol=2e-4)
