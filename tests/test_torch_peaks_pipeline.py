"""Port parity: spectrum, peak search, scoring, the classical CLI, and the
port's independence from JAX.

Peak sets are compared sorted by delay, because ``torch.topk`` and
``lax.top_k`` may order equal scores differently.  Tolerances: the
spectrum is float32 complex products summed in another order (1e-5
relative); the 3 strongest peaks agree to one grid step of the last
refine round (a near-tie may break either way), weak side-lobe peaks on
flat spectra to 1e-4 plus that step, heights to 1e-4 relative.  The CLI
runs different solver paths on the CPU in the two packages (the port's
plain fused solve, JAX's scan fallback), so its peaks are held to the 1e-3
detection band.
"""

import contextlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import admmnet_tpu.core.config as jcfg
from admmnet_tpu.data.anchor import make_anchor_batch
from admmnet_tpu.peaks import find_peaks as jax_find_peaks
from admmnet_tpu.peaks import match_peaks as jax_match_peaks
from admmnet_tpu.peaks import spectrum_at as jax_spectrum_at
from admmnet_tpu.peaks import spectrum_grid as jax_spectrum_grid
from admmnet_tpu.solver import admm_solve_fixed as jax_fixed
from admmnet_tpu_torch.core.convert import options_from_jax
from admmnet_tpu_torch.peaks import find_peaks, match_peaks, spectrum_at, spectrum_grid

torch.set_num_threads(1)  # JAX and torch share the cores of one test worker


@pytest.fixture(scope="module")
def phi():
    y, b, s = make_anchor_batch(3, mode="redemod", seed=4)
    return np.array(jax_fixed(jnp.asarray(y), jnp.asarray(b), jnp.asarray(s), 15, 1.0,
                              jcfg.ADMMOptions(g_update="newton_schulz")))


def test_spectrum_matches_jax(phi):
    taus = np.linspace(0, 0.99, 37, dtype=np.float32)
    fs = np.linspace(-0.5, 0.49, 29, dtype=np.float32)
    zj = np.asarray(jax_spectrum_grid(jnp.asarray(phi), taus, fs, 10, 10))
    zt = spectrum_grid(torch.from_numpy(phi), torch.from_numpy(taus), torch.from_numpy(fs),
                       10, 10).numpy()
    assert zt.shape == zj.shape == (3, 29, 37)
    np.testing.assert_allclose(zt, zj, rtol=1e-5, atol=1e-5 * zj.max())
    pt, pf = taus[None, :5].repeat(3, 0), fs[None, :5].repeat(3, 0)
    np.testing.assert_allclose(
        spectrum_at(torch.from_numpy(phi), torch.from_numpy(pt), torch.from_numpy(pf),
                    10, 10).numpy(),
        np.asarray(jax_spectrum_at(jnp.asarray(phi), pt, pf, 10, 10)), rtol=1e-5)


@pytest.mark.parametrize("cfg", [jcfg.PeakSearchConfig(), jcfg.PRODUCTION_PEAKS],
                         ids=["default", "production"])
def test_find_peaks_matches_jax(phi, cfg):
    pj = jax_find_peaks(jnp.asarray(phi), 10, 10, cfg)
    pt = find_peaks(torch.from_numpy(phi), 10, 10, options_from_jax(cfg))
    assert pt.tau.shape == (3, cfg.max_peaks)
    for i in range(3):
        vj, vt = np.asarray(pj.valid[i]), pt.valid[i].numpy()
        assert vj.sum() == vt.sum() > 0
        heights_j = np.asarray(pj.height[i])
        assert np.all(np.diff(pt.height[i].numpy()[vt]) <= 0)  # sorted by height
        assert np.all(np.isneginf(pt.height[i].numpy()[~vt]))
        oj = np.argsort(np.asarray(pj.tau[i])[vj])
        ot = np.argsort(pt.tau[i].numpy()[vt])
        # spacing of the last refine round's grid, in units of the coarse step
        step = 2 * cfg.reduce_factor ** (cfg.refine_iters - 1) / (cfg.refine_points - 1)
        for jarr, tarr, unit in ((pj.tau, pt.tau, cfg.delay_step),
                                 (pj.f, pt.f, cfg.doppler_step)):
            # weak side-lobe peaks sit on flat spectra: rounding may move them
            np.testing.assert_allclose(tarr[i].numpy()[vt][ot], np.asarray(jarr[i])[vj][oj],
                                       atol=1e-4 + step * unit)
            # the 3 strongest (the targets): at most one last-round grid step
            np.testing.assert_allclose(tarr[i].numpy()[:3], np.asarray(jarr[i])[:3],
                                       atol=1.01 * step * unit)
        np.testing.assert_allclose(pt.height[i].numpy()[vt][ot], heights_j[vj][oj], rtol=1e-4)


def test_match_peaks_identical():
    rng = np.random.default_rng(0)
    pred_t, pred_f = rng.uniform(0, 1, (6, 5)), rng.uniform(-0.5, 0.5, (6, 5))
    true_t = pred_t[:, :3] + rng.normal(0, 0.02, (6, 3))
    true_f = pred_f[:, :3] + rng.normal(0, 0.02, (6, 3))
    valid = rng.uniform(size=(6, 5)) > 0.2
    for tol in (0.05, None):
        assert match_peaks(pred_t, pred_f, true_t, true_f, tol, tol, valid) == \
            jax_match_peaks(pred_t, pred_f, true_t, true_f, tol, tol, valid)


@pytest.mark.parametrize(
    "extra", [["--deploy"], ["--max-iter", "30", "--g-update", "newton_schulz"]],
    ids=["deploy", "adaptive"])
def test_cli_matches_jax_cli(capsys, extra):
    from admmnet_tpu.cli.main_classical import main as jax_main
    from admmnet_tpu_torch.cli.main_classical import main as port_main

    args = ["--mode", "fixed_e", "--json", *extra]
    with pytest.warns(UserWarning) if "--deploy" in extra else contextlib.nullcontext():
        jax_main(args)
    j = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    port_main(args + ["--device", "cpu"])
    t = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert t["f1"] == j["f1"] == 1.0 and t["device"] == "cpu"
    assert t["iterations"] == j["iterations"] and t["converged"] == j["converged"]
    assert len(t["peaks"]) == len(j["peaks"]) == 3
    for (tt, tf, _), (jt, jf, _) in zip(sorted(t["peaks"]), sorted(j["peaks"])):
        assert abs(tt - jt) < 1e-3 and abs(tf - jf) < 1e-3


def test_cli_top_clamp_and_cuda_without_gpu(capsys, monkeypatch):
    from admmnet_tpu_torch.cli.main_classical import main as port_main

    port_main(["--deploy", "--json", "--device", "cpu", "--top", "50"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["converged"] is None and out["iterations"] == 10
    assert 3 <= len(out["peaks"]) <= 8  # clamped to PRODUCTION_PEAKS.max_peaks
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main(["--deploy", "--json"])


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import admmnet_tpu_torch\n"
        "for m in pkgutil.walk_packages(admmnet_tpu_torch.__path__, 'admmnet_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'admmnet_tpu'))\n"
        "print(sum(k.startswith('admmnet_tpu_torch.') for k in sys.modules), bad)\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[0]) >= 34  # every module was imported
