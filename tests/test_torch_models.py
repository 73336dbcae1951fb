"""Port parity: the learned ADMM-Net -- configuration, checkpoint reading,
weight conversion, layers, heads, whole nets and the net CLIs.

The same numpy inputs go through the JAX package's flax modules and the
port's torch modules, loaded with the same weights (``flax_to_state_dict``
/ ``params_from_jax`` of the flax tree).  Tolerances: every product is fp32
on both sides with the sums in another order (the eigh GLayer decomposes in
complex128 in the port, complex64 in JAX); measured differences are below
1e-5 relative for phi and 1e-6 absolute for tau, f and conf through whole
nets, held at 1e-4.  Nets are evaluated on one batch on both sides: the
ZLayer couples the instances of a batch.
"""

import dataclasses
import json
from pathlib import Path

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admmnet_tpu.core.config as jcfg
import admmnet_tpu.models.layers as jlayers
import admmnet_tpu.models.peak_head as jhead
import admmnet_tpu_torch.core.config as tcfg
import admmnet_tpu_torch.models.layers as tlayers
import admmnet_tpu_torch.models.peak_head as thead
from admmnet_tpu.models import ADMMNet as JADMMNet
from admmnet_tpu.models import PhiEstADMMNet as JPhiEst
from admmnet_tpu_torch.core.convert import flax_to_state_dict, options_from_jax, params_from_jax
from admmnet_tpu_torch.models import ADMMNet, PhiEstADMMNet
from admmnet_tpu_torch.train.checkpoint import msgpack_decode, restore_checkpoint

torch.set_num_threads(1)  # JAX and torch share the cores of one test worker

ROOT = Path(__file__).resolve().parents[1]
RUNS = sorted(p.parent.name for p in (ROOT / "runs").glob("*/best_model.msgpack"))
SCENES = ROOT / "tests" / "golden" / "random512_key42.npz"
TOL = 1e-4


def _rel(a, b):
    a, b = np.asarray(a).reshape(len(a), -1), np.asarray(b).reshape(len(b), -1)
    return float(np.max(np.linalg.norm(a - b, axis=-1) / np.linalg.norm(b, axis=-1)))


def _jax_config(run):
    d = json.loads((ROOT / "runs" / run / "config.json").read_text())["model"]
    return d, jcfg._from_dict(jcfg.ModelConfig, d)


def _scenes(B):
    with np.load(SCENES) as d:
        return {k: d[k][:B] for k in d.files}


# ---- configuration ---------------------------------------------------------


def test_model_config_defaults_equal_field_by_field():
    j, t = jcfg.ModelConfig(), tcfg.ModelConfig()
    assert [f.name for f in dataclasses.fields(j)] == [f.name for f in dataclasses.fields(t)]
    assert dataclasses.asdict(j) == dataclasses.asdict(t)


@pytest.mark.parametrize("bad", [{"g_mode": "svd"}, {"cheb_impl": "Pallas"},
                                 {"cheb_precision": "high"}, {"head": "mlp"}])
def test_model_config_guards_match(bad):
    for mod in (jcfg, tcfg):
        with pytest.raises(ValueError):
            mod.ModelConfig(**bad)


@pytest.mark.parametrize("run", RUNS)
def test_options_from_jax_reads_run_configs(run):
    d, j = _jax_config(run)
    for form in (d, j, json.dumps(d)):
        t = options_from_jax(form)
        assert type(t) is tcfg.ModelConfig and dataclasses.asdict(t) == dataclasses.asdict(j)


# ---- checkpoints and weights -------------------------------------------------


def _assert_same_tree(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for k in a:
            _assert_same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, list) and len(a) == len(b), path
        for x, y in zip(a, b):
            _assert_same_tree(x, y, path)
    elif isinstance(a, np.ndarray):
        assert type(b) is np.ndarray and (a.dtype, a.shape) == (b.dtype, b.shape), path
        assert a.tobytes() == b.tobytes(), path
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


@pytest.mark.parametrize("run", RUNS)
def test_msgpack_reader_matches_flax_bitwise(run):
    data = (ROOT / "runs" / run / "best_model.msgpack").read_bytes()
    _assert_same_tree(flax.serialization.msgpack_restore(data), msgpack_decode(data))


def test_restore_checkpoint(tmp_path):
    state, meta = restore_checkpoint(ROOT / "runs" / "train_net3_r05")
    assert set(state) == {"params", "opt_state"} and meta["epoch"] == 14
    assert restore_checkpoint(tmp_path) is None


def test_params_from_jax_rejects_missing_and_left_over_leaves():
    d, _ = _jax_config("train_net3_r05")
    cfg = options_from_jax(d)
    tree = restore_checkpoint(ROOT / "runs" / "train_net3_r05")[0]["params"]["params"]
    sd = params_from_jax(tree, cfg)
    assert sd["trunk.h_0.correction_hidden.weight"].shape == (64, 100)
    assert sd["trunk.g_2.lambda"].shape == ()
    del tree["trunk"]["g_1"]["threshold"]
    with pytest.raises(ValueError, match="missing.*g_1.threshold"):
        params_from_jax(tree, cfg)
    tree["trunk"]["g_1"]["threshold"] = np.zeros((), np.float32)
    tree["trunk"]["g_1"]["extra"] = np.zeros((), np.float32)
    with pytest.raises(ValueError, match="left over.*g_1.extra"):
        params_from_jax(tree, cfg)
    del tree["trunk"]["g_1"]["extra"]
    with pytest.raises(ValueError, match="shape mismatch"):
        params_from_jax(tree, dataclasses.replace(cfg, value_net_hidden=8))


# ---- layers and heads ----------------------------------------------------------

N, B = 16, 3


def _layer_inputs():
    rng = np.random.default_rng(0)

    def cplx(*shape):
        return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)

    def herm(scale):
        X = cplx(B, N + 1, N + 1)
        return ((X + np.conj(np.swapaxes(X, -1, -2))) * scale).astype(np.complex64)

    return {"y": cplx(B, N), "b": cplx(B, N), "phi": 0.3 * cplx(B, N),
            "h": (0.05 * rng.normal(size=(B, N))).astype(np.float32),
            "G": herm(0.1), "Z": herm(0.05),
            "sigma": rng.uniform(0.5, 2.0, size=B).astype(np.float32)}


def _perturbed(params, seed=1):
    """Flax init plus noise, so the scalars leave their initial values."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + (0.1 * rng.normal(size=np.shape(x))).astype(np.float32),
        params)


def _check_layer(jmod, tmod, args):
    params = _perturbed(jmod.init(jax.random.PRNGKey(0), *args)["params"])
    ref = jmod.apply({"params": params}, *args)
    tmod.load_state_dict(flax_to_state_dict(params))
    tmod.eval()  # flax's apply is deterministic: no dropout
    with torch.no_grad():
        out = tmod(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args])
    refs = ref if isinstance(ref, tuple) else (ref,)
    outs = out if isinstance(out, tuple) else (out,)
    for r, o in zip(refs, outs):
        assert o.dtype == {np.complex64: torch.complex64,
                           np.float32: torch.float32}[np.asarray(r).dtype.type]
        if np.iscomplexobj(r):
            assert _rel(o.numpy(), r) < TOL
        else:
            np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=TOL, atol=TOL)


def test_phi_layer():
    x = _layer_inputs()
    _check_layer(jlayers.PhiLayer(), tlayers.PhiLayer(), (x["y"], x["b"], x["G"], x["Z"]))


def test_h_layer():
    x = _layer_inputs()
    _check_layer(jlayers.HLayer(dim=N), tlayers.HLayer(N),
                 (x["phi"], x["G"], x["Z"], x["sigma"]))


@pytest.mark.parametrize("mode, impl, precision", [
    ("eigh", "xla", "highest"), ("chebyshev", "xla", "highest"),
    ("chebyshev", "xla", "default"), ("chebyshev", "pallas", "highest")])
def test_g_layer(mode, impl, precision):
    """On the CPU the JAX pallas engine takes its XLA path at DEFAULT
    precision, the numerics of the port's plain Clenshaw version."""
    x = _layer_inputs()
    kw = dict(mode=mode, cheb_degree=16, cheb_precision=precision, cheb_impl=impl)
    _check_layer(jlayers.GLayer(dim=N, **kw), tlayers.GLayer(N, **kw),
                 (x["phi"], x["h"], x["Z"]))


def test_z_layer():
    x = _layer_inputs()
    _check_layer(jlayers.ZLayer(dim=N), tlayers.ZLayer(N),
                 (x["phi"], x["h"], x["G"], x["Z"], 2))


def test_sensing_matrix():
    from admmnet_tpu.models.nets import _SensingMatrix as JSensing
    from admmnet_tpu_torch.models.nets import _SensingMatrix as TSensing

    _check_layer(JSensing(dim=N), TSensing(N), (_layer_inputs()["y"],))


def test_softplus_has_no_cut_off():
    x = torch.tensor([-30.0, -1.0, 0.0, 5.0, 19.0, 21.0, 40.0])
    np.testing.assert_allclose(tlayers.softplus(x).numpy(),
                               np.asarray(jax.nn.softplus(x.numpy())), rtol=1e-6)


@pytest.mark.parametrize("head", ["spectrum", "attention"])
def test_peak_heads(head):
    phi = _layer_inputs()["phi"]
    if head == "spectrum":
        j, t = jhead.SpectrumPeakHead(M=4, N=4), thead.SpectrumPeakHead(4, 4)
    else:
        j = jhead.PeakSearchHead(M=4, N=4, hidden_dim=32, num_heads=4)
        t = thead.PeakSearchHead(4, 4, hidden_dim=32, num_heads=4)
    _check_layer(j, t, (phi,))


# ---- whole nets on the committed checkpoints ----------------------------------


@pytest.mark.parametrize("run, B", [("train_net3_r05", 16), ("admmnet10", 4), ("phi10", 4),
                                    ("spec50k_sense", 2), ("spec50k_warm", 2)])
def test_net_matches_jax(run, B):
    """net-3 (pallas Clenshaw, spectrum head), net-10 (eigh GLayer,
    attention head), the phi net, and net-10 with the chebyshev GLayer and
    the spectrum head, learned sensing (spec50k_sense) and warm-started
    from the phi net's trunk (spec50k_warm), each on the first B random
    scenes."""
    d, jc = _jax_config(run)
    state = flax.serialization.msgpack_restore(
        (ROOT / "runs" / run / "best_model.msgpack").read_bytes())
    tree = restore_checkpoint(ROOT / "runs" / run)[0]["params"]["params"]
    e2e = "peak_head" in tree
    x = _scenes(B)
    args = (x["y"], x["b"], x["sigma"])
    ref = (JADMMNet if e2e else JPhiEst)(cfg=jc).apply(state["params"], *map(jnp.asarray, args))
    cfg = options_from_jax(d)
    model = (ADMMNet if e2e else PhiEstADMMNet)(cfg)
    model.load_state_dict(params_from_jax(tree, cfg))
    with torch.no_grad():
        out = model.eval()(*map(torch.from_numpy, args))
    refs, outs = (ref, out) if e2e else ((ref,), (out,))
    assert _rel(outs[-1].numpy(), refs[-1]) < TOL  # phi
    for r, o in zip(refs[:-1], outs[:-1]):  # tau, f, conf in head order
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=TOL, rtol=0)


# ---- CLIs ------------------------------------------------------------------


@pytest.fixture
def dataset(tmp_path):
    """The first 16 random scenes as a test split in load_split's layout,
    written by the JAX package, with the matched filter conj(b) y as phi
    labels."""
    from admmnet_tpu.data.generator import DatasetGenerator

    x = _scenes(16)
    raw = {"y": x["y"], "b": x["b"], "tau": x["tau"], "f": x["f"], "sigma": x["sigma"],
           "C": np.zeros_like(x["tau"], np.complex64),
           "L_true": np.full(16, 3, np.int32), "ser": np.zeros(16, np.float32),
           "phi": np.conj(x["b"]) * x["y"]}
    gen = DatasetGenerator(data_dir=tmp_path)
    gen._save_split("test", raw)
    gen._save_config(16, 0, 0, 16, True)
    return str(tmp_path)


def _run_both(capsys, jax_main, port_main, args):
    jax_main(args)
    j = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    port_main(args + ["--device", "cpu"])
    t = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert t.pop("device") == "cpu"
    return j, t


def _close(j, t, tol):
    """Equal JSON trees, numbers within tol."""
    if isinstance(j, dict):
        assert set(j) == set(t)
        for k in j:
            _close(j[k], t[k], tol)
    elif isinstance(j, float):
        assert abs(j - t) <= tol, (j, t)
    else:
        assert j == t


def test_eval_net_e2e_cli(capsys, dataset):
    """Detection counts are equal; the RMSEs are over the same matched pairs."""
    from admmnet_tpu.cli.eval_net import main as jax_main
    from admmnet_tpu_torch.cli.eval_net import main as port_main

    j, t = _run_both(capsys, jax_main, port_main, [
        "--data", dataset, "--ckpt", str(ROOT / "runs" / "train_net3_r05"), "--e2e",
        "--num-layers", "3", "--g-mode", "chebyshev", "--cheb-impl", "pallas",
        "--head", "spectrum", "--json"])
    assert j["samples"] == 16 and j["detection"]["f1"] > 0.5
    _close(j, t, 1e-5)


def test_eval_net_phi_cli(capsys, dataset):
    from admmnet_tpu.cli.eval_net import main as jax_main
    from admmnet_tpu_torch.cli.eval_net import main as port_main

    j, t = _run_both(capsys, jax_main, port_main, [
        "--data", dataset, "--ckpt", str(ROOT / "runs" / "phi10"), "--limit", "8", "--json"])
    assert j["samples"] == 8
    _close(j, t, 1e-4)


def test_main_net_cli(capsys):
    from admmnet_tpu.cli.main_net import main as jax_main
    from admmnet_tpu_torch.cli.main_net import main as port_main

    j, t = _run_both(capsys, jax_main, port_main, [
        "--ckpt", str(ROOT / "runs" / "phi10"), "--json"])
    assert t["f1"] == j["f1"] and len(t["peaks"]) == len(j["peaks"]) == 3
    for (tt, tf, th), (jt, jf, jh) in zip(sorted(t["peaks"]), sorted(j["peaks"])):
        assert abs(tt - jt) < 1e-3 and abs(tf - jf) < 1e-3 and abs(th - jh) <= 1e-3 * abs(jh)


def test_net_clis_need_a_gpu_for_cuda(monkeypatch):
    from admmnet_tpu_torch.cli import eval_net, main_net

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, args in ((main_net.main, ["--ckpt", "runs/phi10"]),
                       (eval_net.main, ["--ckpt", "runs/phi10", "--data", "x"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(args)
    with pytest.raises(SystemExit, match="no checkpoint"):
        eval_net.load_model("/nonexistent", tcfg.ModelConfig(), False, "cpu")
