"""Port parity: the phi-regression route and the trainer's remaining
options -- ``phi_alignment_loss``, ``train_phinet``, ``--init-from`` a phi
run, ``reset_best``, the graft into a ``learned_sensing`` superset, and
``train_cli --phi`` with ``--init-from`` -- against the JAX package.

Both trainers draw their minibatches in the numpy order (the native
loaders' orders differ).  Tolerances: fp32 on both sides with the sums in
another order; the port's chebyshev GLayer trains through the reversible
Clenshaw backward, JAX's through XLA autodiff of the re-projected
recurrence (~1e-7 per gradient), so two epochs of losses agree to ~1e-6
relative, held at 1e-5.
"""

import json

import jax
import numpy as np
import pytest
import torch

import admmnet_tpu.core.config as jcfg
import admmnet_tpu.train.losses as jloss
import admmnet_tpu_torch.core.config as tcfg
from admmnet_tpu.data.generator import generate_batch as jgenerate_batch
from admmnet_tpu.data.generator import label_phi as jlabel_phi
from admmnet_tpu.models import PhiEstADMMNet as JPhiEst
from admmnet_tpu.utils.host import cjit
from admmnet_tpu_torch.core.convert import options_from_jax, params_from_jax, params_to_jax
from admmnet_tpu_torch.data.generator import generate_batch, label_phi
from admmnet_tpu_torch.models import ADMMNet, PhiEstADMMNet
from admmnet_tpu_torch.train import phi_alignment_loss, trainer
from admmnet_tpu_torch.train.checkpoint import restore_checkpoint

torch.set_num_threads(1)  # JAX and torch share the cores of one test worker

SPEC = dict(Nb=4, Nd=4, L_max=2)
PHI_NET = dict(num_layers=2, g_mode="chebyshev", cheb_impl="pallas")


@pytest.fixture
def numpy_order(monkeypatch):
    monkeypatch.setattr("admmnet_tpu.data.loader.native_available", lambda: False)
    monkeypatch.setattr("admmnet_tpu_torch.data.loader.native_available", lambda: False)


def _jax_dataset(n, seed, iters=10):
    """JAX's scenes and phi labels (``tests/test_training.py``'s
    ``_dataset``)."""
    cfg = jcfg.DataConfig(spec=jcfg.ProblemSpec(**SPEC))
    data = jgenerate_batch(jax.random.PRNGKey(seed), cfg, n)
    data["phi"] = jlabel_phi(data["y"], data["b"], data["sigma"], jcfg.ADMMOptions(), iters=iters)
    return {k: np.asarray(v) for k, v in data.items()}


def _port_dataset(n, seed, with_phi=False):
    cfg = tcfg.DataConfig(spec=tcfg.ProblemSpec(**SPEC))
    data = generate_batch(cfg, n, torch.Generator().manual_seed(seed), "cpu")
    if with_phi:
        data["phi"] = label_phi(data["y"], data["b"], data["sigma"], iters=10, device="cpu")
    return data


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def test_phi_alignment_loss_matches_jax():
    """Amplitude MSE and wrapped phase MSE, with phase differences across
    the +-pi cut."""
    rng = np.random.default_rng(11)
    shape = (24, 16)
    pred = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)
    true = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)
    true[0, :4] = [-1 + 1e-3j, -1 - 1e-3j, 1j, -1j]  # phases near +-pi and +-pi/2
    pred[0, :4] = [-1 - 1e-3j, -1 + 1e-3j, -1j, 1j]
    for weights in ((1.0, 0.5), (0.3, 2.0)):
        jt, jp = jloss.phi_alignment_loss(jax.numpy.asarray(pred), jax.numpy.asarray(true),
                                          *weights)
        tt, tp = phi_alignment_loss(torch.from_numpy(pred), torch.from_numpy(true), *weights)
        assert set(tp) == set(jp) == {"total_loss", "amplitude_loss", "phase_loss"}
        for k in jp:
            assert abs(float(tp[k]) - float(jp[k])) <= 1e-6 * abs(float(jp[k])), k
        assert float(tt) == float(tp["total_loss"])


def test_train_phinet_matches_jax(tmp_path, monkeypatch, numpy_order):
    """Two epochs of ``train_phinet`` from JAX's seed-0 init on JAX's scenes
    and labels (64 training, 32 validation, batch 32): every epoch's train
    and validation loss within 1e-5 relative, the same lr, the same best
    epoch."""
    from admmnet_tpu.train.trainer import train_phinet as jtrain_phinet

    train, val = _jax_dataset(64, 6), _jax_dataset(32, 7)
    mcfg_j = jcfg.ModelConfig(spec=jcfg.ProblemSpec(**SPEC), **PHI_NET)
    tc = jcfg.TrainConfig(batch_size=32, epochs=2, lr=5e-3, patience=10, seed=0)
    jres = jtrain_phinet(mcfg_j, tc, train, val, None, workdir=str(tmp_path / "jax"),
                         log_fn=lambda m: None)

    init = cjit(lambda k, y, b, s: JPhiEst(cfg=mcfg_j).init(k, y, b, s))(
        jax.random.PRNGKey(tc.seed), train["y"][:2], train["b"][:2], train["sigma"][:2])
    mcfg = options_from_jax(mcfg_j)
    real_init = trainer.init_model

    def jax_init(model_cls, cfg, seed, device):
        model = real_init(model_cls, cfg, seed, device)
        model.load_state_dict(params_from_jax(init["params"], cfg))
        return model

    monkeypatch.setattr(trainer, "init_model", jax_init)
    res = trainer.train_phinet(mcfg, options_from_jax(tc), train, val, None,
                               workdir=tmp_path / "port", log_fn=lambda m: None, device="cpu")
    for k in ("train_loss", "val_loss"):
        assert _rel(res.history[k], jres.history[k]) < 1e-5, (k, res.history[k], jres.history[k])
    np.testing.assert_allclose(res.history["lr"], jres.history["lr"], rtol=2e-6)
    assert res.history["val_loss"][-1] < res.history["val_loss"][0]
    meta = [json.loads((tmp_path / w / "metadata.json").read_text()) for w in ("port", "jax")]
    assert meta[0]["epoch"] == meta[1]["epoch"] and meta[0]["mode"] == "phi"


def test_train_admmnet_init_from_phinet(tmp_path, monkeypatch):
    """``init_from`` a trained PhiEstADMMNet grafts its trunk into the e2e
    ADMMNet (``tests/test_training.py::test_train_admmnet_init_from_phinet``):
    the log names ``['trunk']`` and every trunk leaf of the phi run's
    checkpoint, and before the first step the e2e trunk is the donor's bit
    for bit."""
    spec = tcfg.ProblemSpec(**SPEC)
    trainer.train_phinet(tcfg.ModelConfig(spec=spec, num_layers=2, hidden_dim=32),
                         tcfg.TrainConfig(batch_size=32, epochs=1, seed=0),
                         _port_dataset(64, 7, True), _port_dataset(32, 8, True), None,
                         workdir=tmp_path / "phi", log_fn=lambda m: None, device="cpu")
    donor = restore_checkpoint(tmp_path / "phi")[0]["params"]["params"]
    assert list(donor) == ["trunk"]

    seen = {}
    real_build_steps = trainer.build_steps

    def capture(model, *a, **k):
        seen["trunk"] = params_to_jax(model.state_dict(), model.cfg)["trunk"]
        return real_build_steps(model, *a, **k)

    monkeypatch.setattr(trainer, "build_steps", capture)
    mcfg = tcfg.ModelConfig(spec=spec, num_layers=2, hidden_dim=32, head="spectrum")
    logs = []
    res = trainer.train_admmnet(
        mcfg, tcfg.TrainConfig(batch_size=32, epochs=1, seed=0, assignment="perm",
                               spectral_weight=0.5),
        _port_dataset(64, 1), _port_dataset(32, 2), None, workdir=tmp_path / "e2e",
        init_from=tmp_path / "phi", log_fn=logs.append, device="cpu")
    leaves = jax.tree_util.tree_leaves(donor["trunk"])
    assert any(f"warm-started {len(leaves)} leaves in submodules ['trunk']" in m
               for m in logs), logs
    assert np.isfinite(res.history["train_loss"]).all()
    got = jax.tree_util.tree_leaves(seen["trunk"])
    assert len(got) == len(leaves)
    assert all(np.array_equal(np.asarray(a), b) for a, b in zip(got, leaves))


def test_resume_reset_best_for_curriculum(tmp_path):
    """With ``reset_best`` a second stage checkpoints although its
    validation losses are worse than the first stage's
    (``tests/test_training.py::test_resume_reset_best_for_curriculum``)."""
    mcfg = tcfg.ModelConfig(spec=tcfg.ProblemSpec(**SPEC), num_layers=1, hidden_dim=16)
    work = tmp_path / "run"
    trainer.train_admmnet(mcfg, tcfg.TrainConfig(batch_size=32, epochs=1, patience=3, seed=0),
                          _port_dataset(64, 1), _port_dataset(32, 2), None, workdir=work,
                          log_fn=lambda m: None, device="cpu")
    meta1 = json.loads((work / "metadata.json").read_text())
    logs = []
    res = trainer.train_admmnet(
        mcfg, tcfg.TrainConfig(batch_size=32, epochs=3, patience=3, seed=0, reset_best=True),
        _port_dataset(64, 4), _port_dataset(32, 5), None, workdir=work, log_fn=logs.append,
        device="cpu")
    meta2 = json.loads((work / "metadata.json").read_text())
    assert "resumed from epoch 1 (best_val reset)" in logs
    assert meta2["epoch"] > meta1["epoch"]
    assert res.epochs_run == 3


def test_init_from_grafts_into_learned_sensing_superset():
    """A plain-trunk donor grafted into a ``learned_sensing`` ADMMNet: the
    shared layers take the donor's leaves, the sensing matrix keeps its
    identity init, and the port's ``_graft_params`` returns JAX's tree and
    messages on the same trees
    (``tests/test_training.py::test_init_from_grafts_into_learned_sensing_superset``)."""
    from admmnet_tpu.train.trainer import _graft_params as jgraft

    spec = tcfg.ProblemSpec(**SPEC)
    mcfg = tcfg.ModelConfig(spec=spec, num_layers=1, hidden_dim=16)
    mcfg_s = tcfg.ModelConfig(spec=spec, num_layers=1, hidden_dim=16, learned_sensing=True)
    donor = params_to_jax(trainer.init_model(ADMMNet, mcfg, 0, "cpu").state_dict(), mcfg)
    tgt = params_to_jax(trainer.init_model(ADMMNet, mcfg_s, 1, "cpu").state_dict(), mcfg_s)
    msgs, jmsgs = [], []
    out = trainer._graft_params(tgt, donor, msgs.append)
    np.testing.assert_array_equal(out["trunk"]["phi_0"]["rho"], donor["trunk"]["phi_0"]["rho"])
    np.testing.assert_array_equal(out["trunk"]["sensing"]["w_real"], np.eye(spec.n))
    assert any("sensing" in m for m in msgs)
    jout = jgraft({"params": tgt}, {"params": donor}, jmsgs.append)["params"]
    assert [m.replace("params/", "") for m in jmsgs] == msgs
    ja, ta = jax.tree_util.tree_leaves(jout), jax.tree_util.tree_leaves(out)
    assert len(ja) == len(ta) and all(np.array_equal(np.asarray(a), b) for a, b in zip(ja, ta))
    # the grafted model loads and runs
    model = ADMMNet(mcfg_s)
    model.load_state_dict(params_from_jax(out, mcfg_s))


@pytest.mark.parametrize("package", ["admmnet_tpu", "admmnet_tpu_torch"])
def test_train_cli_phi_ignores_init_from(package, tmp_path, monkeypatch):
    """``train_cli --phi --init-from DIR`` trains the phi net from its fresh
    init in both packages: the flag is e2e-only and never reaches
    ``train_phinet``."""
    import importlib

    cli = importlib.import_module(f"{package}.cli.train_cli")
    gen = importlib.import_module(f"{package}.data.generator")
    tr = importlib.import_module(f"{package}.train.trainer")
    raw = _port_dataset(20, 3, with_phi=True)
    g = gen.DatasetGenerator(data_dir=tmp_path / "ds")
    for s in ("train", "val", "test"):
        g._save_split(s, raw)
    g._save_config(60, 20, 20, 20, True)
    calls = []

    def record(name):
        def fake(*args, **kwargs):
            calls.append((name, kwargs))
            return tr.TrainResult(params={}, history={}, best_val_loss=0.0, test_metrics={},
                                  epochs_run=0)
        return fake

    monkeypatch.setattr(tr, "train_phinet", record("train_phinet"))
    monkeypatch.setattr(tr, "train_admmnet", record("train_admmnet"))
    argv = ["--data", str(tmp_path / "ds"), "--workdir", str(tmp_path / "run"), "--phi",
            "--init-from", str(tmp_path / "donor"), "--num-layers", "2"]
    cli.main(argv + (["--device", "cpu"] if package == "admmnet_tpu_torch" else []))
    ((name, kwargs),) = calls
    assert name == "train_phinet" and "init_from" not in kwargs


def test_phinet_golden_loads_into_the_port():
    """``tests/golden/phinet_train_golden.msgpack`` (made by
    ``make_phinet_train_golden.py``) holds trees of the net-10 phi net that
    the port loads, three finite losses and the 192 labels its steps used."""
    from pathlib import Path

    from admmnet_tpu_torch.train.checkpoint import msgpack_decode

    path = Path(__file__).resolve().parent / "golden" / "phinet_train_golden.msgpack"
    gold = msgpack_decode(path.read_bytes())
    assert set(gold) == {"init", "after", "losses", "phi"}
    mcfg = tcfg.ModelConfig(spec=tcfg.ProblemSpec(Nb=10, Nd=10, L_max=3), num_layers=10,
                            g_mode="chebyshev", cheb_impl="pallas")
    model = PhiEstADMMNet(mcfg)
    for key in ("init", "after"):
        model.load_state_dict(params_from_jax(gold[key]["params"], mcfg))
    assert gold["losses"].shape == (3,) and np.isfinite(gold["losses"]).all()
    assert gold["phi"].shape == (192, 100) and gold["phi"].dtype == np.complex64
    assert np.isfinite(gold["phi"]).all()
