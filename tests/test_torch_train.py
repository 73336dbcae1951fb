"""Port parity: the training path -- signal ops, dataset generation, losses,
the SGDR schedule, the optimizer step, checkpoints and the training CLI.

The same numpy inputs go through the JAX package and the port.  Random
draws cannot be matched (jax.random and torch.Generator differ), so the
generator's deterministic part is fed the port's draws on both sides (the
JAX draws are replaced for the test), and its distributions are checked
as ``tests/test_training.py`` checks the JAX package's.  Tolerances: fp32
on both sides with sums in another order; where the chebyshev GLayer
trains, the port runs the reversible backward and JAX autodiff through
the re-projected recurrence, which agree to ~1e-7 per gradient.
"""

import json
from pathlib import Path

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admmnet_tpu.core.config as jcfg
import admmnet_tpu.data.generator as jgen
import admmnet_tpu.ops.signal as jsig
import admmnet_tpu.train.losses as jloss
import admmnet_tpu_torch.core.config as tcfg
import admmnet_tpu_torch.data.generator as tgen
import admmnet_tpu_torch.ops.signal as tsig
import admmnet_tpu_torch.train.losses as tloss
from admmnet_tpu.models import ADMMNet as JADMMNet
from admmnet_tpu.train.checkpoint import restore_checkpoint as jrestore
from admmnet_tpu.train.schedules import sgdr_schedule as jsgdr
from admmnet_tpu.train.trainer import make_optimizer as jmake_optimizer
from admmnet_tpu.utils.host import cjit
from admmnet_tpu_torch.cli import generate_dataset, train_cli
from admmnet_tpu_torch.core.convert import flax_to_state_dict, options_from_jax, params_from_jax
from admmnet_tpu_torch.models import ADMMNet
from admmnet_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from admmnet_tpu_torch.train.schedules import sgdr_schedule
from admmnet_tpu_torch.train.trainer import clip_by_global_norm_, make_optimizer

torch.set_num_threads(1)  # JAX and torch share the cores of one test worker

SPEC = dict(Nb=4, Nd=4, L_max=2)
CLI_NET = ["--num-layers", "2", "--g-mode", "chebyshev", "--cheb-impl", "pallas",
           "--head", "spectrum", "--assignment", "perm", "--device", "cpu"]


def _rel(a, b):
    a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ---- configuration and signal ops -------------------------------------------


@pytest.mark.parametrize("name", ["DataConfig", "TrainConfig"])
def test_configs_equal_jax_field_by_field(name):
    j, t = getattr(jcfg, name)(), getattr(tcfg, name)()
    assert json.loads(jcfg.to_json(j)) == json.loads(tcfg.to_json(t))
    back = options_from_jax(j)
    assert type(back) is getattr(tcfg, name) and back == t
    assert options_from_jax(json.loads(jcfg.to_json(j))) == t


def test_psk_and_awgn_match_jax():
    rng = np.random.default_rng(0)
    data = rng.integers(0, 4, size=(6, 16))
    js = np.asarray(jsig.pskmod(jnp.asarray(data), 4, np.pi / 4))
    ts = tsig.pskmod(torch.from_numpy(data), 4, np.pi / 4).numpy()
    np.testing.assert_allclose(ts, js, atol=1e-6)
    noisy = ts + 0.4 * (rng.normal(size=ts.shape) + 1j * rng.normal(size=ts.shape))
    noisy = noisy.astype(np.complex64)
    assert np.array_equal(tsig.pskdemod(torch.from_numpy(noisy), 4, np.pi / 4).numpy(),
                          np.asarray(jsig.pskdemod(jnp.asarray(noisy), 4, np.pi / 4)))
    # awgn with the same unit draws: JAX's two normal draws replaced by ours
    nr, ni = rng.normal(size=ts.shape), rng.normal(size=ts.shape)
    draws = iter([jnp.asarray(nr, jnp.float32), jnp.asarray(ni, jnp.float32)])
    real_normal = jax.random.normal
    try:
        jax.random.normal = lambda key, shape, *a, **k: next(draws)
        jn = np.asarray(jsig.awgn(jax.random.PRNGKey(0), jnp.asarray(ts), 7.0))
    finally:
        jax.random.normal = real_normal
    tn = tsig.awgn(torch.from_numpy(ts), 7.0,
                   noise=torch.from_numpy((nr + 1j * ni).astype(np.complex64))).numpy()
    np.testing.assert_allclose(tn, jn, rtol=1e-6, atol=1e-6)


# ---- dataset generation -------------------------------------------------------


def test_scenes_from_draws_match_jax_generator(monkeypatch):
    """The deterministic part of generation: the port's draws replace JAX's
    in ``_generate_device``, call by call."""
    spec_j, spec_t = jcfg.ProblemSpec(**SPEC), tcfg.ProblemSpec(**SPEC)
    cfg_j = jcfg.DataConfig(spec=spec_j, snr_range=(5.0, 25.0))
    cfg_t = tcfg.DataConfig(spec=spec_t, snr_range=(5.0, 25.0))
    gen = torch.Generator().manual_seed(3)
    draws = tgen.draw_batch(cfg_t, 32, gen, "cpu")
    out_t = {k: v.numpy() for k, v in tgen.scenes_from_draws(cfg_t, draws).items()}
    d = {k: v.numpy() for k, v in draws.items()}
    queue = {"uniform": [d["tau"], d["f"], d["snr_w"]],
             "normal": [d["C"].real, d["C"].imag, d["demod_noise"].real,
                        d["demod_noise"].imag, d["w"].real, d["w"].imag],
             "randint": [d["data"]]}
    for fn in queue:
        monkeypatch.setattr(jax.random, fn, lambda *a, _q=queue[fn], **k: jnp.asarray(_q.pop(0)))
    out_j = {k: np.asarray(v) for k, v in jgen._generate_device(
        jax.random.PRNGKey(0), cfg_j, 32).items()}
    assert not any(queue.values())
    for k in ("tau", "f", "L_true", "ser"):
        np.testing.assert_array_equal(out_t[k], out_j[k])
    for k in ("y", "b", "C", "sigma"):
        assert _rel(out_t[k], out_j[k]) < 1e-6, k


def test_generate_batch_distributions():
    cfg = tcfg.DataConfig(spec=tcfg.ProblemSpec(Nb=4, Nd=4, L_max=2))
    d = tgen.generate_batch(cfg, 512, torch.Generator().manual_seed(0), "cpu")
    assert d["y"].shape == (512, 16) and d["y"].dtype == np.complex64
    assert d["tau"].min() >= 0.1 and d["tau"].max() <= 0.9
    assert d["f"].min() >= -0.4 and d["f"].max() <= 0.4
    np.testing.assert_allclose(np.abs(d["b"]), 1.0, atol=1e-5)
    assert np.all(d["sigma"] >= 1.0)
    assert d["L_true"].tolist() == [2] * 512
    assert abs(np.std(d["C"].real) - 0.7) < 0.1
    # QPSK at SNR_e = 7 dB: a symbol error rate of a few percent
    assert 1.0 < float(np.mean(d["ser"])) < 10.0


def test_label_phi_and_iterate_batches_match_jax():
    rng = np.random.default_rng(4)
    data = {"y": rng.normal(size=(10, 3)), "tau": np.arange(10.0)}
    for shuffle in (True, False):
        jb = list(jgen.iterate_batches(data, 4, shuffle=shuffle, seed=5))
        tb = list(tgen.iterate_batches(data, 4, shuffle=shuffle, seed=5))
        assert len(jb) == len(tb)
        for a, b in zip(jb, tb):
            assert all(np.array_equal(a[k], b[k]) for k in data)
    # labels: the port's classical solve (the fused_exact kernel's plain version)
    cfg = tcfg.DataConfig(spec=tcfg.ProblemSpec(Nb=4, Nd=4, L_max=2))
    d = tgen.generate_batch(cfg, 4, torch.Generator().manual_seed(1), "cpu")
    phi = tgen.label_phi(d["y"], d["b"], d["sigma"], iters=20, device="cpu")
    assert phi.shape == (4, 16) and phi.dtype == np.complex64 and np.isfinite(phi).all()


# ---- losses, schedule, optimizer ---------------------------------------------


def _loss_inputs(B=12, L=3, seed=6):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return dict(
        tau_pred=rng.uniform(0, 1, (B, L)).astype(f32),
        f_pred=rng.uniform(-0.5, 0.5, (B, L)).astype(f32),
        confidences=rng.uniform(0, 1, (B, L)).astype(f32),
        phi=(rng.normal(size=(B, 16)) + 1j * rng.normal(size=(B, 16))).astype(np.complex64),
        tau_true=rng.uniform(0.1, 0.9, (B, L)).astype(f32),
        f_true=rng.uniform(-0.4, 0.4, (B, L)).astype(f32),
        L_true=rng.integers(0, L + 1, B).astype(np.int32),
    )


@pytest.mark.parametrize("assignment, spectral_weight", [("slot", 0.0), ("perm", 0.5)])
def test_losses_match_jax(assignment, spectral_weight):
    x = _loss_inputs()
    args = ("tau_pred", "f_pred", "confidences", "phi", "tau_true", "f_true", "L_true")
    jt, jp = jloss.basic_anm_loss(*(jnp.asarray(x[k]) for k in args), assignment=assignment,
                                  spectral_weight=spectral_weight,
                                  spec=jcfg.ProblemSpec(Nb=4, Nd=4, L_max=3))
    tt, tp = tloss.basic_anm_loss(*(torch.from_numpy(x[k]) for k in args),
                                  assignment=assignment, spectral_weight=spectral_weight,
                                  spec=tcfg.ProblemSpec(Nb=4, Nd=4, L_max=3))
    assert set(jp) == set(tp)
    for k in jp:
        assert abs(float(tp[k]) - float(jp[k])) <= 1e-6 * abs(float(jp[k])) + 1e-9, k
    assert abs(float(tt) - float(jt)) <= 1e-6 * abs(float(jt))


def test_sgdr_schedule_matches_optax_over_the_recipe():
    """Every step of the net-3 recipe (15 epochs of 27 steps; the trainer
    runs 28 batches an epoch, so past the last cycle boundary too)."""
    j, t = jsgdr(1e-3, 27, 15), sgdr_schedule(1e-3, 27, 15)
    jv = np.asarray(jax.vmap(j)(jnp.arange(15 * 28)))
    tv = np.array([t(i) for i in range(15 * 28)])
    np.testing.assert_allclose(tv, jv, rtol=2e-6, atol=0)
    assert abs(t(0) - 1e-3) < 1e-10 and abs(t(270) - 1e-3) < 1e-10  # float32 lr


def test_optimizer_steps_match_optax():
    """Two AdamW steps (trunk group at 0.5x lr, weight decay, global-norm
    clipping at 1.0 triggered on the first step) on the same gradients."""
    mcfg_j = jcfg.ModelConfig(spec=jcfg.ProblemSpec(**SPEC), num_layers=1, g_mode="chebyshev",
                              cheb_degree=8, head="spectrum")
    mcfg_t = options_from_jax(mcfg_j)
    rng = np.random.default_rng(7)
    y = (rng.normal(size=(2, 16)) + 1j * rng.normal(size=(2, 16))).astype(np.complex64)
    params = cjit(lambda k, y, b, s: JADMMNet(cfg=mcfg_j).init(k, y, b, s))(
        jax.random.PRNGKey(0), y, y, np.ones(2, np.float32))
    grads = [jax.tree.map(lambda p, s=s: jnp.asarray(
        rng.normal(size=np.shape(p)).astype(np.float32) * s), params) for s in (3.0, 0.01)]
    tc = jcfg.TrainConfig()
    tx = jmake_optimizer(tc, steps_per_epoch=27)
    state = tx.init(params)
    update = jax.jit(tx.update)
    pj = params
    for g in grads:
        upd, state = update(g, state, pj)
        pj = jax.tree.map(lambda p, u: p + u, pj, upd)

    model = ADMMNet(mcfg_t)
    model.load_state_dict(params_from_jax(params["params"], mcfg_t))
    opt = make_optimizer(model, options_from_jax(tc))
    sched = sgdr_schedule(tc.lr, 27, tc.epochs)
    assert {g["name"]: g["scale"] for g in opt.param_groups} == {"admm": 0.5, "other": 1.0}
    for i, g in enumerate(grads):
        sd = flax_to_state_dict(g["params"])
        for name, p in model.named_parameters():
            p.grad = sd[name].clone()
        for group in opt.param_groups:
            group["lr"] = group["scale"] * sched(i)
        norm = clip_by_global_norm_(list(model.parameters()), tc.grad_clip)
        assert (float(norm) > 1.0) == (i == 0)
        opt.step()
    want, got = flax_to_state_dict(pj["params"]), model.state_dict()
    init = flax_to_state_dict(params["params"])
    for k in want:  # the change, to 1e-4 of its size and a few ulps of the parameter
        dw, dg = (want[k] - init[k]).numpy(), (got[k] - init[k]).numpy()
        ulps = 4 * np.finfo(np.float32).eps * float(np.max(np.abs(want[k].numpy())))
        assert float(np.max(np.abs(dg - dw))) <= 1e-4 * float(np.max(np.abs(dw))) + ulps, k


# ---- checkpoints and the training CLI --------------------------------------


@pytest.fixture(scope="module")
def tiny_dataset(tmp_path_factory):
    """60 scenes (42 / 9 / 9) at Nb = Nd = 4, L_max = 2, made by the CLI."""
    out = tmp_path_factory.mktemp("ds")
    generate_dataset.main(["--out", str(out), "--total", "60", "--Nb", "4", "--Nd", "4",
                           "--L-max", "2", "--fixed-snr", "20", "--seed", "13",
                           "--device", "cpu"])
    return out


def _jax_init_dir(tmp_path, data_dir, mcfg_j, seed=0):
    """The JAX trainer's init for ``seed``, as a checkpoint directory."""
    train = jgen.DatasetGenerator(data_dir=data_dir).load_split("train")
    params = cjit(lambda k, y, b, s: JADMMNet(cfg=mcfg_j).init(k, y, b, s))(
        jax.random.PRNGKey(seed), train["y"][:2], train["b"][:2], train["sigma"][:2])
    d = tmp_path / "jax_init"
    d.mkdir()
    (d / "best_model.msgpack").write_bytes(flax.serialization.to_bytes({"params": params}))
    (d / "metadata.json").write_text("{}")
    return d


def test_train_cli_matches_jax_trainer(tiny_dataset, tmp_path, monkeypatch):
    """Two epochs from the same init on the same arrays: the port's
    ``train_cli`` and the JAX trainer (numpy minibatch order on both sides).
    Tolerance 1e-4 relative per epoch loss: the two backward passes through
    the Clenshaw recurrence differ at ~1e-7 and the spectrum head's argmax
    cells can amplify that slightly over 6 steps."""
    from admmnet_tpu.train.trainer import train_admmnet as jtrain

    monkeypatch.setattr("admmnet_tpu.data.loader.native_available", lambda: False)
    monkeypatch.setattr("admmnet_tpu_torch.data.loader.native_available", lambda: False)
    spec = jcfg.ProblemSpec(**SPEC)
    mcfg_j = jcfg.ModelConfig(spec=spec, num_layers=2, g_mode="chebyshev",
                              cheb_impl="pallas", head="spectrum")
    init_dir = _jax_init_dir(tmp_path, tiny_dataset, mcfg_j)
    g = jgen.DatasetGenerator(data_dir=tiny_dataset)
    splits = [g.load_split(s) for s in ("train", "val", "test")]
    tc = jcfg.TrainConfig(batch_size=16, epochs=2, assignment="perm", spectral_weight=0.5)
    jres = jtrain(mcfg_j, tc, *splits, workdir=str(tmp_path / "jax"), log_fn=lambda m: None)

    work = tmp_path / "port"
    train_cli.main(["--data", str(tiny_dataset), "--workdir", str(work), "--epochs", "2",
                    "--batch-size", "16", "--init-from", str(init_dir), *CLI_NET])
    hist = json.loads((work / "training_history.json").read_text())
    for k in ("train_loss", "val_loss", "tau_rmse", "f_rmse"):
        np.testing.assert_allclose(hist[k], jres.history[k], rtol=1e-4, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(hist["lr"], jres.history["lr"], rtol=2e-6)
    test = json.loads((work / "test_result.json").read_text())
    assert set(test) == set(jres.test_metrics)
    assert test["matched_f1"] == jres.test_metrics["matched_f1"]


def test_jax_reads_the_port_checkpoint(tiny_dataset, tmp_path):
    """What the port's train_cli writes, the JAX package's
    ``restore_checkpoint`` reads, and ``ADMMNet.apply`` on those parameters
    reproduces the port's forward; the port's own reader round-trips it."""
    work = tmp_path / "port"
    train_cli.main(["--data", str(tiny_dataset), "--workdir", str(work), "--epochs", "1",
                    "--batch-size", "16", *CLI_NET])
    cfg = options_from_jax(json.loads((work / "config.json").read_text())["model"])
    mcfg_j = jcfg._from_dict(jcfg.ModelConfig,
                             json.loads((work / "config.json").read_text())["model"])
    test = tgen.DatasetGenerator(data_dir=tiny_dataset).load_split("test")
    y, b, s = (test[k].astype(np.complex64 if k != "sigma" else np.float32)
               for k in ("y", "b", "sigma"))
    template = cjit(lambda k, y, b, s: JADMMNet(cfg=mcfg_j).init(k, y, b, s))(
        jax.random.PRNGKey(1), y[:2], b[:2], s[:2])
    state, meta = jrestore(work, {"params": template, "opt_state": None})
    assert set(meta) == {"epoch", "best_val_loss", "history", "mode"}
    jout = cjit(JADMMNet(cfg=mcfg_j).apply)(state["params"], y, b, s)

    tstate, _ = restore_checkpoint(work)
    model = ADMMNet(cfg)
    model.load_state_dict(params_from_jax(tstate["params"]["params"], cfg))
    with torch.no_grad():
        tout = model.eval()(*(torch.from_numpy(a) for a in (y, b, s)))
    assert _rel(tout[3].numpy(), jout[3]) < 1e-5  # phi
    # tau, f, conf: the head's hard-argmax zoom may pick a neighbouring
    # cell on a near tie, one step (4e-4) of the last refinement window
    for a, j in zip(tout[:3], jout[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(j), rtol=0, atol=1e-3)


def test_port_resumes_from_its_checkpoint(tiny_dataset, tmp_path):
    """One epoch, then a second run in the same workdir resumes (params and
    AdamW state) and lands where an uninterrupted two-epoch run does.  The
    train split (42 scenes) is cut to 32 so that no epoch has a short last
    batch: the step counter resumes at epochs x (N // batch), as in JAX."""
    g = tgen.DatasetGenerator(data_dir=tiny_dataset)
    data = tmp_path / "ds32"
    g2 = tgen.DatasetGenerator(data_dir=data)
    g2._save_split("train", {k: v[:32] for k, v in g.load_split("train").items()})
    for s in ("val", "test"):
        g2._save_split(s, g.load_split(s))
    (data / "dataset_config.json").write_text(json.dumps(g.dataset_config()))
    args = ["--data", str(data), "--batch-size", "16", *CLI_NET]
    train_cli.main(args + ["--workdir", str(tmp_path / "a"), "--epochs", "1"])
    state, meta = restore_checkpoint(tmp_path / "a")
    assert state["opt_state"]["step"] == 2 and meta["epoch"] == 0
    train_cli.main(args + ["--workdir", str(tmp_path / "a"), "--epochs", "2"])
    train_cli.main(args + ["--workdir", str(tmp_path / "b"), "--epochs", "2"])
    ha, hb = (json.loads((tmp_path / w / "training_history.json").read_text())
              for w in "ab")
    assert len(ha["val_loss"]) == 2
    np.testing.assert_allclose(ha["val_loss"], hb["val_loss"], rtol=1e-6)
    np.testing.assert_allclose(ha["train_loss"], hb["train_loss"], rtol=1e-6)


def test_save_checkpoint_is_flax_msgpack(tmp_path):
    state = {"params": {"params": {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
                                   "s": np.array(0.5, np.float32)}},
             "opt_state": {"step": 3}}
    save_checkpoint(tmp_path, state, {"epoch": 1})
    raw = (tmp_path / "best_model.msgpack").read_bytes()
    assert raw == flax.serialization.to_bytes(state)
    assert not list(tmp_path.glob("*.tmp"))
    back, meta = restore_checkpoint(tmp_path)
    assert meta == {"epoch": 1} and back["opt_state"]["step"] == 3
    assert np.array_equal(back["params"]["params"]["w"], state["params"]["params"]["w"])


# ---- initialization and dropout ------------------------------------------------


def test_dense_init_is_flax_lecun_normal():
    """The port's Dense draws as flax's nn.Dense: a normal of variance
    1 / fan_in truncated at two standard deviations of the untruncated
    normal, and a zero bias."""
    import flax.linen as nn

    from admmnet_tpu_torch.models.layers import Dense

    torch.manual_seed(0)
    t = Dense(300, 400)
    j = nn.Dense(400).init(jax.random.PRNGKey(0), jnp.zeros((1, 300)))["params"]
    wt, wj = t.weight.detach().numpy().T, np.asarray(j["kernel"])
    assert wt.shape == wj.shape and not t.bias.detach().any() and not np.asarray(j["bias"]).any()
    assert abs(wt.std() / wj.std() - 1.0) < 0.01
    assert abs(wt.std() - (1.0 / 300) ** 0.5) < 0.01 * (1.0 / 300) ** 0.5
    assert np.abs(wt).max() <= 2.0 * (1.0 / 300) ** 0.5 / 0.8796256610342398 + 1e-7


def test_attention_dropout_in_train_mode_only(monkeypatch):
    """The attention head's dropout acts in train() mode only, with one keep
    mask over the grid shared by the batch and the heads (flax's
    broadcast_dropout), drawn from the head's generator."""
    from admmnet_tpu_torch.models import peak_head
    from admmnet_tpu_torch.models.peak_head import PeakSearchHead

    head = PeakSearchHead(4, 4, hidden_dim=32, num_heads=4)
    phi = torch.from_numpy(_loss_inputs()["phi"])
    with torch.no_grad():
        ref = head.eval()(phi)
        head.train()
        head.attention.dropout_generator = torch.Generator().manual_seed(1)
        a = head(phi)
        head.attention.dropout_generator = torch.Generator().manual_seed(1)
        b = head(phi)
        with monkeypatch.context() as mp:  # rate 0: train() is eval()
            mp.setattr(peak_head, "ATTENTION_DROPOUT", 0.0)
            c = head(phi)
    assert not torch.equal(a[0], ref[0])
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.equal(x, y) for x, y in zip(c, ref))
    # the keep mask is one draw over the 16 grid cells
    attn = head.attention
    g = torch.Generator().manual_seed(1)
    keep = (torch.rand(16, generator=g) < 0.9).float() / 0.9
    x = torch.randn(3, 32)
    kv = torch.randn(16, 32)
    attn.dropout_generator = torch.Generator().manual_seed(1)
    with torch.no_grad():
        H, D = attn.num_heads, attn.head_dim
        q = attn.query(x).reshape(3, H, D) / D**0.5
        w = torch.softmax(torch.einsum("bhd,khd->bhk", q, attn.key(kv).reshape(16, H, D)), -1)
        o = torch.einsum("bhk,khd->bhd", w * keep, attn.value(kv).reshape(16, H, D))
        torch.testing.assert_close(attn(x, kv), attn.out(o.reshape(3, H * D)))
