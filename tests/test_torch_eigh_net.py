"""Upstream's published ADMM-Net (eigh GLayers, the attention head) in the
port's plain path against the benchmark's plain reference
(gpubench/reference/learned_eigh_deploy.py) and against the JAX package,
on seeded random weights at a small size; and the benchmark's weights
reader for nets with the attention head against the port's own renaming.

Tolerances: every side computes the eigendecompositions in complex128 (the
port's CPU route, the reference's LAPACK, JAX's eigh of its complex64
input in the CPU's own precision for the JAX side) and the rest in float32,
so phi and the head's outputs agree to float32 rounding carried through
the layers: 1e-4 (tests/test_torch_models.py's TOL).
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import admmnet_tpu.core.config as jcfg
from admmnet_tpu.models import ADMMNet as JADMMNet
from admmnet_tpu_torch.core.config import ModelConfig, ProblemSpec
from admmnet_tpu_torch.core.convert import flax_to_state_dict, options_from_jax, params_from_jax
from admmnet_tpu_torch.models import ADMMNet
from admmnet_tpu_torch.train.checkpoint import restore_checkpoint

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gpubench import attention_weights  # noqa: E402
from gpubench.reference import learned_eigh_deploy as ref  # noqa: E402

torch.set_num_threads(1)  # JAX and torch share the cores of one test worker
TOL = 1e-4
SPEC = {"Nb": 4, "Nd": 4, "L_max": 2}
MODEL = {"num_layers": 4, "hidden_dim": 32, "num_heads": 4, "correction_hidden": 16,
         "value_net_hidden": 8, "scale_net_hidden": 8, "with_peak_head": True,
         "epsilon": 1e-8, "ref_stop_gradients": True, "learned_sensing": False,
         "g_mode": "eigh", "cheb_degree": 48, "head": "attention"}
B = 8


def _scenes():
    rng = np.random.default_rng(7)
    n = SPEC["Nb"] * SPEC["Nd"]

    def cplx(*shape):
        return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)

    return cplx(B, n), cplx(B, n), rng.uniform(1.0, 1.5, size=B).astype(np.float32)


def _random_net():
    """(flax params, port state_dict) of a seeded random net: flax's init
    plus noise, so the scalars leave their initial values."""
    jc = jcfg._from_dict(jcfg.ModelConfig, dict(MODEL, spec=SPEC))
    y, b, s = _scenes()
    params = JADMMNet(cfg=jc).init(jax.random.PRNGKey(3), *map(jnp.asarray, (y, b, s)))["params"]
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + (0.1 * rng.normal(size=np.shape(x))).astype(np.float32),
        params)
    return jc, params, flax_to_state_dict(params)


def _port(sd):
    cfg = ModelConfig(spec=ProblemSpec(**SPEC), **MODEL)
    net = ADMMNet(cfg)
    net.load_state_dict(sd)
    return net.eval()


def _rel(a, b):
    a, b = np.asarray(a).reshape(len(a), -1), np.asarray(b).reshape(len(b), -1)
    return float(np.max(np.linalg.norm(a - b, axis=-1) / np.linalg.norm(b, axis=-1)))


def test_eigh_net_matches_the_plain_reference():
    _, _, sd = _random_net()
    y, b, s = map(torch.from_numpy, _scenes())
    with torch.no_grad():
        tau, f, conf, phi = _port(sd)(y, b, s)
        config = {"spec": SPEC, "model": MODEL}
        tiers = {"eigh": "fp32", "rebuild": "fp32", "head": "fp32"}
        phi_ref = ref.trunk(y, b, s, sd, config, tiers)
        out_ref = ref.head(phi, sd, config, "fp32")
    assert _rel(phi.numpy(), phi_ref.numpy()) < TOL
    for o, r in zip((tau, f, conf), out_ref):
        np.testing.assert_allclose(o.numpy(), r.numpy(), atol=TOL, rtol=0)


@pytest.mark.parametrize("fault", ["eigenvalues_reversed", "v_unconjugated", "softmax_heads"])
def test_reference_faults_move_the_outputs(fault):
    """Each fault the benchmark's comparison must catch moves phi or the
    head's outputs far beyond the tolerance."""
    _, _, sd = _random_net()
    y, b, s = map(torch.from_numpy, _scenes())
    config = {"spec": SPEC, "model": MODEL}
    tiers = {"eigh": "fp32", "rebuild": "fp32", "head": "fp32"}
    with torch.no_grad():
        phi = ref.trunk(y, b, s, sd, config, tiers)
        out = ref.head(phi, sd, config, "fp32")
        phi_f = ref.trunk(y, b, s, sd, config, tiers, fault)
        out_f = ref.head(phi, sd, config, "fp32", fault)
    moved = max(_rel(phi_f.numpy(), phi.numpy()),
                max(float((a - c).abs().max()) for a, c in zip(out_f, out)))
    assert moved > 100 * TOL


def test_eigh_net_matches_jax():
    jc, params, sd = _random_net()
    args = _scenes()
    jout = JADMMNet(cfg=jc).apply({"params": params}, *map(jnp.asarray, args))
    with torch.no_grad():
        out = _port(sd)(*map(torch.from_numpy, args))
    assert _rel(out[3].numpy(), jout[3]) < TOL
    for o, r in zip(out[:3], jout[:3]):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=TOL, rtol=0)


def test_attention_weights_reader_matches_params_from_jax():
    """gpubench's reader of runs/admmnet10 (the benchmark's copy) gives the
    port's state_dict bit for bit."""
    sd = attention_weights.state_dict(ROOT / "gpubench" / "weights" /
                                      "admmnet10-eigh-10x10.msgpack")
    state, _ = restore_checkpoint(ROOT / "runs" / "admmnet10")
    cfg = options_from_jax(json.loads((ROOT / "runs" / "admmnet10" / "config.json").read_text())
                           ["model"])
    want = params_from_jax(state["params"]["params"], cfg)
    assert set(sd) == set(want)
    for k, v in want.items():
        assert sd[k].shape == v.shape and torch.equal(sd[k], v), k


def test_eigh_net_train_step_matches_jax(monkeypatch):
    """One step of upstream's training of the eigh net from the same weights
    on the same batch: the port's ``build_steps(mode="e2e")`` against the
    JAX package's ``jax.value_and_grad`` of ``basic_anm_loss`` and its
    trainer's optimizer (clip 1.0, AdamW in two groups), the head's dropout
    off on both sides.  The loss, every leaf's clipped gradient and every
    leaf after the update, each leaf's distance over the largest leaf norm
    of the JAX side's.  Tolerances: the forward's 1e-4 (module docstring)
    for the loss and the gradient, which the eigensolves' precisions carry
    through the backward alike; 1e-4 for the update, whose AdamW first step
    moves each element by about the learning rate whatever the gradient's
    size, so a leaf's gradient near zero can move it by up to lr."""
    import optax

    from admmnet_tpu.train.losses import basic_anm_loss as jloss
    from admmnet_tpu.train.trainer import make_optimizer as jmake_optimizer
    from admmnet_tpu_torch.core.config import TrainConfig
    from admmnet_tpu_torch.models import peak_head
    from admmnet_tpu_torch.train.schedules import sgdr_schedule
    from admmnet_tpu_torch.train.trainer import build_steps, make_optimizer

    jc, params, sd = _random_net()
    y, b, s = _scenes()
    rng = np.random.default_rng(9)
    L = SPEC["L_max"]
    tau = rng.uniform(0.1, 0.9, size=(B, L)).astype(np.float32)
    f = rng.uniform(-0.4, 0.4, size=(B, L)).astype(np.float32)
    L_true = rng.integers(0, L + 1, size=B).astype(np.int32)
    train = {"batch_size": B, "epochs": 4, "lr": 1e-3, "admm_lr_scale": 0.5,
             "weight_decay": 1e-3, "grad_clip": 1.0, "sgdr_t0": 1, "sgdr_t_mult": 2,
             "lr_min": 1e-6, "assignment": "slot", "spectral_weight": 0.0}
    per_epoch = 3

    model = JADMMNet(cfg=jc)

    def loss(p):
        tau_p, f_p, conf, phi = model.apply({"params": p}, *map(jnp.asarray, (y, b, s)),
                                            deterministic=True)
        return jloss(tau_p, f_p, conf, phi, tau, f, L_true, assignment="slot",
                     spectral_weight=0.0, spec=jc.spec)[0]

    p0 = jax.tree_util.tree_map(jnp.asarray, params)
    j_loss, j_grad = jax.value_and_grad(loss)(p0)
    clip = optax.clip_by_global_norm(train["grad_clip"])
    j_clipped = flax_to_state_dict(clip.update(j_grad, clip.init(p0))[0])
    tx = jmake_optimizer(jcfg._from_dict(jcfg.TrainConfig, train), per_epoch,
                         admm_modules=JADMMNet.ADMM_LR_MODULES)
    updates, _ = tx.update(j_grad, tx.init(p0), p0)
    j_after = flax_to_state_dict(optax.apply_updates(p0, updates))

    monkeypatch.setattr(peak_head, "ATTENTION_DROPOUT", 0.0)
    net = _port(sd)
    tcfg = TrainConfig(**train)
    opt = make_optimizer(net, tcfg)
    schedule = sgdr_schedule(tcfg.lr, per_epoch, tcfg.epochs, tcfg.sgdr_t0, tcfg.sgdr_t_mult,
                             tcfg.lr_min)
    step, _ = build_steps(net, opt, "e2e", schedule, grad_clip=tcfg.grad_clip,
                          assignment="slot", spectral_weight=0.0)
    batch = {"y": y, "b": b, "sigma": s, "tau": tau, "f": f, "L_true": L_true}
    t_loss = float(step({k: torch.from_numpy(v) for k, v in batch.items()}, 0))
    leaves = dict(net.named_parameters())
    assert set(leaves) == set(j_clipped) == set(j_after)

    def gap(x, ref):
        top = max(float(np.linalg.norm(np.asarray(v))) for v in ref.values())
        return max(float(np.linalg.norm(x[k].detach().numpy() - np.asarray(ref[k]))) / top
                   for k in ref)

    assert abs(t_loss - float(j_loss)) <= TOL * abs(float(j_loss))
    assert gap({k: p.grad for k, p in leaves.items()}, j_clipped) <= TOL
    assert gap(leaves, j_after) <= TOL
