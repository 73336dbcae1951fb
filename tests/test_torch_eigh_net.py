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
