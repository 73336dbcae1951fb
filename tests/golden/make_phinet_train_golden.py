"""Write phinet_train_golden.msgpack: three phi-regression training steps of
a net-10 PhiEstADMMNet in the JAX package, on the CPU, from its seed-0 init.

The model is the phi route's net: ``PhiEstADMMNet`` at runs/phi10's width
(10 layers, hidden 128, MN = 100) with the chebyshev GLayer of
runs/spec50k_warm's trunk (degree 48, cheb_impl="pallas").  The recipe is
trainPhi.py's as the trainer runs it with ``train_cli --phi``: the
PhiAlignment loss, AdamW at lr 5e-3 with every parameter in the trunk's
0.5x group, weight decay 1e-3, clip 1.0, SGDR over 5 epochs of 13 steps
(the 3500-scene training split of a 5000-scene dataset at batch 256).
The init is ``model.init(PRNGKey(0), ...)``, the trainer's init for seed 0.
The three batches are scenes 0-63, 64-127 and 128-191 of
random512_key42.npz, in order, labelled by the JAX package's ``label_phi``
(100 iterations of the default fused_exact solve, which off the TPU runs
the per-step polar solve).  Off the TPU, the JAX GLayer's pallas engine
evaluates the Clenshaw recurrence in fp32 with the per-step Hermitian
re-projection and trains through XLA autodiff.

Stored (flax msgpack): ``init`` and ``after`` (the variables
``{"params": tree}`` before and after the three steps), ``losses`` (3,)
float32, each step's loss before its update, and ``phi`` (192, 100)
complex64, the labels the steps used.

Run from the repository root: python tests/golden/make_phinet_train_golden.py
"""

import sys
from pathlib import Path

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")
ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import flax.serialization  # noqa: E402

from admmnet_tpu.core.config import ModelConfig, ProblemSpec, TrainConfig  # noqa: E402
from admmnet_tpu.data.generator import label_phi  # noqa: E402
from admmnet_tpu.models import PhiEstADMMNet  # noqa: E402
from admmnet_tpu.train.trainer import build_steps, make_optimizer  # noqa: E402
from admmnet_tpu.utils.host import cjit, to_host  # noqa: E402

HERE = Path(__file__).resolve().parent
STEPS, BATCH, STEPS_PER_EPOCH = 3, 64, 13
MODEL = ModelConfig(spec=ProblemSpec(Nb=10, Nd=10, L_max=3), num_layers=10,
                    g_mode="chebyshev", cheb_impl="pallas")
TRAIN = TrainConfig(batch_size=256, epochs=5, lr=5e-3, patience=100, seed=0)


def main():
    with np.load(HERE / "random512_key42.npz") as d:
        raw = {k: d[k][:STEPS * BATCH] for k in ("y", "b", "sigma")}
    raw["phi"] = np.asarray(label_phi(raw["y"], raw["b"], raw["sigma"]), np.complex64)
    model = PhiEstADMMNet(cfg=MODEL)
    params = cjit(lambda key, y, b, s: model.init(key, y, b, s))(
        jax.random.PRNGKey(TRAIN.seed), raw["y"][:2], raw["b"][:2], raw["sigma"][:2])
    init = to_host(params)
    tx = make_optimizer(TRAIN, STEPS_PER_EPOCH, admm_modules=PhiEstADMMNet.ADMM_LR_MODULES)
    opt_state = tx.init(params)
    train_step, _ = build_steps(model, tx, "phi")
    step = cjit(train_step)
    losses = []
    for i in range(STEPS):
        batch = {k: v[i * BATCH:(i + 1) * BATCH] for k, v in raw.items()}
        params, opt_state, total = step(params, opt_state, batch, jax.random.PRNGKey(i))
        losses.append(float(total))
    (HERE / "phinet_train_golden.msgpack").write_bytes(flax.serialization.msgpack_serialize({
        "init": init, "after": to_host(params), "losses": np.asarray(losses, np.float32),
        "phi": raw["phi"]}))
    print("losses", losses)


if __name__ == "__main__":
    main()
