"""Write net3_train_golden.msgpack: three training steps of the net-3 recipe
in the JAX package, on the CPU, from its seed-0 init.

The model and the recipe are runs/train_net3_r05/config.json (3 layers,
chebyshev GLayer with cheb_impl="pallas", spectrum head, assignment
"perm", spectral weight 0.5, AdamW lr 1e-3 with the trunk at 0.5x,
weight decay 1e-3, clip 1.0, SGDR over 15 epochs of 27 steps: the
schedule of the 7000-scene training split at batch 256).  The init is
``model.init(PRNGKey(0), ...)``, the trainer's init for seed 0.  The three
batches are scenes 0-63, 64-127 and 128-191 of random512_key42.npz, in
order, with 3 targets each; the spectrum head has no dropout.  Off the
TPU, the JAX GLayer's pallas engine evaluates the Clenshaw recurrence in
fp32 with the per-step Hermitian re-projection and trains through XLA
autodiff.

Stored (flax msgpack): ``init`` and ``after`` (the variables
``{"params": tree}`` before and after the three steps) and ``losses``
(3,) float32, each step's loss before its update.

Run from the repository root: python tests/golden/make_net3_train_golden.py
"""

import json
import sys
from pathlib import Path

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")
ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import flax.serialization  # noqa: E402

from admmnet_tpu.core.config import ModelConfig, ProblemSpec, TrainConfig  # noqa: E402
from admmnet_tpu.models import ADMMNet  # noqa: E402
from admmnet_tpu.train.trainer import build_steps, make_optimizer  # noqa: E402
from admmnet_tpu.utils.host import cjit, to_host  # noqa: E402

RUN = ROOT / "runs" / "train_net3_r05"
HERE = Path(__file__).resolve().parent
STEPS, BATCH, STEPS_PER_EPOCH = 3, 64, 27


def main():
    cfg = json.loads((RUN / "config.json").read_text())
    mcfg = ModelConfig(**{**cfg["model"], "spec": ProblemSpec(**cfg["model"]["spec"])})
    tcfg = TrainConfig(**cfg["train"])
    with np.load(HERE / "random512_key42.npz") as d:
        raw = {k: d[k] for k in d.files}
    raw["L_true"] = np.full(len(raw["y"]), mcfg.spec.L_max, np.int32)
    model = ADMMNet(cfg=mcfg)
    params = cjit(lambda key, y, b, s: model.init(key, y, b, s))(
        jax.random.PRNGKey(tcfg.seed), raw["y"][:2], raw["b"][:2], raw["sigma"][:2])
    init = to_host(params)
    tx = make_optimizer(tcfg, STEPS_PER_EPOCH)
    opt_state = tx.init(params)
    train_step, _ = build_steps(model, tx, "e2e", assignment=tcfg.assignment,
                                spectral_weight=tcfg.spectral_weight)
    step = cjit(train_step)
    losses = []
    for i in range(STEPS):
        batch = {k: v[i * BATCH:(i + 1) * BATCH] for k, v in raw.items()}
        params, opt_state, total = step(params, opt_state, batch, jax.random.PRNGKey(i))
        losses.append(float(total))
    (HERE / "net3_train_golden.msgpack").write_bytes(flax.serialization.msgpack_serialize({
        "init": init, "after": to_host(params), "losses": np.asarray(losses, np.float32)}))
    print("losses", losses)


if __name__ == "__main__":
    main()
