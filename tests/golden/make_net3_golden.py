"""Write net3_random512_jax.npz: the JAX package's net-3 output on the 512
random-SNR scenes of random512_key42.npz, evaluated on the CPU as one batch.

The checkpoint is runs/train_net3_r05 (chebyshev GLayer, cheb_impl="pallas",
spectrum head).  Off the TPU, the JAX GLayer's pallas engine evaluates the
Clenshaw recurrence in fp32 with the per-step Hermitian re-projection, so
this file is the fp32 reference of the port's learned path.  Stored: the
raw head outputs ``tau``, ``f``, ``conf`` (512, 3) float32, in head order,
and the trunk's ``phi`` (512, 100) complex64.

Run from the repository root: python tests/golden/make_net3_golden.py
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

from admmnet_tpu.core.config import ModelConfig, ProblemSpec  # noqa: E402
from admmnet_tpu.models import ADMMNet  # noqa: E402

RUN = ROOT / "runs" / "train_net3_r05"
HERE = Path(__file__).resolve().parent


def main():
    cfg = json.loads((RUN / "config.json").read_text())["model"]
    cfg = ModelConfig(**{**cfg, "spec": ProblemSpec(**cfg["spec"])})
    state = flax.serialization.msgpack_restore((RUN / "best_model.msgpack").read_bytes())
    with np.load(HERE / "random512_key42.npz") as d:
        y, b, sigma = d["y"], d["b"], d["sigma"]
    tau, f, conf, phi = jax.jit(ADMMNet(cfg=cfg).apply)(state["params"], y, b, sigma)
    np.savez_compressed(
        HERE / "net3_random512_jax.npz",
        tau=np.asarray(tau, np.float32), f=np.asarray(f, np.float32),
        conf=np.asarray(conf, np.float32), phi=np.asarray(phi, np.complex64),
    )


if __name__ == "__main__":
    main()
