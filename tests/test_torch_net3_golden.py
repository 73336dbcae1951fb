"""The learned path's fp32 gate on the CPU: the committed net-3
(runs/train_net3_r05: chebyshev GLayer on the Clenshaw engine, spectrum
head) through the port's plain versions on the 512 random-SNR scenes of
random512_key42.npz, as one batch, against the JAX package's output on the
CPU (net3_random512_jax.npz, tests/golden/make_net3_golden.py).

On the card the Clenshaw products run at the TPU's one-pass tier, so
chip_smoke.py phase 11 holds the kernel route to a limit that one-pass
rounding needs; the tight fp32 gate lives here.  Tolerances: phi per scene
within 2e-5 at the median and 5e-5 at the worst scene, fp32 sums in
another order through three layers (measured 1.9e-6 / 5.2e-6); the matched
F1 within 0.005 of the golden's (one flipped match of the 384 targets
moves it 0.0026; measured equal).  Needs no JAX.
"""

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402


def test_net3_plain_path_matches_the_jax_golden():
    torch.set_num_threads(4)
    r = chip_smoke.net3_vs_golden(torch.device("cpu"))
    assert r["med"] < 2e-5 and r["mx"] < 5e-5
    assert abs(r["st"]["f1"] - r["gst"]["f1"]) <= chip_smoke.F1_BAND
