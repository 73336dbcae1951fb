"""The bundled ``data.npz`` anchor case -- the reproducibility benchmark.

The reference ships 100 QPSK symbols ``sig`` and a demodulation-error vector
``e`` (6 symbol errors, SER 6%) and rebuilds the same 3-target scenario in
main.py:8-95 and both timing benches (test/test_time_admm.py:50-60).  This
module reproduces that scenario construction, host-side in float64 numpy
(data prep is not a device hot path), with the reference's ``data_type``
modes.  It is the JAX package's ``data/anchor.py`` unchanged, so both
packages build bitwise the same batches:

- ``"fixed_e"``  (reference data_type=2): b = sig - e, deterministic symbols;
- ``"redemod"``  (reference data_type=1): fresh demod noise at snr_e on sig;
- ``"fresh"``    (reference data_type=0): brand-new random symbols.

The canonical anchor target set (reference main.py:14-17):
  f   = [-0.25, 0.0, 0.14]        (normalized Doppler)
  tau = [0.45, 0.25, 0.63]        (normalized delay)
  C   = [-0.5+1j, 0.6-0.2j, 0.3+0.7j]
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np

ANCHOR_TAU = np.array([0.45, 0.25, 0.63])
ANCHOR_F = np.array([-0.25, 0.0, 0.14])
ANCHOR_C = np.array([-0.5 + 1j, 0.6 - 0.2j, 0.3 + 0.7j])

_DEFAULT_PATHS = (
    Path(__file__).resolve().parents[2] / "data" / "data.npz",
    Path("data/data.npz"),
)


@dataclasses.dataclass
class AnchorScenario:
    """One constructed anchor instance (host numpy, float64)."""

    y: np.ndarray  # (n,) complex observation
    b: np.ndarray  # (n,) complex demodulated symbols
    sigma: float  # noise bound ||e/b|| + 1 (reference main.py:82)
    tau: np.ndarray  # (L,) ground-truth delays
    f: np.ndarray  # (L,) ground-truth dopplers
    C: np.ndarray  # (L,) ground-truth complex gains
    ser: float  # symbol error rate in percent
    Nb: int = 10
    Nd: int = 10


def _np_vander(start, stop, length):
    return np.exp(1j * 2 * np.pi * np.linspace(start, stop, length))


def _psi(tau, f, C, Nb, Nd):
    """Psi = sum_l C_l kron(s(f_l), conj(d(tau_l))) (reference main.py:19-29)."""
    cols = []
    for i in range(len(tau)):
        s = _np_vander(0, (Nb - 1) * f[i], Nb)
        d = _np_vander(0, (Nd - 1) * tau[i], Nd)
        cols.append(np.kron(s, np.conj(d)))
    return np.stack(cols, axis=1) @ C


def load_anchor_arrays(path: Optional[str] = None):
    """Load (sig, e) from data.npz."""
    if path is None:
        for p in _DEFAULT_PATHS:
            if p.exists():
                path = str(p)
                break
        else:
            raise FileNotFoundError("data.npz not found; pass an explicit path")
    with np.load(path) as d:
        return d["sig"], d["e"]


def load_anchor(
    mode: str = "fixed_e",
    snr_w: float = 20.0,
    snr_e: float = 7.0,
    rng: Optional[np.random.Generator] = None,
    path: Optional[str] = None,
    Nb: int = 10,
    Nd: int = 10,
) -> AnchorScenario:
    """Construct the anchor scenario per reference main.py:35-95."""
    rng = rng or np.random.default_rng(0)
    n = Nb * Nd

    if mode == "fresh":
        data = rng.integers(0, 4, n)
        sig = np.exp(1j * (2 * np.pi * data / 4 + np.pi / 4))
        e = None
    else:
        sig, e = load_anchor_arrays(path)

    if mode in ("fresh", "redemod"):
        # noisy demod: AWGN at snr_e, hard QPSK decision
        p = np.mean(np.abs(sig) ** 2)
        npow = p / 10 ** (snr_e / 10)
        noise = np.sqrt(npow / 2) * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
        ang = np.mod(np.angle(sig + noise) - np.pi / 4 + np.pi / 4, 2 * np.pi)
        data_d = np.floor(ang * 4 / (2 * np.pi)).astype(int) % 4
        b = np.exp(1j * (2 * np.pi * data_d / 4 + np.pi / 4))
        e = sig - b
    elif mode == "fixed_e":
        b = sig - e
    else:
        raise ValueError(f"unknown mode {mode!r}")

    ser = 100.0 * np.sum(np.abs(e) > 1e-10) / n

    Psi = _psi(ANCHOR_TAU, ANCHOR_F, ANCHOR_C, Nb, Nd)
    real_y = (b + e) * Psi  # diag(b+e) @ Psi
    w = np.sqrt(0.5) * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    w_var = np.linalg.norm(real_y) ** 2 / (10 ** (snr_w / 10) * n)
    y = real_y + np.sqrt(w_var) * w

    sigma = float(np.linalg.norm(e / b) + 1.0)
    return AnchorScenario(
        y=y, b=b, sigma=sigma, tau=ANCHOR_TAU.copy(), f=ANCHOR_F.copy(),
        C=ANCHOR_C.copy(), ser=ser, Nb=Nb, Nd=Nd,
    )


def make_anchor_batch(
    batch: int,
    mode: str = "redemod",
    seed: int = 0,
    snr_w: float = 20.0,
    snr_e: float = 7.0,
    path: Optional[str] = None,
):
    """Batch of anchor instances with fresh noise per instance (the protocol
    of the reference timing benches, test/test_time_admm.py:85-110), fully
    vectorized over the batch.

    Returns (y, b, sigma) numpy arrays with leading dim ``batch``.
    ``mode="redemod"`` draws fresh demod errors per instance;
    ``mode="fixed_e"`` replicates the bundled deterministic instance (noise
    w still fresh per instance).
    """
    rng = np.random.default_rng(seed)
    sig, e0 = load_anchor_arrays(path)
    n = sig.shape[0]
    Nb = Nd = int(round(np.sqrt(n)))

    if mode == "redemod":
        p = np.mean(np.abs(sig) ** 2)
        npow = p / 10 ** (snr_e / 10)
        noise = np.sqrt(npow / 2) * (
            rng.standard_normal((batch, n)) + 1j * rng.standard_normal((batch, n))
        )
        ang = np.mod(np.angle(sig[None, :] + noise), 2 * np.pi)
        data_d = np.floor(ang * 4 / (2 * np.pi)).astype(int) % 4
        b = np.exp(1j * (2 * np.pi * data_d / 4 + np.pi / 4))
        e = sig[None, :] - b
    elif mode == "fixed_e":
        b = np.broadcast_to(sig - e0, (batch, n)).copy()
        e = np.broadcast_to(e0, (batch, n))
    else:
        raise ValueError(f"unknown mode {mode!r}")

    Psi = _psi(ANCHOR_TAU, ANCHOR_F, ANCHOR_C, Nb, Nd)
    real_y = (b + e) * Psi[None, :]
    w = np.sqrt(0.5) * (
        rng.standard_normal((batch, n)) + 1j * rng.standard_normal((batch, n))
    )
    w_var = np.linalg.norm(real_y, axis=-1, keepdims=True) ** 2 / (
        10 ** (snr_w / 10) * n
    )
    y = real_y + np.sqrt(w_var) * w
    sigma = np.linalg.norm(e / b, axis=-1) + 1.0
    return (
        y.astype(np.complex64),
        b.astype(np.complex64),
        sigma.astype(np.float32),
    )
