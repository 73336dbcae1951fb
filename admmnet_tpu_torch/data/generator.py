"""Synthetic OFDM-ISAC datasets: generation on the device, saving, loading
and minibatches.  Counterpart of ``admmnet_tpu.data.generator``.

Distributions, per scene:

- tau ~ U(0.1, 0.9), f ~ U(-0.4, 0.4), L = L_max targets;
- complex gains C = N(0, 0.7^2) + j N(0, 0.7^2);
- QPSK symbols with demodulation errors at SNR_e = 7 dB (awgn -> hard
  decision), b the demodulated symbols and e = sig - b;
- observation y = diag(b + e) Psi + w at SNR_w ~ U(5, 25) dB per scene;
- sigma = ||e / b|| + 1.

``draw_batch`` makes the random draws with a ``torch.Generator`` (in the
JAX package's order of draws; the bits differ from JAX's), and
``scenes_from_draws`` is the deterministic rest, so a test can feed both
packages the same draws.  ``label_phi`` labels scenes with the classical
fused_exact solve (the K2 kernel on CUDA).

A dataset directory holds ``dataset_config.json`` (Nb, Nd, L_max, split
sizes, ...) and one directory per split with one ``.npy`` file per key:
``y_real``, ``y_imag``, ``b_real``, ``b_imag``, ``tau``, ``f``, ``C_real``,
``C_imag``, ``L_true``, ``sigma``, ``ser`` and, for phi-labelled sets,
``phi_real``, ``phi_imag`` -- the JAX package's layout, so datasets move
between the two packages.
"""

from __future__ import annotations

import json
import math
import time
from pathlib import Path
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from admmnet_tpu_torch.core.config import ADMMOptions, DataConfig
from admmnet_tpu_torch.ops.atoms import COMPLEX, target_signal
from admmnet_tpu_torch.ops.signal import awgn, complex_normal, pskdemod, pskmod

SPLITS = ("train", "val", "test")


def _uniform(shape, lo, hi, generator, device):
    return lo + (hi - lo) * torch.rand(shape, generator=generator, device=device)


def draw_batch(cfg: DataConfig, batch: int, generator: torch.Generator,
               device) -> Dict[str, torch.Tensor]:
    """The random draws of ``batch`` scenes, in the JAX package's order:
    tau, f, the gains' real and imaginary parts, the symbols, the
    demodulation noise, SNR_w and the observation noise."""
    n, L = cfg.spec.n, cfg.spec.L_max
    tau = _uniform((batch, L), *cfg.tau_range, generator, device)
    f = _uniform((batch, L), *cfg.f_range, generator, device)
    C = complex_normal((batch, L), generator, device)
    data = torch.randint(0, cfg.psk_order, (batch, n), generator=generator, device=device)
    demod_noise = complex_normal((batch, n), generator, device)
    snr_w = _uniform((batch,), *cfg.snr_range, generator, device)
    w = complex_normal((batch, n), generator, device)
    return {"tau": tau, "f": f, "C": C, "data": data, "demod_noise": demod_noise,
            "snr_w": snr_w, "w": w}


def scenes_from_draws(cfg: DataConfig, draws: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The scenes that ``draws`` make: y, b, tau, f, C, L_true, sigma, ser."""
    spec = cfg.spec
    n = spec.n
    order = cfg.psk_order
    C = cfg.gain_std * draws["C"]
    Psi = target_signal(draws["tau"], draws["f"], C, spec.Nb, spec.Nd)  # (batch, n)
    sig = pskmod(draws["data"], order, math.pi / order)
    sig_n = awgn(sig, cfg.snr_demod, noise=draws["demod_noise"])
    b = pskmod(pskdemod(sig_n, order, math.pi / order), order, math.pi / order)
    e = sig - b
    ser = 100.0 * torch.mean((torch.abs(e) > 1e-6).to(torch.float32), dim=-1)
    real_y = (b + e) * Psi
    w = math.sqrt(0.5) * draws["w"]
    w_var = torch.sum(torch.abs(real_y) ** 2, dim=-1, keepdim=True) / (
        10.0 ** (draws["snr_w"][:, None] / 10.0) * n)
    y = real_y + torch.sqrt(w_var).to(COMPLEX) * w.to(COMPLEX)
    sigma = torch.sqrt(torch.sum(torch.abs(e / b) ** 2, dim=-1)) + 1.0
    return {"y": y, "b": b, "tau": draws["tau"], "f": draws["f"], "C": C,
            "L_true": torch.full((y.shape[0],), spec.L_max, dtype=torch.int32, device=y.device),
            "sigma": sigma, "ser": ser}


def generate_batch(cfg: DataConfig, batch: int, generator: torch.Generator,
                   device="cuda") -> Dict[str, np.ndarray]:
    """``batch`` scenes made on ``device`` from ``generator`` (which must
    live on that device), as host numpy arrays."""
    with torch.no_grad():
        out = scenes_from_draws(cfg, draw_batch(cfg, batch, generator, device))
    return {k: v.cpu().numpy() for k, v in out.items()}


def label_phi(y: np.ndarray, b: np.ndarray, sigma: np.ndarray,
              opts: Optional[ADMMOptions] = None, iters: int = 100,
              lambda_val: float = 1.0, chunk: int = 1024, device="cuda") -> np.ndarray:
    """phi labels from the classical solve, ``chunk`` scenes per call on
    ``device``; the fused_exact solve (the K2 kernel on CUDA) by default."""
    from admmnet_tpu_torch.solver import admm_solve_fixed

    opts = opts or ADMMOptions(g_update="fused_exact")
    outs = []
    with torch.no_grad():
        for i in range(0, y.shape[0], chunk):
            yy, bb, ss = (torch.from_numpy(np.ascontiguousarray(x[i:i + chunk])).to(device)
                          for x in (y, b, sigma))
            phi = admm_solve_fixed(yy, bb, ss, iters, lambda_val, opts)
            outs.append(phi.cpu().numpy())
    return np.concatenate(outs, axis=0)


def split_seeds(seed: int):
    """One generator seed per split (train, val, test) from one seed."""
    return [int(s.generate_state(1, np.uint64)[0] >> np.uint64(1))
            for s in np.random.SeedSequence(seed).spawn(len(SPLITS))]


class DatasetGenerator:
    """Generate, save and load the train/val/test splits of a directory."""

    def __init__(self, cfg: DataConfig = DataConfig(), data_dir="./ofdm_dataset"):
        self.cfg = cfg
        self.data_dir = Path(data_dir)

    def generate_complete_dataset(self, total_samples: int = 10000, seed: int = 0,
                                  with_phi: bool = False,
                                  phi_opts: Optional[ADMMOptions] = None,
                                  phi_iters: int = 100, device="cuda",
                                  log=print) -> Dict[str, Dict[str, np.ndarray]]:
        cfg = self.cfg
        n_train = int(total_samples * cfg.train_ratio)
        n_val = int(total_samples * cfg.val_ratio)
        n_test = total_samples - n_train - n_val
        splits = {}
        for name, count, s in zip(SPLITS, (n_train, n_val, n_test), split_seeds(seed)):
            t0 = time.time()
            gen = torch.Generator(device=device).manual_seed(s)
            raw = generate_batch(cfg, count, gen, device)
            log(f"[datagen] {name}: generated {count} samples ({time.time() - t0:.1f}s)")
            if with_phi:
                t0 = time.time()
                raw["phi"] = label_phi(raw["y"], raw["b"], raw["sigma"], phi_opts, phi_iters,
                                       device=device)
                log(f"[datagen] {name}: phi-labelled ({time.time() - t0:.1f}s)")
            splits[name] = raw
            self._save_split(name, raw)
        self._save_config(total_samples, n_train, n_val, n_test, with_phi)
        return splits

    def _save_split(self, name: str, raw: Dict[str, np.ndarray]):
        d = self.data_dir / name
        d.mkdir(parents=True, exist_ok=True)
        flat = {
            "y_real": raw["y"].real, "y_imag": raw["y"].imag,
            "b_real": raw["b"].real, "b_imag": raw["b"].imag,
            "tau": raw["tau"], "f": raw["f"],
            "C_real": raw["C"].real, "C_imag": raw["C"].imag,
            "L_true": raw["L_true"], "sigma": raw["sigma"], "ser": raw["ser"],
        }
        if "phi" in raw:
            flat["phi_real"] = raw["phi"].real
            flat["phi_imag"] = raw["phi"].imag
        for k, v in flat.items():
            np.save(d / f"{k}.npy", v.astype(np.int32 if k == "L_true" else np.float32))

    def _save_config(self, total, n_train, n_val, n_test, with_phi):
        self.data_dir.mkdir(parents=True, exist_ok=True)
        cfg = self.cfg
        info = {
            "Nb": cfg.spec.Nb, "Nd": cfg.spec.Nd, "L_max": cfg.spec.L_max,
            "snr_range": list(cfg.snr_range), "total_samples": total,
            "train_samples": n_train, "val_samples": n_val,
            "test_samples": n_test, "with_phi": with_phi,
        }
        with open(self.data_dir / "dataset_config.json", "w") as fp:
            json.dump(info, fp, indent=2)

    def dataset_config(self) -> Dict[str, Any]:
        """The directory's ``dataset_config.json``."""
        return json.loads((self.data_dir / "dataset_config.json").read_text())

    def load_split(self, split: str) -> Dict[str, np.ndarray]:
        d = self.data_dir / split
        if not d.exists():
            raise FileNotFoundError(f"split {split} not generated under {self.data_dir}")
        arrays = {p.stem: np.load(p) for p in d.glob("*.npy")}
        out = {
            "y": arrays["y_real"] + 1j * arrays["y_imag"],
            "b": arrays["b_real"] + 1j * arrays["b_imag"],
            "tau": arrays["tau"],
            "f": arrays["f"],
            "C": arrays["C_real"] + 1j * arrays["C_imag"],
            "L_true": arrays["L_true"],
            "sigma": arrays["sigma"],
            "ser": arrays["ser"],
        }
        if "phi_real" in arrays:
            out["phi"] = arrays["phi_real"] + 1j * arrays["phi_imag"]
        return out


def iterate_batches(data: Dict[str, np.ndarray], batch_size: int, shuffle: bool = True,
                    seed: int = 0, drop_remainder: bool = False
                    ) -> Iterator[Dict[str, np.ndarray]]:
    """Host-side minibatches; the order of the JAX package's iterator
    (``np.random.default_rng(seed).shuffle``), so both packages see the same
    minibatches from the same arrays.  ``drop_remainder`` leaves out the
    last, short minibatch (data parallelism needs equal shards)."""
    N = data["y"].shape[0]
    idx = np.arange(N)
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    stop = N - (N % batch_size) if drop_remainder else N
    for i in range(0, stop, batch_size):
        sel = idx[i:i + batch_size]
        yield {k: v[sel] for k, v in data.items()}
