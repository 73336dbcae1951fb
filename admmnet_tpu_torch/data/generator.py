"""Datasets on disk: the loading half of ``admmnet_tpu.data.generator``.

A dataset directory holds ``dataset_config.json`` (Nb, Nd, L_max, split
sizes, ...) and one directory per split with one ``.npy`` file per key:
``y_real``, ``y_imag``, ``b_real``, ``b_imag``, ``tau``, ``f``, ``C_real``,
``C_imag``, ``L_true``, ``sigma``, ``ser`` and, for phi-labelled sets,
``phi_real``, ``phi_imag``.  Generation is not ported yet.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict

import numpy as np


class DatasetGenerator:
    """Load the train/val/test splits of a dataset directory."""

    def __init__(self, data_dir="./ofdm_dataset"):
        self.data_dir = Path(data_dir)

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
