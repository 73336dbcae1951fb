"""Visualization: MATLAB-style scatter + 3-D peak surface.

The port's copy of ``admmnet_tpu.utils.plotting``.  Functional parity:
reference utils/plotUtils.py:5-123 (``matlab_style_plots`` rcParams +
``plot_predictions_vs_truth``) and utils/peakSearchUtils.py:199-358
(``plot_peaks`` surface with predicted/truth markers).  Writes files instead
of plt.show() (headless-first); spectrum evaluation reuses the batched
separable matmul (``peaks.spectrum.spectrum_grid``, on the CPU) instead of
per-point loops.  matplotlib is imported inside the functions: only the
CLIs' plot flags need it.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def matlab_style():
    """MATLAB-flavored rcParams (reference plotUtils.py:5-25); returns
    pyplot."""
    plt = _pyplot()
    plt.rcParams.update(
        {
            "font.size": 12,
            "axes.linewidth": 1.2,
            "axes.grid": True,
            "grid.alpha": 0.3,
            "lines.linewidth": 1.6,
            "figure.dpi": 110,
            "legend.frameon": True,
        }
    )
    return plt


def plot_predictions_vs_truth(
    f_true, tau_true, peaks, out_path: str = "predictions_vs_truth.png"
):
    """Scatter of predicted (tau, f) vs ground truth
    (reference plotUtils.py:62-123).  ``peaks``: iterable of rows
    [tau, f, height]."""
    plt = matlab_style()
    fig, ax = plt.subplots(figsize=(7, 6))
    peaks = np.asarray(peaks)
    if peaks.size:
        ax.scatter(
            peaks[:, 0], peaks[:, 1], marker="x", s=90, c="tab:blue",
            label="Predicted",
        )
    ax.scatter(
        np.asarray(tau_true), np.asarray(f_true), marker="o", s=70,
        facecolors="none", edgecolors="tab:red", label="Ground truth",
    )
    ax.set_xlabel("Delay (norm)")
    ax.set_ylabel("Doppler shift (norm)")
    ax.set_xlim(0, 1)
    ax.set_ylim(-0.5, 0.5)
    ax.legend()
    ax.set_title("Predicted vs true target locations")
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


_SURFACE_COLORS = (
    np.array(
        [
            [8, 67, 132], [19, 115, 178], [66, 166, 203], [119, 202, 197],
            [178, 225, 185], [214, 239, 208], [244, 250, 237],
        ]
    )
    / 255.0
)


def plot_peaks(
    phi: np.ndarray,
    Nb: int,
    Nd: int,
    ground_truth: Optional[Dict[str, np.ndarray]] = None,
    out_path: str = "peaks_surface.png",
    step: float = 0.01,
    title: str = "Proposed method",
):
    """3-D spectrum surface with local-maxima markers and truth stems
    (reference peakSearchUtils.py:199-324)."""
    import torch
    from matplotlib import colors

    from admmnet_tpu_torch.peaks.search import _local_max_mask
    from admmnet_tpu_torch.peaks.spectrum import spectrum_grid

    plt = matlab_style()
    taus = np.arange(0.0, 1.0, step, dtype=np.float32)
    fs = np.arange(-0.5, 0.5, step, dtype=np.float32)
    phi = torch.as_tensor(np.asarray(phi, np.complex64))
    Z = spectrum_grid(phi, torch.from_numpy(taus), torch.from_numpy(fs), Nb, Nd)
    mask = _local_max_mask(Z[None])[0].numpy()
    Z = Z.numpy()
    T, F = np.meshgrid(taus, fs)

    fig = plt.figure(figsize=(11, 7.5))
    ax = fig.add_subplot(111, projection="3d")
    cmap = colors.LinearSegmentedColormap.from_list("ref_cmap", _SURFACE_COLORS, N=256)
    surf = ax.plot_surface(T, F, np.abs(Z), cmap=cmap, alpha=0.85, linewidth=0)

    py, px = np.where(mask)
    if py.size:
        ax.scatter(
            T[py, px], F[py, px], 2 * Z[py, px], c="blue", marker="*", s=40,
            alpha=0.4, label="Predicted location of peaks", depthshade=False,
        )
    if ground_truth is not None:
        zmax = 2 * Z.max()
        tt = np.asarray(ground_truth["tau"])
        ff = np.asarray(ground_truth["f"])
        ax.scatter(tt, ff, np.full_like(tt, zmax), c="red", marker="o", s=90,
                   label="Ground truth", depthshade=False)
        for x, yv in zip(tt, ff):
            ax.plot([x, x], [yv, yv], [0, zmax], "k--", linewidth=0.5)

    ax.set_xlabel("Delay (norm)")
    ax.set_ylabel("Doppler shift (norm)")
    ax.set_zlabel("Peak Intensity")
    ax.set_title(title)
    ax.legend()
    fig.colorbar(surf, ax=ax, shrink=0.5, aspect=5, label="Intensity")
    ax.view_init(elev=30, azim=45)
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def plot_dataset_statistics(data: Dict[str, np.ndarray], out_path: str):
    """2x2 dataset stats figure (reference generate_data.py:302-349
    ``visualize_dataset_stats``): target-count bar, tau / Doppler histograms,
    symbol-error-rate histogram.  Takes a loaded split dict
    (``DatasetGenerator.load_split``); returns the written path."""
    plt = matlab_style()
    fig, axes = plt.subplots(2, 2, figsize=(12, 10))

    L = np.asarray(data["L_true"]).astype(int)
    uniq, counts = np.unique(L, return_counts=True)
    axes[0, 0].bar(uniq, counts)
    axes[0, 0].set_title("Target count distribution")
    axes[0, 0].set_xlabel("targets L")
    axes[0, 0].set_ylabel("count")

    mask = np.arange(data["tau"].shape[-1])[None, :] < L[:, None]
    axes[0, 1].hist(np.asarray(data["tau"])[mask], bins=50, alpha=0.7)
    axes[0, 1].set_title("Delay distribution")
    axes[0, 1].set_xlabel(r"$\tau$ (norm)")

    axes[1, 0].hist(np.asarray(data["f"])[mask], bins=50, alpha=0.7)
    axes[1, 0].set_title("Doppler distribution")
    axes[1, 0].set_xlabel("f (norm)")

    # ser is stored already in percent (data/generator.py stores
    # 100*mean(symbol errors)); plot as-is.
    axes[1, 1].hist(np.asarray(data["ser"]), bins=20, alpha=0.7)
    axes[1, 1].set_title("Symbol-error-rate distribution")
    axes[1, 1].set_xlabel("SER (%)")

    fig.tight_layout()
    fig.savefig(out_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return out_path
