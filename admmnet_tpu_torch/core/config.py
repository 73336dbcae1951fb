"""Typed configuration of the classical pipeline, the learned net, dataset
generation and training.

Same dataclasses, fields, defaults and validation as
``admmnet_tpu.core.config`` (the JAX reference), so a configuration moves
between the two packages through ``to_json``/``from_json`` or
``core.convert.options_from_jax``.  Pure Python: nothing here depends on a
framework.

Axis-naming convention:

- ``delay`` axis: tau in [0, 1), resolved by the ``Nd`` within-block symbol
  axis; atom factor ``d(tau) = exp(2j pi tau * [0..Nd-1])``.
- ``doppler`` axis: f in [-0.5, 0.5), resolved by the ``Nb`` OFDM-block axis;
  atom factor ``s(f) = exp(2j pi f * [0..Nb-1])``.
- flattened atom: ``a(tau, f) = kron(s(f), conj(d(tau)))`` with layout index
  ``m * Nd + k`` (m = block, k = symbol).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Tuple


@dataclasses.dataclass(frozen=True)
class ProblemSpec:
    """Dimensions of one recovery instance."""

    Nb: int = 10  # number of OFDM blocks (doppler axis length)
    Nd: int = 10  # data symbols per block (delay axis length)
    L_max: int = 3  # maximum number of targets

    @property
    def n(self) -> int:
        """Flattened problem size MN = Nb * Nd."""
        return self.Nb * self.Nd

    @property
    def lifted(self) -> int:
        """Side of the lifted PSD matrix G: MN + 1."""
        return self.n + 1


@dataclasses.dataclass(frozen=True)
class ADMMOptions:
    """Classical-solver knobs.

    ``phi_update``: ``"diag"`` (the diagonal phi-update) or ``"ref_dense"``
    (the reference's ``D^-1 + rho*11^T`` broadcasting quirk, solved
    closed-form by Sherman-Morrison).

    ``g_update`` selects the PSD step: ``"eigh"`` (exact projection),
    ``"polar"`` / ``"polar_fast"`` (matrix-sign schedules through the polar
    kernel, accurate / fast mode), ``"fused_fast"`` / ``"fused_exact"`` (the
    whole fixed-iteration solve in one kernel, detection-grade /
    phi-faithful contract), ``"newton_schulz"`` (cubic matrix-sign
    iteration) and ``"ref_identity"`` (the reference's SVD step, which is
    the identity on a Hermitian matrix).
    """

    rho: float = 1.0
    max_iter: int = 100
    eta_abs: float = 1e-7
    eta_rel: float = 1e-7
    use_min_iter: bool = True
    min_iter: int = 5
    phi_update: str = "diag"  # "diag" | "ref_dense"
    g_update: str = "eigh"  # see the class docstring for the choices
    newton_schulz_iters: int = 24
    # polar_fast / fused_fast: 1 appends the POLAR_BF16_POLISH step as a
    # "hi" step (no Hermitian re-projection after it)
    polar_fast_hi_steps: int = 0
    # polar_fast: keep the iterate of the low steps in bf16 (K1's bf16_store
    # instantiation on the card, its emulation on the CPU)
    polar_bf16_store: bool = False
    # fused_fast contract (detection grade; the production point):
    #   fused_kblk: instances interleaved per TPU program.  No effect on
    #     Hopper, where each instance is one thread block; kept so the
    #     configuration round-trips through JSON.
    #   fused_proj_iters / fused_inner_iters: bisection / Newton-waterline
    #     depths of the in-kernel H-projection.
    #   fused_schedule: PSD sign schedule ("full" = POLAR_BF16_SCHEDULE,
    #     "sched3" / "sched2" = shortened refits at a larger eigenvalue
    #     write-off).
    #   fused_final_hi: run the closing |M| products as "hi" products.
    #   fused_layout: "lean" (K2) or "lists" (K3, the escape hatch: needs
    #     fused_fold_diag and fused_warm_root off, as in JAX).
    #   fused_unroll: loop unroll of the TPU kernel; no arithmetic, and the
    #     port ignores it.
    #   fused_fold_diag: carry diag(A) and row n of the |M| product instead
    #     of the G planes (K2's production carry; off, K2 runs the unfolded
    #     carry).
    #   fused_warm_root: carry the bisection bracket across iterations.
    # The 2-step outer depth is certified only jointly with
    # fused_warm_root=True; with a cold bracket use fused_proj_iters >= 3.
    fused_kblk: int = 32
    fused_proj_iters: int = 2
    fused_inner_iters: int = 2
    fused_schedule: str = "sched2"  # "full" | "sched3" | "sched2"
    fused_final_hi: bool = False
    fused_layout: str = "lean"
    fused_unroll: int = 1
    fused_fold_diag: bool = True
    fused_warm_root: bool = True
    # fused_exact contract (phi-faithful): every schedule step is a "hi"
    # step with the minimax quintic schedule, a cold deep root-finder, and
    # (three_pass) split-bf16 3-pass products for the hi products.
    fused_exact_schedule: str = "quintic7"  # "quintic5" | "quintic7"
    fused_exact_proj_iters: int = 16
    fused_exact_inner_iters: int = 8
    fused_exact_warm_root: bool = False
    fused_exact_three_pass: bool = True

    def __post_init__(self):
        if self.phi_update not in ("diag", "ref_dense"):
            raise ValueError(f"unknown phi_update {self.phi_update!r}")
        if self.g_update not in ("eigh", "polar", "polar_fast", "fused_fast",
                                 "fused_exact", "newton_schulz",
                                 "ref_identity"):
            raise ValueError(f"unknown g_update {self.g_update!r}")
        if self.fused_exact_schedule not in ("quintic5", "quintic7"):
            raise ValueError(
                f"unknown fused_exact_schedule {self.fused_exact_schedule!r}"
            )
        if self.fused_schedule not in ("full", "sched3", "sched2"):
            raise ValueError(f"unknown fused_schedule {self.fused_schedule!r}")
        if self.fused_layout not in ("lean", "lists"):
            raise ValueError(f"unknown fused_layout {self.fused_layout!r}")


@dataclasses.dataclass(frozen=True)
class PeakSearchConfig:
    """Coarse-to-fine 2-D spectral peak search knobs.

    ``max_peaks`` candidate peaks are returned per instance (sorted by
    height, padded with -inf).  Refinement round r scans a
    ``refine_points``^2 window spanning +-step_{r-1} at spacing
    step_r = reduce_factor * step_{r-1} around the current estimate.

    ``refine_precision`` ("highest" | "default") names the matmul precision
    of the refine products, as in the JAX package: "default" is one-pass
    (operands rounded to bf16) on the card and float32 on the CPU
    (``peaks/search.py``).
    """

    delay_min: float = 0.0
    delay_max: float = 1.0
    delay_step: float = 0.01
    doppler_min: float = -0.5
    doppler_max: float = 0.5
    doppler_step: float = 0.01
    reduce_factor: float = 0.1
    refine_iters: int = 3
    refine_points: int = 11  # points per axis per refinement round
    max_peaks: int = 16
    refine_precision: str = "highest"

    def __post_init__(self):
        if self.refine_precision not in ("highest", "default"):
            raise ValueError(
                f"unknown refine_precision {self.refine_precision!r}"
            )
        # zoom-coverage invariant (class docstring): each round's span must
        # cover the previous round's quantization error
        if self.refine_points < 1.0 / self.reduce_factor + 1.0 - 1e-9:
            raise ValueError(
                f"refine_points {self.refine_points} < 1/reduce_factor + 1 "
                f"({1.0 / self.reduce_factor + 1.0:g}): the refinement zoom "
                "cannot cover the previous round's quantization error"
            )


# Gated deployment point of the classical pipeline: a fixed 10-iteration
# solve budget for detection-only use (not for phi-faithful work), and the
# peak search with 2 refine rounds.
DETECTION_BUDGET_ITERS = 10

PRODUCTION_PEAKS = PeakSearchConfig(
    max_peaks=8, refine_iters=2, refine_precision="default"
)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Unrolled ADMM-Net architecture.

    ``g_mode`` selects the GLayer's spectral-filter evaluation: ``"eigh"``
    (eigendecomposition with detached eigenvectors) or ``"chebyshev"`` (a
    Clenshaw matrix polynomial of degree ``cheb_degree``).  For chebyshev,
    ``cheb_impl="xla"`` runs ``ops.chebyshev.apply_spectral_filter`` at
    ``cheb_precision`` ("highest": plain fp32; "default": fp32 with a
    Hermitian re-projection every step), and ``cheb_impl="pallas"`` runs the
    Clenshaw kernel (``kernels.cheb_filter``).  ``cheb_kblk`` is the TPU
    kernel's instance interleave; it has no effect on Hopper and is kept so
    the configuration round-trips.  ``head`` selects the peak head of
    ``ADMMNet``: ``"attention"`` (direct regression) or ``"spectrum"``
    (coarse-to-fine spectral search with a soft-argmax finish).
    ``ref_stop_gradients`` reproduces the reference's stop-gradients.
    """

    spec: ProblemSpec = ProblemSpec()
    num_layers: int = 10
    hidden_dim: int = 128
    num_heads: int = 4
    correction_hidden: int = 64  # HLayer MLP width
    value_net_hidden: int = 16  # GLayer filter MLP width
    scale_net_hidden: int = 32  # ZLayer step MLP width
    with_peak_head: bool = True
    epsilon: float = 1e-8
    ref_stop_gradients: bool = True
    learned_sensing: bool = False  # trainable measurement matrix on y
    g_mode: str = "eigh"  # "eigh" | "chebyshev"
    cheb_degree: int = 48
    cheb_precision: str = "highest"  # "highest" | "default"
    cheb_impl: str = "xla"  # "xla" | "pallas"
    cheb_kblk: int = 8
    head: str = "attention"  # "attention" | "spectrum"
    head_grid_step: float = 0.01
    head_refine_rounds: int = 3
    head_refine_points: int = 11
    head_reduce_factor: float = 0.2

    def __post_init__(self):
        if self.g_mode not in ("eigh", "chebyshev"):
            raise ValueError(f"unknown g_mode {self.g_mode!r}")
        if self.cheb_impl not in ("xla", "pallas"):
            raise ValueError(f"unknown cheb_impl {self.cheb_impl!r}")
        if self.cheb_precision not in ("highest", "default"):
            raise ValueError(f"unknown cheb_precision {self.cheb_precision!r}")
        if self.head not in ("attention", "spectrum"):
            raise ValueError(f"unknown head {self.head!r}")


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Synthetic OFDM-ISAC dataset knobs."""

    spec: ProblemSpec = ProblemSpec()
    tau_range: Tuple[float, float] = (0.1, 0.9)
    f_range: Tuple[float, float] = (-0.4, 0.4)
    gain_std: float = 0.7  # complex reflection coeff ~ N(0, 0.7^2) per part
    snr_range: Tuple[float, float] = (5.0, 25.0)  # environment SNR_w in dB
    snr_demod: float = 7.0  # demodulation SNR_e in dB
    psk_order: int = 4  # QPSK
    train_ratio: float = 0.7
    val_ratio: float = 0.15


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training knobs.

    AdamW at ``lr`` with decoupled ``weight_decay`` in two groups (the
    model's ``ADMM_LR_MODULES`` at ``admm_lr_scale * lr``), global gradient
    norm clipped at ``grad_clip``, cosine warm restarts (first cycle
    ``sgdr_t0`` epochs, each next ``sgdr_t_mult`` times longer, floor
    ``lr_min``), early stop after ``patience`` epochs without a better
    validation loss.  ``assignment``: "slot" (slot i pairs with target i)
    or "perm" (set matching).  ``spectral_weight`` weighs the spectral
    contrast loss.  ``reset_best``: on resume, forget the checkpoint's best
    validation loss (a curriculum stage switch).
    """

    batch_size: int = 256
    epochs: int = 100
    lr: float = 1e-3
    admm_lr_scale: float = 0.5
    weight_decay: float = 1e-3
    grad_clip: float = 1.0
    sgdr_t0: int = 10
    sgdr_t_mult: int = 2
    lr_min: float = 1e-6
    patience: int = 10
    conf_threshold: float = 0.5  # detection threshold of the test metrics
    assignment: str = "slot"
    spectral_weight: float = 0.0
    reset_best: bool = False
    seed: int = 0


def to_json(cfg: Any) -> str:
    return json.dumps(dataclasses.asdict(cfg), indent=2)


def _from_dict(cls, d: Dict[str, Any]):
    fields = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in d.items():
        if k not in fields:
            continue
        if isinstance(v, dict) and "Nb" in v:
            v = ProblemSpec(**v)
        elif isinstance(v, list):
            v = tuple(v)
        kwargs[k] = v
    return cls(**kwargs)


def from_json(cls, s: str):
    return _from_dict(cls, json.loads(s))
