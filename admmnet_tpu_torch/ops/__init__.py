"""Signal-model and linear-algebra primitives."""

from admmnet_tpu_torch.ops.atoms import (
    atom_matrix,
    delay_steering,
    doppler_steering,
    khatri_rao,
    vander_vec,
)
from admmnet_tpu_torch.ops.signal import awgn, pskdemod, pskmod
from admmnet_tpu_torch.ops.projections import (
    project_l1_ball,
    project_sum_inf,
    psd_project_eigh,
    psd_project_newton_schulz,
    psd_project_polar,
)
from admmnet_tpu_torch.ops.linalg import (
    assemble_lifted,
    fro_norm,
    hermitianize,
    lifted_corner_vec,
    lifted_topleft,
)

__all__ = [
    "atom_matrix",
    "delay_steering",
    "doppler_steering",
    "khatri_rao",
    "vander_vec",
    "awgn",
    "pskdemod",
    "pskmod",
    "project_l1_ball",
    "project_sum_inf",
    "psd_project_eigh",
    "psd_project_newton_schulz",
    "psd_project_polar",
    "assemble_lifted",
    "fro_norm",
    "hermitianize",
    "lifted_corner_vec",
    "lifted_topleft",
]
