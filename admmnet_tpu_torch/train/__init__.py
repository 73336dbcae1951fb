"""Training of the learned nets: losses, the SGDR schedule, checkpoints,
metric files and the training loop."""

from admmnet_tpu_torch.train.losses import (
    basic_anm_loss,
    basic_parameter_loss,
    phi_alignment_loss,
)

__all__ = ["basic_anm_loss", "basic_parameter_loss", "phi_alignment_loss"]
