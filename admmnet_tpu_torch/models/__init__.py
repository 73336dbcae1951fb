"""The unrolled ADMM-Net: layers, trunk and peak heads (torch.nn)."""
from admmnet_tpu_torch.models.nets import ADMMNet, PhiEstADMMNet

__all__ = ["ADMMNet", "PhiEstADMMNet"]
