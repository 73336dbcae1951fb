"""The unrolled ADMM-Net: layers, trunk and peak heads (torch.nn)."""
from admmnet_tpu_torch.models.nets import ADMMNet, PhiEstADMMNet
from admmnet_tpu_torch.models.layers import GLayer, HLayer, PhiLayer, ZLayer
from admmnet_tpu_torch.models.peak_head import PeakSearchHead

__all__ = [
    "ADMMNet",
    "PhiEstADMMNet",
    "GLayer",
    "HLayer",
    "PhiLayer",
    "ZLayer",
    "PeakSearchHead",
]
