"""Unrolled ADMM networks.

``PhiEstADMMNet``: K layers of Phi -> H -> G -> Z, returns phi.
``ADMMNet``: the same trunk plus a peak head, returns (tau, f, conf, phi).
Counterparts of ``admmnet_tpu/models/nets.py``; submodule names follow the
flax names (``trunk.phi_0``, ``trunk.g_0``, ``peak_head``, ...), so a flax
checkpoint loads through ``core.convert.params_from_jax`` by renaming.

Each depth has its own parameters.  G and Z start as complex zeros.  The
returned phi reads the G and Z of the depth before the last, so the last
depth runs its Phi step only: its H, G and Z parameters stay (as in the
flax tree) and, with zero gradients, change only by weight decay, as in
the JAX package.
``learned_sensing`` adds a trainable measurement matrix W applied to the
observation, y' = y W^T, as two real products.  The nets run on the device
of their inputs; on CUDA the chebyshev GLayer with ``cheb_impl="pallas"``
launches the Clenshaw kernels: K4 when no gradient is needed, the training
forward K5 and the reversible backward K6 when one is.  ``train()`` mode
turns on the attention head's dropout; the trunk and the spectrum head
have none.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from admmnet_tpu_torch.core.config import ModelConfig
from admmnet_tpu_torch.models.layers import GLayer, HLayer, PhiLayer, ZLayer
from admmnet_tpu_torch.models.peak_head import PeakSearchHead, SpectrumPeakHead
from admmnet_tpu_torch.ops.atoms import COMPLEX


class _SensingMatrix(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.w_real = nn.Parameter(torch.eye(dim))
        self.w_imag = nn.Parameter(torch.zeros(dim, dim))

    def forward(self, y):
        yr, yi = y.real, y.imag
        out_r = yr @ self.w_real.T - yi @ self.w_imag.T
        out_i = yr @ self.w_imag.T + yi @ self.w_real.T
        return torch.complex(out_r, out_i).to(COMPLEX)


class _Trunk(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        n = cfg.spec.n
        if cfg.learned_sensing:
            self.sensing = _SensingMatrix(n)
        for k in range(cfg.num_layers):
            self.add_module(f"phi_{k}", PhiLayer(epsilon=cfg.epsilon))
            self.add_module(f"h_{k}", HLayer(n, hidden=cfg.correction_hidden,
                                             epsilon=cfg.epsilon))
            self.add_module(f"g_{k}", GLayer(
                n, value_hidden=cfg.value_net_hidden, epsilon=cfg.epsilon,
                ref_stop_gradients=cfg.ref_stop_gradients, mode=cfg.g_mode,
                cheb_degree=cfg.cheb_degree, cheb_precision=cfg.cheb_precision,
                cheb_impl=cfg.cheb_impl))
            self.add_module(f"z_{k}", ZLayer(
                n, scale_hidden=cfg.scale_net_hidden, epsilon=cfg.epsilon,
                ref_stop_gradients=cfg.ref_stop_gradients))

    def forward(self, y, b, sigma):
        cfg = self.cfg
        n = cfg.spec.n
        batch = y.shape[:-1]
        if cfg.learned_sensing:
            y = self.sensing(y)
        G = torch.zeros((*batch, n + 1, n + 1), dtype=COMPLEX, device=y.device)
        Z = torch.zeros_like(G)
        phi = torch.zeros((*batch, n), dtype=COMPLEX, device=y.device)
        for k in range(cfg.num_layers):
            phi = getattr(self, f"phi_{k}")(y, b, G, Z)
            if k == cfg.num_layers - 1:
                break  # the last depth's H, G and Z feed nothing returned
            h = getattr(self, f"h_{k}")(phi, G, Z, sigma)
            G = getattr(self, f"g_{k}")(phi, h, Z)
            Z = getattr(self, f"z_{k}")(phi, h, G, Z, k)
        return phi


class PhiEstADMMNet(nn.Module):
    """Trunk-only net regressing the dual polynomial phi.  Its
    ``ADMM_LR_MODULES`` (the trunk) train at ``admm_lr_scale * lr``."""

    ADMM_LR_MODULES = ("trunk",)

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.trunk = _Trunk(cfg)

    def forward(self, y, b, sigma):
        return self.trunk(y, b, sigma)


class ADMMNet(nn.Module):
    """Trunk plus learned peak head: ``cfg.head`` "attention" (direct
    regression) or "spectrum" (coarse-to-fine spectral search).  The trunk
    trains at ``admm_lr_scale * lr``, the head at ``lr``."""

    ADMM_LR_MODULES = ("trunk",)

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.trunk = _Trunk(cfg)
        spec = cfg.spec
        if cfg.head == "spectrum":
            self.peak_head = SpectrumPeakHead(
                spec.Nb, spec.Nd, L_max=spec.L_max, grid_step=cfg.head_grid_step,
                refine_rounds=cfg.head_refine_rounds,
                refine_points=cfg.head_refine_points,
                reduce_factor=cfg.head_reduce_factor)
        else:
            self.peak_head = PeakSearchHead(
                spec.Nb, spec.Nd, L_max=spec.L_max, hidden_dim=cfg.hidden_dim,
                num_heads=cfg.num_heads)

    def forward(self, y, b, sigma):
        phi = self.trunk(y, b, sigma)
        tau, f, conf = self.peak_head(phi)
        return tau, f, conf, phi
