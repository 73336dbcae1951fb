"""Learned peak-search heads of the end-to-end ADMMNet.

Counterparts of ``admmnet_tpu/models/peak_head.py``, with the flax
parameter names.

``PeakSearchHead``: phi -> [Re, Im] feature MLP -> cross-attention of one
query against a learnable (tau, f) positional grid -> per-target
regression heads: tau = sigmoid, f = tanh (range (-1, 1), as the
reference), shared confidence head.  The attention is written as explicit
products in flax's ``MultiHeadDotProductAttention`` layout (query / key /
value projections to (heads, head_dim), logits scaled by 1/sqrt(head_dim),
softmax over the grid, output projection from (heads, head_dim)).  In
``train()`` mode the attention weights go through dropout (rate
``ATTENTION_DROPOUT``, the JAX head's) as in flax's attention: one keep mask
over the grid, shared by the batch and the heads, and the kept weights
scaled by 1 / (1 - rate).  ``dropout_generator``
(``None``: torch's default generator of the device) draws the masks.

``SpectrumPeakHead``: a differentiable coarse-to-fine spectral search.  It
evaluates |<phi, a(tau, f)>|^2 on the coarse separable grid, takes the
top-L_max local maxima (hard, detached), zooms with hard-argmax rounds, and
finishes with a soft-argmax over the last window (learned temperature);
confidence comes from a small MLP on scale-invariant peak statistics.
``lax.top_k`` and ``torch.topk`` may order tied scores differently.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from admmnet_tpu_torch.models.layers import Dense, scalar, softplus
from admmnet_tpu_torch.ops.atoms import delay_steering, doppler_steering
from admmnet_tpu_torch.peaks.search import _local_max_mask
from admmnet_tpu_torch.peaks.spectrum import spectrum_grid

ATTENTION_DROPOUT = 0.1


def _grid_init(M: int, N: int) -> torch.Tensor:
    tg, fg = np.meshgrid(np.linspace(0.0, 1.0, M), np.linspace(-0.5, 0.5, N), indexing="ij")
    return torch.from_numpy(np.stack([tg.ravel(), fg.ravel()], axis=1).astype(np.float32))


class _Attention(nn.Module):
    """One query attending over a key/value set shared by the batch."""

    def __init__(self, features: int, num_heads: int):
        super().__init__()
        if features % num_heads:
            raise ValueError(f"{features} features do not split into {num_heads} heads")
        self.num_heads = num_heads
        self.head_dim = features // num_heads
        self.dropout_generator = None
        self.query = Dense(features, features)
        self.key = Dense(features, features)
        self.value = Dense(features, features)
        self.out = Dense(features, features)

    def forward(self, x: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
        """x: (B, features) queries; kv: (n, features).  Returns (B, features)."""
        H, D = self.num_heads, self.head_dim
        q = self.query(x).reshape(*x.shape[:-1], H, D)
        q = q / torch.sqrt(torch.tensor(float(D), dtype=q.dtype, device=q.device))
        k = self.key(kv).reshape(kv.shape[0], H, D)
        v = self.value(kv).reshape(kv.shape[0], H, D)
        w = torch.softmax(torch.einsum("...hd,khd->...hk", q, k), dim=-1)
        if self.training:
            keep = 1.0 - ATTENTION_DROPOUT
            u = torch.rand(kv.shape[0], generator=self.dropout_generator, device=w.device)
            w = w * ((u < keep).to(w.dtype) / keep)
        o = torch.einsum("...hk,khd->...hd", w, v)
        return self.out(o.reshape(*x.shape[:-1], H * D))


class PeakSearchHead(nn.Module):
    def __init__(self, M: int, N: int, L_max: int = 3, hidden_dim: int = 128,
                 num_heads: int = 4):
        super().__init__()
        n = M * N
        self.L_max = L_max
        self.feat1 = Dense(2 * n, hidden_dim)
        self.feat2 = Dense(hidden_dim, hidden_dim)
        self.position_grid = nn.Parameter(_grid_init(M, N))
        self.position_projection = Dense(2, hidden_dim)
        self.attention = _Attention(hidden_dim, num_heads)
        widths = (hidden_dim, hidden_dim // 2, hidden_dim // 4, hidden_dim // 8)
        for i in range(3):
            self.add_module(f"peak{i}", Dense(widths[i], widths[i + 1]))
        w = widths[-1]
        for t in range(L_max):
            self.add_module(f"tau{t}_hidden", Dense(w, 32))
            self.add_module(f"tau{t}_out", Dense(32, 1))
            self.add_module(f"f{t}_hidden", Dense(w, 32))
            self.add_module(f"f{t}_out", Dense(32, 1))
        self.conf_hidden = Dense(w, 16)
        self.conf_out = Dense(16, 1)

    def forward(self, phi):
        x = torch.cat([phi.real, phi.imag], dim=-1)
        x = torch.relu(self.feat1(x))
        x = torch.relu(self.feat2(x))
        pos = self.position_projection(self.position_grid)
        x = x + self.attention(x, pos)
        for i in range(3):
            x = torch.relu(getattr(self, f"peak{i}")(x))
        taus, fs, confs = [], [], []
        for t in range(self.L_max):
            feat = x + t / self.L_max
            th = torch.relu(getattr(self, f"tau{t}_hidden")(feat))
            taus.append(torch.sigmoid(getattr(self, f"tau{t}_out")(th)))
            fh = torch.relu(getattr(self, f"f{t}_hidden")(feat))
            fs.append(torch.tanh(getattr(self, f"f{t}_out")(fh)))
            ch = torch.relu(self.conf_hidden(feat))
            confs.append(torch.sigmoid(self.conf_out(ch)))
        return torch.cat(taus, dim=-1), torch.cat(fs, dim=-1), torch.cat(confs, dim=-1)


class SpectrumPeakHead(nn.Module):
    """Coarse-to-fine spectral peak search with a soft-argmax finish.

    M = Nb (doppler axis), N = Nd (delay axis); the spectrum is indexed
    [doppler, delay] as in ``peaks.spectrum``.
    """

    def __init__(self, M: int, N: int, L_max: int = 3, grid_step: float = 0.01,
                 refine_rounds: int = 3, refine_points: int = 11,
                 reduce_factor: float = 0.2, conf_hidden: int = 16):
        super().__init__()
        self.M, self.N, self.L_max = M, N, L_max
        self.grid_step = grid_step
        self.refine_rounds = refine_rounds
        self.refine_points = refine_points
        self.reduce_factor = reduce_factor
        taus = np.arange(0.0, 1.0, grid_step, dtype=np.float32)
        if taus.size and abs(taus[-1] % 1.0) < 1e-9:
            taus = taus[:-1]  # drop the tau = 1 alias of tau = 0
        fs = np.arange(-0.5, 0.5, grid_step, dtype=np.float32)
        self.register_buffer("taus_ax", torch.from_numpy(taus), persistent=False)
        self.register_buffer("fs_ax", torch.from_numpy(fs), persistent=False)
        self.softargmax_beta = scalar(25.0)
        self.conf_hidden = Dense(4, conf_hidden)
        self.conf_out = Dense(conf_hidden, 1)

    def forward(self, phi):
        M, N, K, P = self.M, self.N, self.L_max, self.refine_points
        n = M * N
        batch_shape = phi.shape[:-1]
        phi2 = phi.reshape(-1, n)
        B = phi2.shape[0]
        nx, ny = self.taus_ax.numel(), self.fs_ax.numel()

        # 1. coarse spectrum; 2. top-K local maxima, the other cells demoted
        # (not -inf) so top-K always yields K usable cells
        Z = spectrum_grid(phi2, self.taus_ax, self.fs_ax, M, N)  # (B, ny, nx)
        zmax = torch.amax(Z, dim=(-2, -1), keepdim=True)
        scores = torch.where(_local_max_mask(Z), Z, Z - 2.0 * zmax).reshape(B, ny * nx)
        idx = torch.topk(scores, K, dim=-1).indices
        tau = self.taus_ax[idx % nx].detach()  # (B, K)
        f = self.fs_ax[idx // nx].detach()

        # 3. zoom: hard-argmax rounds, then the soft-argmax finish
        Phi = torch.conj(phi2).reshape(B, 1, M, N)
        rel = torch.linspace(-1.0, 1.0, P, dtype=torch.float32, device=phi.device)
        half_t = half_f = self.grid_step
        height = None
        for r in range(self.refine_rounds):
            taus = torch.clamp(tau[..., None] + half_t * rel, 0.0, 1.0 - 1e-6)
            fs = torch.clamp(f[..., None] + half_f * rel, -0.5, 0.5 - 1e-6)
            S = doppler_steering(fs, M)  # (B, K, P, M)
            Dc = torch.conj(delay_steering(taus, N))  # (B, K, P, N)
            flat = (torch.abs(S @ Phi @ Dc.transpose(-1, -2)) ** 2).reshape(B, K, P * P)
            if r < self.refine_rounds - 1:
                i = torch.argmax(flat, dim=-1, keepdim=True)
                f = torch.gather(fs, -1, i // P)[..., 0]
                tau = torch.gather(taus, -1, i % P)[..., 0]
            else:
                norm = torch.amax(flat, dim=-1, keepdim=True).detach()
                w = torch.softmax(softplus(self.softargmax_beta) * flat / (norm + 1e-20), dim=-1)
                wg = w.reshape(B, K, P, P)
                f = torch.sum(torch.sum(wg, dim=-1) * fs, dim=-1)
                tau = torch.sum(torch.sum(wg, dim=-2) * taus, dim=-1)
                height = torch.sum(w * flat, dim=-1)  # (B, K)
            half_t *= self.reduce_factor
            half_f *= self.reduce_factor

        # 4. confidence from scale-invariant statistics: height <= ||phi||^2 n
        e = torch.sum(torch.abs(phi2) ** 2, dim=-1, keepdim=True)
        h_rel = height / (e * n + 1e-20)
        h_top = height / (height[..., :1] + 1e-20)
        rank = torch.broadcast_to(
            torch.arange(K, dtype=torch.float32, device=phi.device) / K, height.shape)
        feats = torch.stack([h_rel, torch.sqrt(h_rel + 1e-20), h_top, rank], dim=-1)
        conf = torch.sigmoid(self.conf_out(torch.relu(self.conf_hidden(feats))))[..., 0]
        return (tau.reshape(*batch_shape, K), f.reshape(*batch_shape, K),
                conf.reshape(*batch_shape, K))

