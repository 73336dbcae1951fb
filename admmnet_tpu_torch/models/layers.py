"""Unrolled-ADMM layer modules (torch.nn).

Counterparts of ``admmnet_tpu/models/layers.py``, with the same parameter
names (a flax ``nn.Dense`` named ``x`` is the ``nn.Linear`` attribute
``x``; scalar parameters are 0-d tensors), so a flax checkpoint loads
through ``core.convert.params_from_jax`` by renaming alone:

- layers pass the diagonal ``h`` vector between stages, not the (n, n)
  diagonal matrix;
- the GLayer's eigenvalue MLP runs on all eigenvalues in one batched call;
- the reference's stop-gradients (``ref_stop_gradients``) are ``.detach()``,
  and so is the eigenvector detach of the eigh GLayer.

Parameters start as flax's do: every ``Dense`` (an ``nn.Linear``) draws
its weight from ``lecun_normal`` (a normal truncated at two standard
deviations, of variance 1 / fan_in) and starts its bias at zero; the scalar
parameters start at the constants of the flax modules.  The draws come
from torch's global generator, as ``nn.Linear``'s own do.

All modules take and return batched tensors with a leading instance dim.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from admmnet_tpu_torch.ops.atoms import COMPLEX
from admmnet_tpu_torch.ops.linalg import assemble_lifted, fro_norm, hermitianize
from admmnet_tpu_torch.ops.projections import hermitian_eigh
from admmnet_tpu_torch.utils import profiling


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) without a linear cut-off (``jax.nn.softplus``;
    ``torch.nn.functional.softplus`` switches to x above 20)."""
    return torch.log1p(torch.exp(-torch.abs(x))) + torch.relu(x)


def scalar(value: float) -> nn.Parameter:
    return nn.Parameter(torch.tensor(value, dtype=torch.float32))


# standard deviation of a unit normal truncated to [-2, 2]
_TRUNCATED_STD = 0.87962566103423978


class Dense(nn.Linear):
    """``nn.Linear`` with flax ``nn.Dense``'s initializers: a lecun_normal
    weight and a zero bias."""

    def reset_parameters(self) -> None:
        std = math.sqrt(1.0 / self.in_features) / _TRUNCATED_STD
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, 0.0, std, -2.0 * std, 2.0 * std)
            if self.bias is not None:
                self.bias.zero_()


class PhiLayer(nn.Module):
    """Closed-form phi-update with learned rho."""

    def __init__(self, epsilon: float = 1e-8):
        super().__init__()
        self.epsilon = epsilon
        self.rho = scalar(1.0)

    def forward(self, y, b, G, Z):
        rho = softplus(self.rho)
        g = G[..., :-1, -1]
        zeta = Z[..., :-1, -1]
        b_sq = torch.abs(b) ** 2 + self.epsilon
        weight = (b_sq / (1.0 + rho * b_sq)).to(COMPLEX)
        return weight * (y / (b + self.epsilon) + rho * g + zeta)


class HLayer(nn.Module):
    """Learned diagonal-H update: target t = Re diag(G + Z/rho), additive
    correction t + 0.1 tanh(MLP(t)), then a soft radial projection toward
    {A ||h||_inf + sum(h) <= 1}: scale = min(1, sigmoid(w) / constraint).
    Returns the h vector (..., n)."""

    def __init__(self, dim: int, hidden: int = 64, epsilon: float = 1e-8):
        super().__init__()
        self.dim = dim
        self.epsilon = epsilon
        self.rho = scalar(1.0)
        self.projection_weight = scalar(1.0)
        self.correction_hidden = Dense(dim, hidden)
        self.correction_out = Dense(hidden, dim)

    def forward(self, phi, G, Z, sigma):
        n = self.dim
        rho = softplus(self.rho)
        T = G[..., :n, :n] + Z[..., :n, :n] / (rho + self.epsilon)
        t = torch.diagonal(T, dim1=-2, dim2=-1).real
        A = 2.0 * math.sqrt(float(n)) * sigma + sigma**2
        corr = torch.tanh(self.correction_out(torch.relu(self.correction_hidden(t))))
        t_c = t + 0.1 * corr
        l_inf = torch.amax(torch.abs(t_c), dim=-1)
        constraint = A * l_inf + torch.sum(t_c, dim=-1)
        scale = torch.sigmoid(self.projection_weight) / (constraint + self.epsilon)
        scale = torch.clamp(scale, max=1.0)
        return t_c * scale[..., None]


class GLayer(nn.Module):
    """Learned PSD step: build the lifted block matrix, apply the learned
    spectral filter softplus(w - sigmoid(thr)) * sigmoid(MLP(|w|)) to its
    spectrum, rebuild.

    ``mode="eigh"``: eigendecomposition with detached eigenvectors, filter
    on the eigenvalues, U diag(w') U^H; on the card the batched Jacobi
    kernel in complex64 (``kernels.eigh.eigh_detached``, lifted sides up
    to its ``MAX_SIDE``), on the CPU ``hermitian_eigh`` in complex128.  ``mode="chebyshev"``: the same
    filter as a Chebyshev matrix function of degree ``cheb_degree``;
    ``cheb_impl="xla"`` evaluates it with ``ops.chebyshev`` at
    ``cheb_precision``, ``cheb_impl="pallas"`` with the Clenshaw kernel.
    The parameter named ``lambda`` (a Python keyword) is registered under
    that name and read as ``self._parameters["lambda"]``.
    """

    def __init__(self, dim: int, value_hidden: int = 16, epsilon: float = 1e-8,
                 ref_stop_gradients: bool = True, mode: str = "eigh", cheb_degree: int = 48,
                 cheb_precision: str = "highest", cheb_impl: str = "xla"):
        super().__init__()
        self.epsilon = epsilon
        self.ref_stop_gradients = ref_stop_gradients
        self.mode = mode
        self.cheb_degree = cheb_degree
        self.cheb_precision = cheb_precision
        self.cheb_impl = cheb_impl
        self.register_parameter("lambda", scalar(0.1))
        self.rho = scalar(1.0)
        self.threshold = scalar(0.0)
        self.value_hidden = Dense(1, value_hidden)
        self.value_out = Dense(value_hidden, 1)

    def spectral_filter(self, w: torch.Tensor) -> torch.Tensor:
        """softplus(w - thr) * sigmoid(MLP(|w|)), pointwise on (..., k)."""
        thr = torch.sigmoid(self.threshold)
        s = torch.relu(self.value_hidden(torch.abs(w)[..., None]))
        s = torch.sigmoid(self.value_out(s))[..., 0]
        return softplus(w - thr) * s

    def forward(self, phi, h, Z):
        with profiling.span("models.glayer"):
            lam = softplus(self._parameters["lambda"])
            rho = softplus(self.rho)
            lam_inv = 1.0 / (lam**2 + self.epsilon)
            if self.ref_stop_gradients:
                lam_inv = lam_inv.detach()
            M = assemble_lifted(h, phi, lam_inv) - Z / (rho + self.epsilon)

            if self.mode == "chebyshev":
                if self.cheb_impl == "pallas":
                    from admmnet_tpu_torch.kernels.cheb_filter import apply_spectral_filter_kernel

                    G = apply_spectral_filter_kernel(hermitianize(M), self.spectral_filter,
                                                     self.cheb_degree)
                else:
                    from admmnet_tpu_torch.ops.chebyshev import apply_spectral_filter

                    G = apply_spectral_filter(hermitianize(M), self.spectral_filter,
                                              self.cheb_degree, self.cheb_precision)
                return hermitianize(G)

            close = profiling.backward_span("models.glayer_bwd", M)
            with profiling.span("models.eigh"):
                if M.is_cuda:
                    from admmnet_tpu_torch.kernels.eigh import eigh_detached

                    w, V = eigh_detached(M)
                else:
                    w, V = hermitian_eigh(M)
                    w = w.to(torch.float32)
                    V = V.to(COMPLEX).detach()
            w_new = self.spectral_filter(w).to(COMPLEX)
            G = (V * w_new[..., None, :]) @ torch.conj(V.transpose(-1, -2))
            return close(hermitianize(G))


class ZLayer(nn.Module):
    """Dual ascent with a learned adaptive step: step = softplus(rho) * scale,
    scale in [0.5, 2] from an MLP on [k/10, rho, ||R|| / mean_batch(||R||)].
    The mean couples the instances of a batch, as in the reference: the
    output of one instance depends on the batch it is evaluated in.

    ``batch_group``: None (the default) takes the mean over this process's
    batch.  Under data parallelism (``parallel.mesh.bind_batch_mean``) it is
    the fleet's process group, and the mean is over the global batch: the
    sum and the count all-reduced, the gradient of the sum all-reduced in
    the backward, so each rank's shard sees the mean the whole batch has
    in one process."""

    def __init__(self, dim: int, scale_hidden: int = 32, epsilon: float = 1e-8,
                 ref_stop_gradients: bool = True):
        super().__init__()
        self.epsilon = epsilon
        self.ref_stop_gradients = ref_stop_gradients
        self.register_parameter("lambda", scalar(1.0))
        self.rho = scalar(1.0)
        self.scale_hidden = Dense(3, scale_hidden)
        self.scale_out = Dense(scale_hidden, 1)
        self.batch_group = None

    def batch_mean(self, x: torch.Tensor) -> torch.Tensor:
        if self.batch_group is None:
            return torch.mean(x)
        from admmnet_tpu_torch.parallel.distributed import all_reduce_sum

        count = torch.tensor(float(x.numel()), dtype=x.dtype, device=x.device)
        total = all_reduce_sum(torch.stack([torch.sum(x), count]), self.batch_group)
        return total[0] / total[1]

    def forward(self, phi, h, G, Z_prev, k: int):
        lam = softplus(self._parameters["lambda"])
        rho = softplus(self.rho)
        lam_inv = 1.0 / (lam**2 + self.epsilon)
        if self.ref_stop_gradients:
            lam_inv = lam_inv.detach()
        R = G - assemble_lifted(h, phi, lam_inv)

        res_norm = fro_norm(R)
        k_feat = torch.full_like(res_norm, k / 10.0)
        rho_feat = torch.broadcast_to(rho, res_norm.shape)
        if self.ref_stop_gradients:
            rho_feat = rho_feat.detach()
        res_feat = res_norm / (self.batch_mean(res_norm) + self.epsilon)
        feats = torch.stack([k_feat, rho_feat, res_feat], dim=-1)
        s = torch.relu(self.scale_hidden(feats))
        s = torch.sigmoid(self.scale_out(s))[..., 0]
        step = (rho * (0.5 + 1.5 * s)).to(COMPLEX)
        return Z_prev + step[..., None, None] * R
