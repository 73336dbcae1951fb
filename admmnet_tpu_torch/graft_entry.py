"""Entry points of the port (counterpart of the repository's
``__graft_entry__.py``, which serves the JAX package).

``entry(device)``             -> (fn, example_args): the forward step of the
                                 flagship ADMMNet (10 unrolled layers,
                                 MN = 100, attention peak head) at B = 8;
                                 ``fn(params, y_re, y_im, theta, sigma)`` runs
                                 the model with ``params`` (a state_dict) in
                                 eval mode and returns (tau, f, conf, phi.real,
                                 phi.imag).  The example batch is the same
                                 numpy draw as the JAX package's.
``dryrun_multichip(n, ...)``  -> spawn ``n`` ranks, each running one real
                                 data-parallel training epoch through
                                 ``train_admmnet(mesh=...)`` and one sharded
                                 solve, and assert both are finite.
"""

from __future__ import annotations

import math
import tempfile

import numpy as np
import torch


def _example_host_batch(spec, B, seed=0):
    rng = np.random.default_rng(seed)
    n = spec.n
    y = rng.normal(size=(B, n)).astype(np.float32)
    yi = rng.normal(size=(B, n)).astype(np.float32)
    theta = rng.integers(0, 4, (B, n)).astype(np.float32)
    sigma = (np.abs(rng.normal(size=B)) + 1.0).astype(np.float32)
    return y, yi, theta, sigma


def entry(device="cuda"):
    from admmnet_tpu_torch.core.config import ModelConfig, ProblemSpec
    from admmnet_tpu_torch.models import ADMMNet
    from admmnet_tpu_torch.train.trainer import init_model

    spec = ProblemSpec(Nb=10, Nd=10, L_max=3)
    model = init_model(ADMMNet, ModelConfig(spec=spec, num_layers=10), 0, device).eval()
    host = _example_host_batch(spec, 8)

    def fwd(params, y_re, y_im, theta, sigma):
        y = torch.complex(y_re, y_im)
        b = torch.exp(1j * (math.pi / 2 * theta + math.pi / 4)).to(torch.complex64)
        with torch.no_grad():
            tau, f, conf, phi = torch.func.functional_call(model, params, (y, b, sigma))
        return tau, f, conf, phi.real, phi.imag

    params = dict(model.state_dict())
    return fwd, (params, *(torch.from_numpy(a).to(device) for a in host))


def _dryrun_rank(mesh, workdir):
    from admmnet_tpu_torch.core.config import DataConfig, ModelConfig, ProblemSpec, TrainConfig
    from admmnet_tpu_torch.data.generator import generate_batch
    from admmnet_tpu_torch.parallel import gather_batch, sharded_solver
    from admmnet_tpu_torch.train.trainer import train_admmnet

    dev = mesh.devices[0]
    spec = ProblemSpec(Nb=4, Nd=4, L_max=2)
    B = 2 * mesh.size
    batch = generate_batch(DataConfig(spec=spec), B,
                           torch.Generator(device=dev).manual_seed(0), device=dev)
    result = train_admmnet(
        ModelConfig(spec=spec, num_layers=2, hidden_dim=32),
        TrainConfig(batch_size=B, epochs=1, patience=1), batch, batch, test_data=batch,
        workdir=workdir, log_fn=lambda *_: None, mesh=mesh)
    loss = float(result.history["train_loss"][-1])
    assert np.isfinite(loss), loss
    phi = gather_batch(sharded_solver(mesh, num_iters=3)(batch["y"], batch["b"],
                                                          batch["sigma"]), mesh)
    s = float(torch.sum(torch.abs(phi)))
    assert np.isfinite(s), s
    return loss, s


def dryrun_multichip(n_devices: int, device: str = "cuda", backend=None):
    """One data-parallel training epoch (Nb = Nd = 4, 2 layers, hidden 32,
    global batch 2n) and one sharded 3-iteration solve on a fleet of
    ``n_devices`` ranks (``parallel.spawn_ranks``: "cuda" puts rank r on
    ``cuda:r``, "cuda:0" every rank on one card, "cpu" on the CPU with
    gloo).  Returns each rank's (train loss, sum |phi|)."""
    from admmnet_tpu_torch.parallel import spawn_ranks

    with tempfile.TemporaryDirectory() as tmp:
        out = spawn_ranks(_dryrun_rank, n_devices, backend=backend, device=device,
                          args=(tmp,))
    loss, s = out[0]
    print(f"dryrun_multichip ok: {n_devices} ranks on {device}, loss={loss:.6f}, "
          f"solver |phi| sum={s:.3f}")
    return out
