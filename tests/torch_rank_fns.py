"""Rank functions of the port's multi-rank tests (``test_torch_parallel.py``,
``test_torch_cuda.py``), run by ``admmnet_tpu_torch.parallel.spawn_ranks``
in spawned processes.  This module imports torch, numpy and the port only,
never JAX: the ranks must not load it."""

import json
from pathlib import Path

import numpy as np
import torch


def fleet_checks(mesh, zlayer, train, workdir):
    """On one rank of a gloo fleet: the info, the sharded solve, the
    ZLayer on this rank's half of a batch, and ``train_admmnet`` on the
    mesh.  Returns numpy arrays and numbers."""
    from admmnet_tpu_torch.core.config import ModelConfig, ProblemSpec, TrainConfig
    from admmnet_tpu_torch.data.anchor import make_anchor_batch
    from admmnet_tpu_torch.models.layers import ZLayer
    from admmnet_tpu_torch.parallel import (bind_batch_mean, gather_batch, host_local_batch,
                                            sharded_solver)
    from admmnet_tpu_torch.train.trainer import train_admmnet

    out = {"info": (mesh.info.process_index, mesh.info.process_count, mesh.size),
           "local_slice": host_local_batch(16)}

    y, b, sigma = make_anchor_batch(16, mode="redemod", seed=0)
    phi = gather_batch(sharded_solver(mesh, num_iters=5)(y, b, sigma), mesh)
    out["phi"] = phi.numpy()
    out["solver_checksum"] = float(torch.sum(torch.abs(phi)))

    # the ZLayer on this rank's half, its batch mean over the fleet
    n = zlayer["G"].shape[-1] - 1
    z = ZLayer(n)
    z.load_state_dict({k: torch.from_numpy(v) for k, v in zlayer["params"].items()})
    z.eval()
    bind_batch_mean(z, mesh)
    (s, c), = mesh.local_slices(zlayer["G"].shape[0])
    args = [torch.from_numpy(zlayer[k][s:s + c]).requires_grad_(True)
            for k in ("phi", "h", "G", "Z")]
    Zn = z(*args, 2)
    w = torch.from_numpy(zlayer["w"][s:s + c])
    loss = torch.sum(w.real * Zn.real + w.imag * Zn.imag)
    loss.backward()
    out["z_out"] = Zn.detach().numpy()
    out["z_input_grads"] = {k: a.grad.numpy() for k, a in zip(("phi", "h", "G", "Z"), args)}
    out["z_param_grads"] = {k: (p.grad.numpy() if p.grad is not None
                                else np.zeros(tuple(p.shape), np.float32))
                            for k, p in z.named_parameters()}

    spec = ProblemSpec(**train["spec"])
    r = train_admmnet(ModelConfig(spec=spec, num_layers=2, hidden_dim=32),
                      TrainConfig(batch_size=8, epochs=2, patience=10), train["data"],
                      train["data"], test_data=train["data"], workdir=workdir,
                      log_fn=lambda *_: None, mesh=mesh)
    out["history"] = r.history
    out["test_metrics"] = r.test_metrics
    out["wrote"] = sorted(p.name for p in Path(workdir).iterdir())
    out["history_file"] = json.loads((Path(workdir) / "training_history.json").read_text())
    return out


def sharded_solve(mesh, y, b, sigma, iters, opts):
    """The gathered phi of ``sharded_solver`` on this rank's mesh, and the
    K2 launches this rank made."""
    from admmnet_tpu_torch.kernels import fused_admm_fast
    from admmnet_tpu_torch.parallel import gather_batch, sharded_solver

    fused_admm_fast.launches.reset()
    phi = gather_batch(sharded_solver(mesh, iters, opts=opts)(y, b, sigma), mesh)
    return phi.cpu().numpy(), fused_admm_fast.launches.count


def train_steps(mesh, data, steps):
    """``steps`` recipe-sized training steps on the mesh; the losses and
    the final parameters."""
    from admmnet_tpu_torch.core.config import ModelConfig, ProblemSpec, TrainConfig
    from admmnet_tpu_torch.train.trainer import train_admmnet
    import tempfile

    spec = ProblemSpec(Nb=4, Nd=4, L_max=2)
    with tempfile.TemporaryDirectory() as tmp:
        r = train_admmnet(ModelConfig(spec=spec, num_layers=2, hidden_dim=32, g_mode="chebyshev",
                                      cheb_impl="pallas", head="spectrum"),
                          TrainConfig(batch_size=data["y"].shape[0], epochs=steps,
                                      assignment="perm"),
                          data, data, workdir=tmp, log_fn=lambda *_: None, mesh=mesh)
    return r.history["train_loss"], {k: v.numpy() for k, v in r.params.items()}
