"""Port parity: data parallelism (``admmnet_tpu_torch.parallel``), the
trainer's ``mesh=`` and the entry points of ``graft_entry``.

The JAX package runs its mesh on 8 virtual CPU devices (tests/conftest.py);
the port runs one process per device, so its fleets here are 2 spawned
ranks on the gloo backend on the CPU (``parallel.spawn_ranks``, started
from ``COORDINATOR`` / ``NPROC`` / ``PROC_ID``).  The ranks import no JAX:
their functions live in ``tests/torch_rank_fns.py``.  Tolerances are the
JAX package's own for the same checks: the sharded solve 2e-5
(tests/test_parallel.py), the mesh trainer's losses rtol 5e-4 and its
detection scores 1e-6 (tests/test_mesh_training.py); the ZLayer under two
ranks 1e-5 (fp32 sums in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_rank_fns
from admmnet_tpu_torch.core.config import DataConfig, ModelConfig, ProblemSpec, TrainConfig
from admmnet_tpu_torch.core.convert import flax_to_state_dict
from admmnet_tpu_torch.data.generator import generate_batch
from admmnet_tpu_torch.parallel import (DistributedInfo, data_mesh, gather_batch,
                                        host_local_batch, init_distributed, replicate,
                                        shard_batch, sharded_solver, spawn_ranks)

torch.set_num_threads(1)  # JAX and torch share the cores of one test worker

SPEC = dict(Nb=4, Nd=4, L_max=2)


def _silent(*_a, **_k):
    pass


@pytest.mark.parametrize("B, P", [(10, 3), (100, 1), (7, 4)])
def test_host_local_batch_matches_jax(B, P):
    from admmnet_tpu.parallel import DistributedInfo as JInfo
    from admmnet_tpu.parallel import host_local_batch as jhost_local_batch

    for pid in range(P):
        assert (host_local_batch(B, DistributedInfo(pid, P, 1, P))
                == jhost_local_batch(B, JInfo(pid, P, 4, 4 * P)))


def test_init_distributed_single_process_noop(monkeypatch):
    for name in ("COORDINATOR", "NPROC", "PROC_ID", "MASTER_ADDR", "MASTER_PORT",
                 "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    info = init_distributed()
    assert info.process_count == 1 and info.is_main
    assert not torch.distributed.is_initialized()
    assert host_local_batch(100, info) == (0, 100)
    with pytest.raises(ValueError, match="process id not given"):
        init_distributed("localhost:1", 2)


def test_data_mesh_devices():
    mesh = data_mesh(4, device="cpu")
    assert mesh.size == 4 and mesh.group is None
    assert mesh.local_slices(10) == [(0, 3), (3, 3), (6, 2), (8, 2)]
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match=r"requested 2 devices, have \d"):
            data_mesh(2)
    with pytest.raises(ValueError, match="model axis has size 1"):
        data_mesh(2, model_axis=2, device="cpu")


def test_shard_batch_gather_and_replicate():
    from admmnet_tpu_torch.data.anchor import make_anchor_batch

    mesh = data_mesh(3, device="cpu")
    y, b, sigma = make_anchor_batch(8, seed=1)
    shards = shard_batch({"y": y, "sigma": sigma}, mesh)
    assert [s["y"].shape[0] for s in shards] == [3, 3, 2]
    assert shards[0]["y"].dtype == torch.complex64
    back = gather_batch(shards, mesh)
    np.testing.assert_array_equal(back["y"].numpy(), y)
    np.testing.assert_array_equal(back["sigma"].numpy(), sigma)
    reps = replicate({"b": b}, mesh)
    assert len(reps) == 3 and all(np.array_equal(r["b"].numpy(), b) for r in reps)


def test_sharded_solver_matches_jax():
    """4 CPU shards of the port against JAX's 8-device sharded solve."""
    from admmnet_tpu.data.anchor import make_anchor_batch as jmake_anchor_batch
    from admmnet_tpu.parallel import data_mesh as jdata_mesh
    from admmnet_tpu.parallel import sharded_solver as jsharded_solver
    from admmnet_tpu.utils import to_host
    from admmnet_tpu_torch.data.anchor import make_anchor_batch

    y, b, sigma = make_anchor_batch(16, mode="redemod", seed=0)
    jy, jb, js = jmake_anchor_batch(16, mode="redemod", seed=0)
    np.testing.assert_array_equal(y, jy)
    ref = to_host(jsharded_solver(jdata_mesh(8), num_iters=5)(jy, jb, js))
    mesh = data_mesh(4, device="cpu")
    phi = gather_batch(sharded_solver(mesh, num_iters=5)(y, b, sigma), mesh)
    np.testing.assert_allclose(phi.numpy(), ref, atol=2e-5)


def test_mesh_trainer_refuses_devices_of_one_process(tmp_path):
    data = generate_batch(DataConfig(spec=ProblemSpec(**SPEC)), 8,
                          torch.Generator().manual_seed(0), device="cpu")
    from admmnet_tpu_torch.train.trainer import train_admmnet

    with pytest.raises(ValueError, match="one rank per device"):
        train_admmnet(ModelConfig(spec=ProblemSpec(**SPEC), num_layers=2, hidden_dim=32),
                      TrainConfig(batch_size=4, epochs=1), data, data, workdir=tmp_path,
                      log_fn=_silent, mesh=data_mesh(2, device="cpu"))


@pytest.mark.parametrize("shuffle", [True, False])
def test_drop_remainder_matches_jax(shuffle):
    from admmnet_tpu.data import loader as jloader
    from admmnet_tpu.data.generator import iterate_batches as jiterate
    from admmnet_tpu_torch.data import loader
    from admmnet_tpu_torch.data.generator import iterate_batches

    rng = np.random.default_rng(4)
    data = {"y": (rng.normal(size=(23, 6)) + 1j * rng.normal(size=(23, 6))).astype(np.complex64),
            "L_true": rng.integers(0, 3, 23).astype(np.int32)}
    pairs = [(iterate_batches, jiterate)]
    if loader.native_available() and jloader.native_available():
        pairs.append((loader.PrefetchLoader, jloader.PrefetchLoader))
    for port, ref in pairs:
        got = list(port(data, 5, shuffle=shuffle, seed=3, drop_remainder=True))
        want = list(ref(data, 5, shuffle=shuffle, seed=3, drop_remainder=True))
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            for k in data:
                np.testing.assert_array_equal(g[k], w[k])
    if loader.native_available():
        assert len(loader.PrefetchLoader(data, 5, drop_remainder=True)) == 4


# ---- a 2-rank gloo fleet -------------------------------------------------------

ZN, ZB = 16, 6


def _zlayer_case():
    from admmnet_tpu.models import layers as jlayers

    rng = np.random.default_rng(0)

    def cplx(*shape):
        return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)

    def herm(scale):
        X = cplx(ZB, ZN + 1, ZN + 1)
        return ((X + np.conj(np.swapaxes(X, -1, -2))) * scale).astype(np.complex64)

    x = {"phi": 0.3 * cplx(ZB, ZN), "h": (0.05 * rng.normal(size=(ZB, ZN))).astype(np.float32),
         "G": herm(0.1), "Z": herm(0.05), "w": cplx(ZB, ZN + 1, ZN + 1)}
    jz = jlayers.ZLayer(dim=ZN)
    params = jz.init(jax.random.PRNGKey(0), x["phi"], x["h"], x["G"], x["Z"], 2)["params"]
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + (0.1 * rng.normal(size=np.shape(p))).astype(np.float32),
        params)

    def loss(p, phi, h, G, Z):
        out = jz.apply({"params": p}, phi, h, G, Z, 2)
        return jnp.sum(x["w"].real * out.real + x["w"].imag * out.imag), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        params, x["phi"], x["h"], x["G"], x["Z"])
    x["params"] = {k: v.numpy() for k, v in flax_to_state_dict(params).items()}
    ref = {"out": np.asarray(out),
           "params": {k: v.numpy() for k, v in flax_to_state_dict(grads[0]).items()},
           # JAX's gradient of a real loss in a complex input is the
           # conjugate of torch's
           "inputs": {k: np.conj(np.asarray(g)) for k, g in zip(("phi", "h", "G", "Z"),
                                                                grads[1:])}}
    return x, ref


def _train_data():
    return generate_batch(DataConfig(spec=ProblemSpec(**SPEC)), 16,
                          torch.Generator().manual_seed(0), device="cpu")


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    zlayer, zref = _zlayer_case()
    data = _train_data()
    workdir = tmp_path_factory.mktemp("fleet")
    ranks = spawn_ranks(torch_rank_fns.fleet_checks, 2, backend="gloo", device="cpu",
                        args=(zlayer, {"spec": SPEC, "data": data}, str(workdir)), timeout=240)
    return {"ranks": ranks, "zref": zref, "data": data, "workdir": workdir}


def test_fleet_sharded_solve_equals_single_process(fleet):
    from admmnet_tpu_torch.data.anchor import make_anchor_batch
    from admmnet_tpu_torch.solver import admm_solve_fixed

    r0, r1 = fleet["ranks"]
    assert r0["info"] == (0, 2, 2) and r1["info"] == (1, 2, 2)
    assert r0["local_slice"] == (0, 8) and r1["local_slice"] == (8, 8)
    assert r0["solver_checksum"] == r1["solver_checksum"]
    y, b, sigma = make_anchor_batch(16, mode="redemod", seed=0)
    phi = admm_solve_fixed(torch.from_numpy(y), torch.from_numpy(b), torch.from_numpy(sigma), 5)
    np.testing.assert_allclose(r0["phi"], phi.numpy(), atol=2e-5)
    assert r0["solver_checksum"] == pytest.approx(float(torch.sum(torch.abs(phi))), rel=1e-6)


def test_fleet_zlayer_equals_jax_on_the_whole_batch(fleet):
    """Each rank holds half of the batch; the ZLayer's mean is over the
    whole batch in the forward and the backward: each half's output and
    input gradients equal JAX's on the whole batch, and the ranks'
    parameter gradients sum to JAX's (DDP averages them, and the loss of
    the whole batch is the sum of the halves')."""
    ref = fleet["zref"]
    halves = [slice(0, ZB // 2), slice(ZB // 2, ZB)]
    for r, sl in zip(fleet["ranks"], halves):
        np.testing.assert_allclose(r["z_out"], ref["out"][sl], atol=1e-5, rtol=1e-5)
        for k, g in r["z_input_grads"].items():
            np.testing.assert_allclose(g, ref["inputs"][k][sl], atol=1e-5, rtol=1e-5)
    for k, g in ref["params"].items():
        total = sum(r["z_param_grads"][k] for r in fleet["ranks"])
        np.testing.assert_allclose(total, g, atol=1e-5, rtol=1e-5)


def test_fleet_trainer_follows_the_single_process_run(fleet, tmp_path):
    from admmnet_tpu_torch.train.trainer import train_admmnet

    data = fleet["data"]
    single = train_admmnet(ModelConfig(spec=ProblemSpec(**SPEC), num_layers=2, hidden_dim=32),
                           TrainConfig(batch_size=8, epochs=2, patience=10), data, data,
                           test_data=data, workdir=tmp_path, log_fn=_silent, device="cpu")
    for r in fleet["ranks"]:
        np.testing.assert_allclose(r["history"]["train_loss"], single.history["train_loss"],
                                   rtol=5e-4)
        np.testing.assert_allclose(r["history"]["val_loss"], single.history["val_loss"],
                                   rtol=5e-4)
        np.testing.assert_allclose(r["history"]["tau_rmse"], single.history["tau_rmse"],
                                   atol=2e-4)
        for k in ("f1_score", "precision", "recall"):
            assert r["test_metrics"][k] == pytest.approx(single.test_metrics[k], abs=1e-6)
    assert fleet["ranks"][0]["history"] == fleet["ranks"][1]["history"]


def test_fleet_rank0_alone_writes(fleet):
    import json

    workdir = fleet["workdir"]
    for name in ("training_history.json", "test_result.json", "best_model.msgpack"):
        assert (workdir / name).exists()
    kinds = [json.loads(line)["kind"] for line in
             (workdir / "metrics.jsonl").read_text().splitlines()]
    assert kinds == ["epoch", "epoch", "test"]  # one writer: no record twice
    assert fleet["ranks"][0]["history_file"] == fleet["ranks"][0]["history"]


# ---- entry points of graft_entry -----------------------------------------------


def test_graft_entry_matches_jax():
    """The port's entry() against the forward of the JAX package's entry()
    (``ADMMNet.apply`` on y and b made from the same example draws) at the
    port's parameters, converted.  JAX's entry() itself also compiles its
    own init, which the comparison does not need."""
    import __graft_entry__ as jge
    from admmnet_tpu.core.config import ModelConfig as JModelConfig
    from admmnet_tpu.core.config import ProblemSpec as JProblemSpec
    from admmnet_tpu.models import ADMMNet as JADMMNet
    from admmnet_tpu_torch import graft_entry
    from admmnet_tpu_torch.core.config import ModelConfig as TModelConfig
    from admmnet_tpu_torch.core.convert import params_to_jax

    fn, args = graft_entry.entry(device="cpu")
    spec = JProblemSpec(Nb=10, Nd=10, L_max=3)
    for a, j in zip(args[1:], jge._example_host_batch(spec, 8)):
        np.testing.assert_array_equal(a.numpy(), j)
    out = [o.numpy() for o in fn(args[0], *args[1:])]
    assert out[0].shape == (8, 3) and out[3].shape == (8, 100)

    jmodel = JADMMNet(cfg=JModelConfig(spec=spec, num_layers=10))
    cfg = TModelConfig(spec=ProblemSpec(Nb=10, Nd=10, L_max=3), num_layers=10)
    params = {"params": params_to_jax({k: v for k, v in args[0].items()}, cfg)}

    @jax.jit
    def jfwd(p, y_re, y_im, theta, sigma):  # the body of JAX's entry() fwd
        y = (y_re + 1j * y_im).astype(jnp.complex64)
        b = jnp.exp(1j * (jnp.pi / 2 * theta + jnp.pi / 4)).astype(jnp.complex64)
        tau, f, conf, phi = jmodel.apply(p, y, b, sigma)
        return tau, f, conf, jnp.real(phi), jnp.imag(phi)

    ref = [np.asarray(r) for r in jfwd(params, *(a.numpy() for a in args[1:]))]
    phi, phi_ref = out[3] + 1j * out[4], ref[3] + 1j * ref[4]
    assert np.linalg.norm(phi - phi_ref) / np.linalg.norm(phi_ref) < 1e-4
    for o, r in zip(out[:3], ref[:3]):
        np.testing.assert_allclose(o, r, atol=1e-3)


def test_dryrun_multichip_on_the_cpu():
    from admmnet_tpu_torch.graft_entry import dryrun_multichip

    out = dryrun_multichip(2, device="cpu")
    assert out[0] == out[1] and all(np.isfinite(out[0]))
