"""Training loops for ADMMNet (end to end) and PhiEstADMMNet (phi
regression).  Counterpart of ``admmnet_tpu/train/trainer.py``:

- AdamW in two groups, the model's ``ADMM_LR_MODULES`` (the trunk) at
  ``admm_lr_scale * lr`` and the rest at ``lr``, decoupled weight decay;
- the global gradient norm clipped in optax's form: g unchanged when
  ||g|| < c, else g / ||g|| * c (``torch.nn.utils.clip_grad_norm_`` would
  add 1e-6 to the norm);
- the SGDR learning rate evaluated at the number of updates made before
  each one, as optax does;
- minibatches from the native prefetch loader when it builds, else the
  numpy iterator, as the JAX trainer chooses (the two orders differ);
- best-on-validation checkpoints in the JAX package's format, resume,
  ``reset_best``, early stop, the best checkpoint reloaded for the test
  metrics (count-based precision/recall/F1 and the position-matched
  co-report);
- data parallelism with ``mesh=`` (``parallel.data_mesh()`` on each rank
  of a fleet, one rank per device): every rank draws the same global
  minibatches, feeds its ``host_local_batch`` slice of each to the model
  wrapped in ``DistributedDataParallel`` (gradients averaged over the
  ranks), and the ZLayers take their batch mean over the global batch
  (``parallel.mesh.bind_batch_mean``), so a step is the single-process
  step on the global minibatch.  Remainder minibatches are dropped, the
  losses and metrics are reduced over the ranks (every rank reports the
  global numbers), and rank 0 alone writes the checkpoint, history and
  metrics; the ranks meet at a barrier before reloading the best
  checkpoint from the shared workdir.

A train step runs the model in ``train()`` mode with autograd (the
chebyshev GLayer launches the training forward K5 and the reversible
backward K6 on CUDA); an eval step runs in ``eval()`` mode under
``torch.no_grad()`` (K4).  Batches keep their order and size: the ZLayer
couples the instances of a batch.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from admmnet_tpu_torch.core.config import ModelConfig, TrainConfig
from admmnet_tpu_torch.core.convert import params_from_jax, params_to_jax
from admmnet_tpu_torch.data import loader
from admmnet_tpu_torch.data.generator import iterate_batches
from admmnet_tpu_torch.models import ADMMNet, PhiEstADMMNet
from admmnet_tpu_torch.ops.atoms import COMPLEX
from admmnet_tpu_torch.parallel.mesh import Mesh, barrier, bind_batch_mean
from admmnet_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from admmnet_tpu_torch.train.losses import basic_anm_loss, phi_alignment_loss
from admmnet_tpu_torch.train.metrics_io import MetricsWriter
from admmnet_tpu_torch.train.schedules import sgdr_schedule
from admmnet_tpu_torch.utils import profiling
from admmnet_tpu_torch.utils.retry import device_retry

# position-matched test-metric tolerance (peaks/metrics.py, eval_net)
MATCH_TOL = 0.05


@dataclasses.dataclass
class TrainResult:
    params: Dict[str, torch.Tensor]  # the best state_dict
    history: Dict[str, list]
    best_val_loss: float
    test_metrics: Dict[str, Any]
    epochs_run: int


# ---- optimizer ---------------------------------------------------------------


def make_optimizer(model: torch.nn.Module, tcfg: TrainConfig) -> torch.optim.AdamW:
    """AdamW with the groups "admm" (parameters under the model's
    ``ADMM_LR_MODULES``, lr scale ``admm_lr_scale``) and "other" (scale 1).
    Each group's "scale" times the schedule gives its lr at every step."""
    admm_modules = set(getattr(type(model), "ADMM_LR_MODULES", ("trunk",)))
    groups = {"admm": [], "other": []}
    for name, p in model.named_parameters():
        groups["admm" if name.split(".")[0] in admm_modules else "other"].append(p)
    if admm_modules and not groups["admm"]:
        raise ValueError(f"ADMM LR-group modules {sorted(admm_modules)} matched no params")
    scales = {"admm": tcfg.admm_lr_scale, "other": 1.0}
    return torch.optim.AdamW(
        [{"params": ps, "name": k, "scale": scales[k]} for k, ps in groups.items() if ps],
        lr=tcfg.lr, betas=(0.9, 0.999), eps=1e-8,  # optax.adamw's defaults
        weight_decay=tcfg.weight_decay)


def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` on the ``.grad`` of ``params``, in
    place; returns the norm before clipping (a device scalar, no sync)."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def opt_state_to_jax(optimizer: torch.optim.AdamW, model: torch.nn.Module,
                     cfg: ModelConfig) -> Dict[str, Any]:
    """The AdamW state as ``{"step", "exp_avg", "exp_avg_sq"}``, each moment
    a flax-layout tree keyed by the parameter paths (as ``params_to_jax``
    lays out the parameters)."""
    names = {id(p): n for n, p in model.named_parameters()}
    moments: Dict[str, Dict[str, torch.Tensor]] = {"exp_avg": {}, "exp_avg_sq": {}}
    step = 0
    for p, st in optimizer.state.items():
        step = int(st["step"])
        for k in moments:
            moments[k][names[id(p)]] = st[k]
    if not moments["exp_avg"]:
        return {"step": 0}
    return {"step": step, **{k: params_to_jax(v, cfg) for k, v in moments.items()}}


def load_opt_state(optimizer: torch.optim.AdamW, model: torch.nn.Module, cfg: ModelConfig,
                   state: Dict[str, Any]) -> None:
    """Inverse of ``opt_state_to_jax``; raises on a state the port did not
    write (such as the JAX package's optax state)."""
    if not isinstance(state, dict) or "step" not in state:
        raise ValueError("the checkpoint's opt_state was not written by the port")
    if state["step"] == 0:
        return
    moments = {k: params_from_jax(state[k], cfg) for k in ("exp_avg", "exp_avg_sq")}
    for name, p in model.named_parameters():
        optimizer.state[p] = {
            "step": torch.tensor(float(state["step"])),
            **{k: v[name].to(p.device, p.dtype) for k, v in moments.items()},
        }


# ---- metrics -----------------------------------------------------------------


def _detection_counts_dev(conf, L_true, thr):
    """Count-based detection protocol as device scalars: (tp, fp, fn)."""
    detected = torch.sum(conf > thr, dim=-1)
    L = L_true.to(torch.int64)
    tp = torch.sum(torch.minimum(L, detected) * ((L > 0) & (detected > 0)))
    fp = torch.sum(torch.clamp_min(detected - L, 0))
    fn = torch.sum(torch.clamp_min(L - detected, 0))
    return tp, fp, fn


def _masked_rmse_parts(pred, true, L_true):
    """(sum of the per-sample RMSEs over the real targets, count of samples
    with targets); ``_masked_rmse_dev`` is their ratio."""
    L_max = pred.shape[-1]
    mask = torch.arange(L_max, device=pred.device)[None, :] < L_true[:, None]
    cnt = torch.clamp_min(L_true, 1)
    rmse = torch.sqrt(torch.sum(mask * (pred - true) ** 2, dim=-1) / cnt)
    sel = L_true > 0
    return torch.sum(rmse * sel), torch.sum(sel)


def _masked_rmse_dev(pred, true, L_true):
    """Per-sample RMSE over the real targets, averaged over samples with
    targets."""
    num, count = _masked_rmse_parts(pred, true, L_true)
    return num / torch.clamp_min(count, 1)


def _matched_rmse_pair_dev(tau_pred, f_pred, tau_true, f_true, L_true):
    """(tau RMSE, f RMSE) under each sample's best slot-to-target
    assignment (the assignment minimizing the masked tau + f MSE)."""
    tau_num, f_num, count = _matched_rmse_pair_parts(tau_pred, f_pred, tau_true, f_true,
                                                     L_true)
    denom = torch.clamp_min(count, 1)
    return tau_num / denom, f_num / denom


def _matched_rmse_pair_parts(tau_pred, f_pred, tau_true, f_true, L_true):
    """(tau RMSE sum, f RMSE sum, count of samples with targets) of
    ``_matched_rmse_pair_dev``."""
    L_max = tau_pred.shape[-1]
    perms = torch.tensor(list(itertools.permutations(range(L_max))), device=tau_pred.device)
    mask = (torch.arange(L_max, device=tau_pred.device)[None, :]
            < L_true[:, None]).to(tau_pred.dtype)
    cnt = torch.clamp_min(L_true, 1).to(tau_pred.dtype)
    tau_mse = torch.sum(mask[:, None, :] * (tau_pred[:, perms] - tau_true[:, None, :]) ** 2,
                        dim=-1) / cnt[:, None]
    f_mse = torch.sum(mask[:, None, :] * (f_pred[:, perms] - f_true[:, None, :]) ** 2,
                      dim=-1) / cnt[:, None]
    best = torch.argmin(tau_mse + f_mse, dim=-1, keepdim=True)
    tau_rmse = torch.sqrt(torch.gather(tau_mse, 1, best))[:, 0]
    f_rmse = torch.sqrt(torch.gather(f_mse, 1, best))[:, 0]
    sel = L_true > 0
    return torch.sum(tau_rmse * sel), torch.sum(f_rmse * sel), torch.sum(sel)


def _matched_detection_dev(tau_pred, f_pred, conf, tau_true, f_true, L_true, tol, thr):
    """Location-matched detection as device scalars (tp, fp, fn, tau_sse,
    f_sse): greedy, target by target, a prediction with conf > thr within
    ``tol`` in both tau and f of an unmatched target is a true positive."""
    K, L = tau_pred.shape[-1], tau_true.shape[-1]
    valid_pred = conf > thr
    used = torch.zeros_like(valid_pred)
    tp = fn = 0
    tau_sse = f_sse = 0.0
    inf = torch.tensor(float("inf"), device=tau_pred.device)
    for l in range(L):
        t_valid = l < L_true.to(torch.int64)
        dt = torch.abs(tau_pred - tau_true[:, l:l + 1])
        df = torch.abs(f_pred - f_true[:, l:l + 1])
        ok = valid_pred & ~used & (dt <= tol) & (df <= tol)
        j = torch.argmin(torch.where(ok, dt**2 + df**2, inf), dim=-1, keepdim=True)
        hit = torch.gather(ok, 1, j)[:, 0] & t_valid
        used = used | (torch.nn.functional.one_hot(j[:, 0], K).bool() & hit[:, None])
        tp = tp + torch.sum(hit)
        fn = fn + torch.sum(t_valid & ~hit)
        tau_sse = tau_sse + torch.sum(torch.where(hit, torch.gather(dt, 1, j)[:, 0] ** 2, 0.0))
        f_sse = f_sse + torch.sum(torch.where(hit, torch.gather(df, 1, j)[:, 0] ** 2, 0.0))
    fp = torch.sum(valid_pred & ~used)
    return tp, fp, fn, tau_sse, f_sse


# ---- steps -------------------------------------------------------------------


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy minibatch as tensors on ``device`` (complex64 y, b, phi)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if t.is_complex():
            t = t.to(COMPLEX)
        elif t.is_floating_point():
            t = t.to(torch.float32)
        out[k] = t.to(device)
    return out


def build_steps(model: torch.nn.Module, optimizer: torch.optim.AdamW, mode: str,
                schedule: Callable[[int], float], grad_clip: float = 1.0,
                assignment: str = "slot", spectral_weight: float = 0.0,
                conf_threshold: float = 0.5, ddp: Optional[torch.nn.Module] = None,
                group=None, log_fn: Callable[[str], None] = print):
    """(train_step, eval_step) of ``model``.

    ``mode``: "e2e" (ADMMNet + ``basic_anm_loss``) or "phi"
    (PhiEstADMMNet + ``phi_alignment_loss``).  ``train_step(batch, step)``
    sets each group's lr to its scale times ``schedule(step)``, takes one
    clipped AdamW step and returns the loss (a device scalar);
    ``eval_step(batch)`` returns (loss, metrics), the metrics device
    scalars: tau/f RMSE under ``assignment`` and the count-based and
    position-matched detection counts for "e2e", none for "phi".

    Data parallelism: ``ddp`` is ``model`` wrapped in
    ``DistributedDataParallel`` (the training forward runs through it, so
    the gradients are averaged over the ranks), ``group`` the fleet's
    process group: ``eval_step`` then returns the loss and metrics of the
    global minibatch (the sums all-reduced before the ratios are taken).

    Device retries (``utils.retry.device_retry``, as the JAX trainer wraps
    its jitted steps): in one process the eval step and the train step up
    to ``optimizer.step()`` (zeroing the gradients, forward, backward,
    clipping) are retried on a transient device failure, each retry
    logged through ``log_fn``; the update itself is not, so a retry never
    applies it twice.  Under a fleet (``group``) nothing is retried: a rank
    that repeats a collective would wait on ranks that have moved on.

    Spans (``utils.profiling``): ``train.step`` around ``train.forward``,
    ``train.loss``, ``train.backward`` (with the zero-fill of leaves the
    loss misses), ``train.clip`` and ``train.optimizer``; ``eval.step``
    around ``eval.forward`` and ``eval.loss``.
    """
    params = [p for g in optimizer.param_groups for p in g["params"]]
    world = dist.get_world_size(group) if group is not None else 1

    def loss_and_aux(net, batch, stage: str):
        """The loss and the head's outputs; ``stage`` ("train" or "eval")
        names the forward's and the loss's spans."""
        with profiling.span(stage + ".forward"):
            out = net(batch["y"], batch["b"], batch["sigma"])
        with profiling.span(stage + ".loss"):
            if mode == "e2e":
                tau, f, conf, phi = out
                total, _ = basic_anm_loss(tau, f, conf, phi, batch["tau"], batch["f"],
                                          batch["L_true"], assignment=assignment,
                                          spectral_weight=spectral_weight, spec=model.cfg.spec)
                return total, {"tau": tau, "f": f, "conf": conf}
            total, _ = phi_alignment_loss(out, batch["phi"])
            return total, {}

    def retried(fn):
        return fn if group is not None else device_retry(fn, log_fn=log_fn)

    @retried
    def gradients(batch):
        """The clipped gradients of the batch's loss; the loss."""
        optimizer.zero_grad(set_to_none=True)
        total, _ = loss_and_aux(ddp if ddp is not None else model, batch, "train")
        with profiling.span("train.backward"):
            total.backward()
            for p in params:  # optax updates (and decays) parameters the loss misses too
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        with profiling.span("train.clip"):
            clip_by_global_norm_(params, grad_clip)
        return total.detach()

    def train_step(batch, step: int):
        with profiling.span("train.step"):
            model.train()
            lr = schedule(step)
            for g in optimizer.param_groups:
                g["lr"] = g["scale"] * lr
            total = gradients(batch)
            with profiling.span("train.optimizer"):
                optimizer.step()
            return total

    def global_sums(*vals):
        """The values summed over the ranks (float64 on the wire, returned
        in their own dtypes); as given in one process."""
        if group is None:
            return vals
        packed = torch.stack([v.to(torch.float64) for v in vals])
        dist.all_reduce(packed, group=group)
        return tuple(p.to(v.dtype) for p, v in zip(packed, vals))

    @retried
    @torch.no_grad()
    def eval_step(batch):
        with profiling.span("eval.step"):
            model.eval()
            total, aux = loss_and_aux(model, batch, "eval")
            if mode != "e2e":
                (total,) = global_sums(total)
                return total / world, {}
            L = batch["L_true"]
            if assignment == "perm":
                t_num, f_num, count = _matched_rmse_pair_parts(aux["tau"], aux["f"],
                                                               batch["tau"], batch["f"], L)
            else:
                t_num, count = _masked_rmse_parts(aux["tau"], batch["tau"], L)
                f_num, _ = _masked_rmse_parts(aux["f"], batch["f"], L)
            tp, fp, fn = _detection_counts_dev(aux["conf"], L, conf_threshold)
            mtp, mfp, mfn, m_tau_sse, m_f_sse = _matched_detection_dev(
                aux["tau"], aux["f"], aux["conf"], batch["tau"], batch["f"], L,
                MATCH_TOL, conf_threshold)
            (total, t_num, f_num, count, tp, fp, fn, mtp, mfp, mfn, m_tau_sse,
             m_f_sse) = global_sums(total, t_num, f_num, count, tp, fp, fn, mtp, mfp, mfn,
                                    torch.as_tensor(m_tau_sse), torch.as_tensor(m_f_sse))
            denom = torch.clamp_min(count, 1)
            metrics = {"tau_rmse": t_num / denom, "f_rmse": f_num / denom, "tp": tp, "fp": fp,
                       "fn": fn, "mtp": mtp, "mfp": mfp, "mfn": mfn, "m_tau_sse": m_tau_sse,
                       "m_f_sse": m_f_sse}
            return total / world, metrics

    return train_step, eval_step


# ---- loop --------------------------------------------------------------------


def _graft_params(tree, donor, log_fn):
    """Replace subtrees of the flax-layout ``tree`` by same-named,
    same-shaped subtrees of ``donor``, recursing into partly matching
    modules; a same-named leaf of another shape raises."""
    taken, kept = [], []

    def merge(tgt, src, path):
        if isinstance(tgt, dict) and isinstance(src, dict):
            out = dict(tgt)
            for k, v in src.items():
                if k in tgt:
                    out[k] = merge(tgt[k], v, f"{path}/{k}")
            kept.extend(f"{path}/{k}" for k in tgt if k not in src)
            return out
        if np.shape(tgt) != np.shape(src):
            raise ValueError(f"init_from leaf {path} shape mismatch: "
                             f"{np.shape(src)} vs {np.shape(tgt)}")
        taken.append(path)
        return np.asarray(src, dtype=np.float32)

    grafted = {k: merge(tree[k], v, k) for k, v in donor.items() if k in tree}
    if not taken:
        raise ValueError("init_from checkpoint shares no submodules with model")
    mods = sorted({p.split("/")[0] for p in taken})
    log_fn(f"warm-started {len(taken)} leaves in submodules {mods} from init_from "
           f"checkpoint" + (f"; fresh-init kept for {kept}" if kept else ""))
    return {**tree, **grafted}


def _batches(data, batch_size: int, shuffle: bool, seed: int, mesh: Optional[Mesh] = None):
    """Minibatch stream, chosen as the JAX trainer chooses it: the native
    prefetch loader (``data/loader.py``) when its library builds, else the
    numpy iterator.  The two shuffle differently; the native one is JAX's
    native order bit for bit.  Under a mesh the remainder is dropped and
    each global minibatch is cut to this rank's ``host_local_batch``
    slice."""
    drop = mesh is not None
    if loader.native_available():
        stream = loader.PrefetchLoader(data, batch_size, shuffle=shuffle, seed=seed,
                                       drop_remainder=drop)
    else:
        stream = iterate_batches(data, batch_size, shuffle=shuffle, seed=seed,
                                 drop_remainder=drop)
    if mesh is None:
        return stream
    (start, count), = mesh.local_slices(batch_size)
    return ({k: v[start:start + count] for k, v in batch.items()} for batch in stream)


def _prf(tp, fp, fn):
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    f1 = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
    return precision, recall, f1


def evaluate_split(eval_step, data, batch_size: int, device, mode: str,
                   mesh: Optional[Mesh] = None) -> Dict[str, Any]:
    """Loss and metrics of ``data`` in minibatches of ``batch_size``, in
    order: the JAX trainer's test metrics (the detection counts stay 0 in
    "phi" mode).  Under a mesh, ``eval_step`` must be the mesh's (its
    numbers are the global minibatch's)."""
    losses, tau_es, f_es = [], [], []
    sums = dict.fromkeys(("tp", "fp", "fn", "mtp", "mfp", "mfn", "m_tau_sse", "m_f_sse"), 0.0)
    for batch in _batches(data, batch_size, shuffle=False, seed=0, mesh=mesh):
        total, m = eval_step(batch_to_device(batch, device))
        losses.append(float(total))
        if mode == "e2e":
            tau_es.append(float(m["tau_rmse"]))
            f_es.append(float(m["f_rmse"]))
            for k in sums:
                sums[k] += float(m[k])
    out = {"test_loss": float(np.mean(losses)) if losses else 0.0,
           "tau_rmse": float(np.mean(tau_es)) if tau_es else 0.0,
           "f_rmse": float(np.mean(f_es)) if f_es else 0.0}
    tp, fp, fn, mtp, mfp, mfn = (int(sums[k]) for k in ("tp", "fp", "fn", "mtp", "mfp", "mfn"))
    precision, recall, f1 = _prf(tp, fp, fn)
    m_precision, m_recall, m_f1 = _prf(mtp, mfp, mfn)
    out.update({
        "precision": precision, "recall": recall, "f1_score": f1,
        "matched_precision": m_precision, "matched_recall": m_recall, "matched_f1": m_f1,
        # None (not NaN) when nothing matched, so the JSON stays strict
        "matched_tau_rmse": float(np.sqrt(sums["m_tau_sse"] / mtp)) if mtp else None,
        "matched_f_rmse": float(np.sqrt(sums["m_f_sse"] / mtp)) if mtp else None,
        "match_tol": MATCH_TOL,
    })
    return out


def init_model(model_cls, mcfg: ModelConfig, seed: int, device) -> torch.nn.Module:
    """A fresh model with flax's initializers, drawn from ``seed`` without
    touching torch's global generator, on ``device``; the attention head's
    dropout masks come from a generator on ``device`` seeded with ``seed``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = model_cls(mcfg)
    model = model.to(device)
    attention = getattr(getattr(model, "peak_head", None), "attention", None)
    if attention is not None:
        attention.dropout_generator = torch.Generator(device=device).manual_seed(seed)
    return model


def train_admmnet(mcfg: ModelConfig, tcfg: TrainConfig, train_data, val_data, test_data=None,
                  workdir="runs/admmnet", log_fn: Callable[[str], None] = print,
                  init_from: Optional[str] = None, device="cuda",
                  mesh: Optional[Mesh] = None) -> TrainResult:
    """Train an ``ADMMNet`` end to end.  ``init_from``: warm-start matching
    submodules (e.g. the trunk of a trained PhiEstADMMNet) from another
    run's checkpoint; ignored when ``workdir`` already has a checkpoint to
    resume.  ``mesh``: this rank's ``parallel.data_mesh()`` for data-parallel
    training (see the module docstring); it sets the device, and the
    workdir must be shared by the ranks."""
    return _train_loop(ADMMNet, mcfg, tcfg, train_data, val_data, test_data, workdir, log_fn,
                       "e2e", init_from, device, mesh)


def train_phinet(mcfg: ModelConfig, tcfg: TrainConfig, train_data, val_data, test_data=None,
                 workdir="runs/phinet", log_fn: Callable[[str], None] = print,
                 device="cuda", mesh: Optional[Mesh] = None) -> TrainResult:
    """Train a ``PhiEstADMMNet`` on phi labels (a ``--with-phi`` dataset)."""
    if "phi" not in train_data:
        raise ValueError("phi labels required; generate dataset with with_phi=True")
    return _train_loop(PhiEstADMMNet, mcfg, tcfg, train_data, val_data, test_data, workdir,
                       log_fn, "phi", None, device, mesh)


class _NullMetrics:
    """Metrics sink of the ranks other than 0: writes nothing."""

    def log(self, *a, **k):
        pass

    def write_history(self, h):
        pass

    def write_test_result(self, m):
        pass


def _check_mesh(mesh: Mesh, batch_size: int) -> None:
    if len(mesh.devices) != 1:
        raise ValueError(
            f"a mesh of {len(mesh.devices)} devices in one process: the trainer runs one rank "
            "per device (DistributedDataParallel); launch one process per device "
            "(torchrun --nproc_per_node N, or COORDINATOR/NPROC/PROC_ID) and pass each "
            "rank's data_mesh()")
    if batch_size % mesh.size:
        raise ValueError(f"batch_size {batch_size} does not split into {mesh.size} equal "
                         "shards")


def _train_loop(model_cls, mcfg, tcfg, train_data, val_data, test_data, workdir, log_fn, mode,
                init_from, device, mesh=None) -> TrainResult:
    is_main = True
    group = None
    if mesh is not None:
        _check_mesh(mesh, tcfg.batch_size)
        device, group, is_main = mesh.devices[0], mesh.group, mesh.is_main
    device = torch.device(device)
    workdir = Path(workdir)
    if is_main:
        metrics = MetricsWriter(workdir)
    else:
        metrics = _NullMetrics()

        def log_fn(msg):  # noqa: F811 -- the other ranks stay quiet
            del msg
    n_train = train_data["y"].shape[0]
    steps_per_epoch = max(1, n_train // tcfg.batch_size)
    schedule = sgdr_schedule(tcfg.lr, steps_per_epoch, tcfg.epochs, tcfg.sgdr_t0,
                             tcfg.sgdr_t_mult, tcfg.lr_min)
    model = init_model(model_cls, mcfg, tcfg.seed, device)
    bind_batch_mean(model, mesh)
    optimizer = make_optimizer(model, tcfg)

    def load_params(tree):
        model.load_state_dict({k: v.to(device) for k, v in params_from_jax(tree, mcfg).items()})

    start_epoch, best_val, patience_ct = 0, float("inf"), 0
    history = {"train_loss": [], "val_loss": [], "tau_rmse": [], "f_rmse": [], "lr": []}
    restored = restore_checkpoint(workdir)
    if restored is None and init_from is not None:
        raw = restore_checkpoint(init_from)[0]["params"]
        load_params(_graft_params(params_to_jax(model.state_dict(), mcfg),
                                  raw.get("params", raw), log_fn))
    if restored is not None:
        state, meta = restored
        load_params(state["params"]["params"])
        load_opt_state(optimizer, model, mcfg, state["opt_state"])
        start_epoch = meta["epoch"] + 1
        best_val = meta["best_val_loss"]
        history = meta.get("history", history)
        if tcfg.reset_best:
            best_val = float("inf")
        log_fn(f"resumed from epoch {start_epoch}"
               + (" (best_val reset)" if best_val == float("inf") else ""))

    ddp = None
    if group is not None:
        ddp = torch.nn.parallel.DistributedDataParallel(
            model, device_ids=[device.index] if device.type == "cuda" else None,
            process_group=group, find_unused_parameters=True)
    train_step, eval_step = build_steps(
        model, optimizer, mode, schedule, grad_clip=tcfg.grad_clip,
        assignment=tcfg.assignment, spectral_weight=tcfg.spectral_weight,
        conf_threshold=tcfg.conf_threshold, ddp=ddp, group=group, log_fn=log_fn)

    step = start_epoch * steps_per_epoch
    epochs_run = start_epoch
    for epoch in range(start_epoch, tcfg.epochs):
        epochs_run = epoch + 1
        t_ep = time.time()
        tr_losses = []
        for batch in _batches(train_data, tcfg.batch_size, shuffle=True,
                              seed=tcfg.seed + epoch, mesh=mesh):
            tr_losses.append(train_step(batch_to_device(batch, device), step))
            step += 1
        tr_loss = 0.0
        if tr_losses:
            losses = torch.stack(tr_losses)
            if group is not None:  # each rank's loss is its shard's mean
                dist.all_reduce(losses, group=group)
                losses = losses / dist.get_world_size(group)
            tr_loss = float(losses.double().mean())

        va_losses, tau_es, f_es = [], [], []
        for batch in _batches(val_data, tcfg.batch_size, shuffle=False, seed=0, mesh=mesh):
            total, m = eval_step(batch_to_device(batch, device))
            va_losses.append(float(total))
            if mode == "e2e":
                tau_es.append(float(m["tau_rmse"]))
                f_es.append(float(m["f_rmse"]))
        va_loss = float(np.mean(va_losses)) if va_losses else 0.0

        history["train_loss"].append(tr_loss)
        history["val_loss"].append(va_loss)
        history["tau_rmse"].append(float(np.mean(tau_es)) if tau_es else 0.0)
        history["f_rmse"].append(float(np.mean(f_es)) if f_es else 0.0)
        history["lr"].append(schedule(step))
        metrics.log("epoch", epoch=epoch + 1, train_loss=tr_loss, val_loss=va_loss,
                    tau_rmse=history["tau_rmse"][-1], f_rmse=history["f_rmse"][-1],
                    lr=history["lr"][-1])
        log_fn(f"epoch {epoch + 1}/{tcfg.epochs} {time.time() - t_ep:.1f}s "
               f"train {tr_loss:.6f} val {va_loss:.6f} "
               f"tau_rmse {history['tau_rmse'][-1]:.6f} f_rmse {history['f_rmse'][-1]:.6f}")

        if va_loss < best_val:
            best_val = va_loss
            patience_ct = 0
            if is_main:
                save_checkpoint(
                    workdir,
                    {"params": {"params": params_to_jax(model.state_dict(), mcfg)},
                     "opt_state": opt_state_to_jax(optimizer, model, mcfg)},
                    {"epoch": epoch, "best_val_loss": best_val, "history": history,
                     "mode": mode})
        else:
            patience_ct += 1
        metrics.write_history(history)
        if patience_ct >= tcfg.patience:
            log_fn(f"early stop at epoch {epoch + 1}")
            break

    # reload the best checkpoint for the test metrics; rank 0 wrote it, so
    # the ranks wait for one another before reading it
    barrier(mesh)
    restored = restore_checkpoint(workdir)
    if restored is not None:
        load_params(restored[0]["params"]["params"])

    test_metrics: Dict[str, Any] = {}
    if test_data is not None:
        test_metrics = evaluate_split(eval_step, test_data, tcfg.batch_size, device, mode,
                                      mesh)
        metrics.write_test_result(test_metrics)
        metrics.log("test", **test_metrics)

    return TrainResult(params={k: v.detach().cpu() for k, v in model.state_dict().items()},
                       history=history, best_val_loss=best_val, test_metrics=test_metrics,
                       epochs_run=epochs_run)
