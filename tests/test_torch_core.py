"""Port parity: configuration, its conversion from JAX, and the anchor data.

The port's configuration is a copy of the JAX package's (same fields,
defaults and guards), and its anchor module is numpy-only, so everything
here is compared for exact equality.
"""

import dataclasses

import numpy as np
import pytest
import torch

import admmnet_tpu.core.config as jcfg
import admmnet_tpu.data.anchor as janchor
import admmnet_tpu.ops.projections as jproj
import admmnet_tpu_torch.core.config as tcfg
import admmnet_tpu_torch.data.anchor as tanchor
import admmnet_tpu_torch.ops.projections as tproj
from admmnet_tpu_torch.core.convert import options_from_jax

torch.set_num_threads(1)  # JAX and torch share the cores of one test worker

CLASSES = ("ProblemSpec", "ADMMOptions", "PeakSearchConfig")


@pytest.mark.parametrize("name", CLASSES)
def test_config_defaults_equal_field_by_field(name):
    j, t = getattr(jcfg, name)(), getattr(tcfg, name)()
    assert [f.name for f in dataclasses.fields(j)] == [f.name for f in dataclasses.fields(t)]
    assert dataclasses.asdict(j) == dataclasses.asdict(t)


@pytest.mark.parametrize("name, bad", [
    ("ADMMOptions", {"phi_update": "dense"}),
    ("ADMMOptions", {"g_update": "svd"}),
    ("ADMMOptions", {"fused_exact_schedule": "quintic6"}),
    ("ADMMOptions", {"fused_schedule": "sched1"}),
    ("ADMMOptions", {"fused_layout": "stacked"}),
    ("PeakSearchConfig", {"refine_precision": "high"}),
    ("PeakSearchConfig", {"refine_points": 5}),
])
def test_config_guards_match(name, bad):
    for mod in (jcfg, tcfg):
        with pytest.raises(ValueError):
            getattr(mod, name)(**bad)


JAX_OPTIONS = [
    jcfg.ProblemSpec(Nb=8, Nd=12, L_max=4),
    jcfg.ADMMOptions(rho=1.7, g_update="fused_exact", fused_exact_schedule="quintic5",
                     fused_proj_iters=3, fused_warm_root=False, polar_fast_hi_steps=1),
    jcfg.PeakSearchConfig(max_peaks=5, refine_iters=2, refine_precision="default",
                          delay_step=0.02),
    jcfg.PRODUCTION_PEAKS,
]


@pytest.mark.parametrize("obj", JAX_OPTIONS, ids=lambda o: type(o).__name__)
def test_options_from_jax_round_trips(obj):
    cls = getattr(tcfg, type(obj).__name__)
    want = dataclasses.asdict(obj)
    for form in (obj, dataclasses.asdict(obj), jcfg.to_json(obj)):
        got = options_from_jax(form)
        assert type(got) is cls and dataclasses.asdict(got) == want
    # and back: the port's JSON is the JAX package's JSON
    back = jcfg.from_json(type(obj), tcfg.to_json(options_from_jax(obj)))
    assert back == obj


def test_options_from_jax_rejects_unknown_fields():
    d = dataclasses.asdict(jcfg.ADMMOptions())
    d["new_knob"] = 1
    with pytest.raises(ValueError, match="new_knob"):
        options_from_jax(d)
    from admmnet_tpu.parallel.distributed import DistributedInfo  # not ported yet

    with pytest.raises(ValueError, match="no port counterpart"):
        options_from_jax(DistributedInfo(0, 1, 1, 1))


def test_schedules_and_deployment_constants_equal():
    for name in ("POLAR_QUINTIC_SCHEDULE", "POLAR_QUINTIC5_SCHEDULE",
                 "POLAR_BF16_SCHEDULE", "POLAR_BF16_POLISH", "POLAR_BF16_SCHED3",
                 "POLAR_BF16_SCHED2"):
        assert getattr(tproj, name) == getattr(jproj, name), name
    assert tcfg.DETECTION_BUDGET_ITERS == jcfg.DETECTION_BUDGET_ITERS
    assert dataclasses.asdict(tcfg.PRODUCTION_PEAKS) == dataclasses.asdict(jcfg.PRODUCTION_PEAKS)


@pytest.mark.parametrize("mode, seed", [("redemod", 0), ("redemod", 7), ("fixed_e", 3)])
def test_make_anchor_batch_bitwise(mode, seed):
    j = janchor.make_anchor_batch(6, mode, seed=seed)
    t = tanchor.make_anchor_batch(6, mode, seed=seed)
    for a, b in zip(j, t):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("mode", ["fixed_e", "redemod", "fresh"])
def test_load_anchor_bitwise(mode):
    j = janchor.load_anchor(mode, rng=np.random.default_rng(4))
    t = tanchor.load_anchor(mode, rng=np.random.default_rng(4))
    for f in dataclasses.fields(j):
        a, b = getattr(j, f.name), getattr(t, f.name)
        assert np.array_equal(a, b), f.name
