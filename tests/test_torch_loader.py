"""Port parity: the native minibatch loader (data/loader.py) vs the JAX
package's, and the trainer's choice between it and the numpy iterator.

Both packages compile their own copy of the same C++ source; the shuffle
(SplitMix64-seeded Fisher-Yates) and the gathers must agree bit for bit.
"""

import numpy as np
import pytest

import admmnet_tpu.data.loader as jloader
import admmnet_tpu_torch.data.loader as tloader
from admmnet_tpu_torch.train import trainer


@pytest.fixture(scope="module", autouse=True)
def both_built():
    if not jloader.ensure_built():
        pytest.skip("the JAX package's native loader does not build here")
    assert tloader.ensure_built(), "the port's native loader did not build"


def _data(n):
    rng = np.random.default_rng(1)
    return {
        "y": (rng.normal(size=(n, 16)) + 1j * rng.normal(size=(n, 16))).astype(np.complex64),
        "tau": rng.normal(size=(n, 3)),
        "sigma": rng.normal(size=n).astype(np.float32),
        "L_true": rng.integers(0, 3, n).astype(np.int32),
    }


def test_library_builds_under_the_build_directory():
    path = tloader.library_path()
    assert path.exists() and path.parent == tloader.BUILD_DIR


@pytest.mark.parametrize("n, seed", [(1, 0), (20, 3), (1000, 7), (7001, 2**40 + 5)])
def test_shuffle_equals_jax(n, seed):
    got = tloader.shuffle_indices(n, seed)
    np.testing.assert_array_equal(got, jloader.shuffle_indices(n, seed))
    np.testing.assert_array_equal(np.sort(got), np.arange(n))


def test_gather_rows_equals_numpy_and_jax():
    rng = np.random.default_rng(0)
    src = rng.normal(size=(1000, 37)).astype(np.float32)
    idx = rng.integers(0, 1000, 300).astype(np.int64)
    got = tloader.gather_rows(src, idx)
    np.testing.assert_array_equal(got, src[idx])
    np.testing.assert_array_equal(got, jloader.gather_rows(src, idx))


@pytest.mark.parametrize("shuffle, batch", [(True, 64), (False, 64), (True, 300), (True, 512)])
def test_prefetch_loader_batches_equal_jax(shuffle, batch):
    """Every batch equal to the JAX package's, with a short last batch (64),
    one batch of every row (300) and a batch larger than the data (512)."""
    data = _data(300)
    got = list(tloader.PrefetchLoader(data, batch, shuffle=shuffle, seed=3))
    ref = list(jloader.PrefetchLoader(data, batch, shuffle=shuffle, seed=3))
    assert len(got) == len(ref) == -(-300 // batch)
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for k in r:
            assert g[k].dtype == r[k].dtype and g[k].shape == r[k].shape
            np.testing.assert_array_equal(g[k], r[k])
    rows = np.concatenate([b["sigma"] for b in got])
    np.testing.assert_array_equal(np.sort(rows), np.sort(data["sigma"]))


def test_trainer_draws_the_native_order():
    """The JAX trainer's first shuffled batch of 20 rows, batch 5, seed 3,
    through its native loader is rows [10, 11, 18, 8, 16]; the port's
    trainer draws the same."""
    data = {"y": np.arange(20, dtype=np.float32)[:, None]}
    first = next(iter(trainer._batches(data, 5, shuffle=True, seed=3)))
    np.testing.assert_array_equal(first["y"][:, 0], [10, 11, 18, 8, 16])


def test_trainer_takes_numpy_order_without_the_native_loader(monkeypatch):
    monkeypatch.setattr("admmnet_tpu_torch.data.loader.native_available", lambda: False)
    data = {"y": np.arange(20, dtype=np.float32)[:, None]}
    first = next(iter(trainer._batches(data, 5, shuffle=True, seed=3)))
    np.testing.assert_array_equal(first["y"][:, 0], [16, 12, 18, 8, 3])
