"""The peak-search kernel's CPU side (``kernels/peak_search.py``): its
argument checks, the constants it reads, and its tie rules.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``
holds it to the plain version there).  Here ``_kernel_rules`` emulates its
decisions in numpy (the local maxima, the top K with equal heights in flat
index order, the first maximum of each refine window, the stable rank
sort) over the plain version's own arithmetic, so that on inputs with
exact ties the emulation and the plain version must agree bit for bit.
"""

import numpy as np
import pytest
import torch

from admmnet_tpu_torch.core.config import PRODUCTION_PEAKS, PeakSearchConfig
from admmnet_tpu_torch.kernels import _build
from admmnet_tpu_torch.kernels import peak_search as kps
from admmnet_tpu_torch.ops.atoms import delay_steering, doppler_steering
from admmnet_tpu_torch.peaks import find_peaks
from admmnet_tpu_torch.peaks.search import (
    _coarse_axes,
    find_peaks_plain,
    search_constants,
)
from admmnet_tpu_torch.peaks.spectrum import spectrum_grid

CPU = torch.device("cpu")
# every configuration the package runs the search with: the default, the
# deploy point, and cli/eval_net.py's
PACKAGE_CONFIGS = [PeakSearchConfig(), PRODUCTION_PEAKS, PeakSearchConfig(max_peaks=8)]


@pytest.fixture
def no_cuda(monkeypatch):
    """Fail the test if the kernel library is loaded (a CUDA call)."""
    def refuse():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(_build, "lib", refuse)


def _phi(B, n=100, seed=0, dtype=torch.complex64):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(B, n, dtype=dtype, generator=g)


@pytest.mark.parametrize("case, kind, match", [
    ("dtype", TypeError, "complex64"),
    ("shape", ValueError, "shape"),
    ("max_peaks", ValueError, "max_peaks 33"),
    ("refine_points", ValueError, "refine_points 33"),
    ("grid", ValueError, "shared memory"),
    ("device", ValueError, "unsupported device"),
])
def test_checks_raise_before_any_cuda_call(no_cuda, case, kind, match):
    cfg = {"max_peaks": PeakSearchConfig(max_peaks=33),
           "refine_points": PeakSearchConfig(refine_points=33),
           "grid": PeakSearchConfig(delay_step=0.001)}.get(case, PRODUCTION_PEAKS)
    phi = {"dtype": _phi(2, dtype=torch.complex128), "shape": _phi(2, 99)}.get(case, _phi(2))
    with pytest.raises(kind, match=match):
        kps.peak_search(phi, 10, 10, cfg, search_constants(cfg, 10, 10, CPU))


@pytest.mark.parametrize("cfg", PACKAGE_CONFIGS, ids=["default", "production", "eval_net"])
def test_every_package_config_fits(no_cuda, cfg):
    """The package's configurations pass every check but the device: the
    grid's block fits the card's shared memory, and only the launch's
    device guard refuses a CPU phi."""
    taus, fs = _coarse_axes(cfg)
    need = kps.smem_bytes(10, 10, fs.size, taus.size, cfg.max_peaks, cfg.refine_points)
    assert need <= kps.SMEM_LIMIT
    assert kps.check_search(_phi(1), 10, 10, cfg, fs.size, taus.size) == need
    with pytest.raises(ValueError, match="unsupported device"):
        kps.peak_search(_phi(1), 10, 10, cfg, search_constants(cfg, 10, 10, CPU))


def test_shared_memory_of_the_production_block():
    """58,272 bytes at the deploy point: three blocks an SM."""
    assert kps.smem_bytes(10, 10, 100, 100, 8, 11) == 58272
    assert 3 * 58272 <= 228 * 1024


@pytest.mark.parametrize("cfg", PACKAGE_CONFIGS[:2], ids=["default", "production"])
def test_search_constants_are_the_plain_versions(cfg):
    """The cached axes and steering equal _coarse_axes' and ops/atoms.py's
    bit for bit; they are built once per (cfg, Nb, Nd, device)."""
    c = search_constants(cfg, 10, 10, CPU)
    assert search_constants(cfg, 10, 10, CPU) is c
    taus, fs = _coarse_axes(cfg)
    assert torch.equal(c.taus, torch.from_numpy(taus))
    assert torch.equal(c.fs, torch.from_numpy(fs))
    assert torch.equal(c.S, doppler_steering(torch.from_numpy(fs), 10))
    Dc = torch.conj(delay_steering(torch.from_numpy(taus), 10))
    assert torch.equal(c.DcT, Dc.T) and not c.DcT.is_conj() and c.DcT.is_contiguous()
    assert torch.equal(c.rel, torch.linspace(-1.0, 1.0, cfg.refine_points))
    assert c.S.dtype == c.DcT.dtype == torch.complex64


def test_cpu_phi_takes_the_plain_version(no_cuda):
    phi = _phi(3).reshape(3, 1, 100)
    before = kps.launches.count
    out = find_peaks(phi, 10, 10, PRODUCTION_PEAKS)
    assert kps.launches.count == before
    for x, y in zip(out, find_peaks_plain(phi.reshape(3, 100), 10, 10, PRODUCTION_PEAKS)):
        assert torch.equal(x, y.reshape(3, 1, -1))


# ---- the kernel's tie rules ------------------------------------------------------


def _first_max(flat: np.ndarray) -> np.ndarray:
    """Index of the first maximum along the last axis (the kernel's scan
    keeps the earlier index on equal values)."""
    out = np.empty(flat.shape[:-1], dtype=np.int64)
    for ix in np.ndindex(*flat.shape[:-1]):
        row = flat[ix]
        out[ix] = np.flatnonzero(row == row.max())[0]
    return out


def _rank_order(h: np.ndarray) -> np.ndarray:
    """The kernel's sort: entry i goes to rank #{j: h_j > h_i} + #{j < i:
    h_j == h_i}; returns the entries in rank order."""
    K = h.shape[-1]
    order = np.empty_like(h, dtype=np.int64)
    for b in range(h.shape[0]):
        for i in range(K):
            rank = np.sum(h[b] > h[b, i]) + np.sum(h[b, :i] == h[b, i])
            order[b, rank] = i
    return order


def _top_k(z: np.ndarray, K: int) -> np.ndarray:
    """Flat indices of the K largest candidates of one scene's grid z:
    8-neighbour local maxima (-inf past the borders), equal heights in
    flat index order."""
    ny, nx = z.shape
    padded = np.pad(z, 1, constant_values=-np.inf)
    nbr = np.max([padded[1 + dy:1 + dy + ny, 1 + dx:1 + dx + nx]
                  for dy in (-1, 0, 1) for dx in (-1, 0, 1) if dy or dx], axis=0)
    cand = np.flatnonzero((z >= nbr).ravel())
    return cand[np.lexsort((cand, -z.ravel()[cand]))][:K]


def _kernel_rules(phi: torch.Tensor, Nb: int, Nd: int, cfg):
    """(tau, f, height, valid) of the kernel's control flow in numpy over
    the plain version's float32 arithmetic on the CPU."""
    taus_np, fs_np = _coarse_axes(cfg)
    nx = taus_np.size
    B, K, P = phi.shape[0], cfg.max_peaks, cfg.refine_points
    Z = spectrum_grid(phi, torch.from_numpy(taus_np), torch.from_numpy(fs_np), Nb, Nd).numpy()
    tau0 = np.full((B, K), cfg.delay_min, np.float32)
    f0 = np.full((B, K), cfg.doppler_min, np.float32)
    valid = np.zeros((B, K), bool)
    for b in range(B):
        for j, i in enumerate(_top_k(Z[b], K)):
            valid[b, j] = np.isfinite(Z[b].ravel()[i])
            if valid[b, j]:
                tau0[b, j], f0[b, j] = taus_np[i % nx], fs_np[i // nx]
    Phi = torch.conj(phi).reshape(B, 1, Nb, Nd)
    rel = torch.linspace(-1.0, 1.0, P, dtype=torch.float32)
    tau, f = torch.from_numpy(tau0), torch.from_numpy(f0)
    half_t, half_f = cfg.delay_step, cfg.doppler_step
    for _ in range(cfg.refine_iters):
        taus = torch.clamp(tau[..., None] + half_t * rel, cfg.delay_min, cfg.delay_max - 1e-6)
        fs = torch.clamp(f[..., None] + half_f * rel, cfg.doppler_min, cfg.doppler_max - 1e-6)
        SPhi = doppler_steering(fs, Nb) @ Phi
        Zl = torch.abs(SPhi @ torch.conj(delay_steering(taus, Nd)).transpose(-1, -2)) ** 2
        flat = Zl.reshape(B, K, P * P).numpy()
        idx = _first_max(flat)
        height = np.take_along_axis(flat, idx[..., None], -1)[..., 0]
        f = torch.from_numpy(np.take_along_axis(fs.numpy(), (idx // P)[..., None], -1)[..., 0])
        tau = torch.from_numpy(np.take_along_axis(taus.numpy(), (idx % P)[..., None], -1)[..., 0])
        half_t *= cfg.reduce_factor
        half_f *= cfg.reduce_factor
    h = np.where(valid, height, -np.inf).astype(np.float32)
    order = _rank_order(h)
    return tuple(np.take_along_axis(x, order, -1) for x in (tau.numpy(), f.numpy(), h, valid))


def _by_entry(out):
    """Each scene's entries as a sorted list of (-height, f, tau, valid)."""
    tau, f, h, valid = (np.asarray(x) for x in out)
    return [sorted(zip(-h[b], f[b], tau[b], valid[b])) for b in range(h.shape[0])]


# Nb = 1: the doppler steering is exactly 1, so every grid row, and every
# row of every refine window, is the same, bit for bit; the 10 x 4 grid
# holds at most 5 local-maximum columns (20 candidates <= K), so the top K
# takes every candidate and the rest pads
FLAT_DOPPLER = PeakSearchConfig(delay_step=0.1, doppler_step=0.25, max_peaks=20,
                                refine_iters=2)


def test_flat_doppler_input_has_exact_ties():
    phi = _phi(16, 4, seed=3)
    taus, fs = _coarse_axes(FLAT_DOPPLER)
    Z = spectrum_grid(phi, torch.from_numpy(taus), torch.from_numpy(fs), 1, 4)
    assert Z.shape == (16, 4, 10) and bool((Z == Z[:, :1]).all())
    out = find_peaks_plain(phi, 1, 4, FLAT_DOPPLER)
    assert bool((~out[3]).any(-1).all())  # every scene pads
    h = out[2]
    assert bool((h[:, 1:] == h[:, :-1])[:, :3].any())  # equal refined heights


@pytest.mark.parametrize("case", ["flat_doppler", "random", "random_production"])
def test_kernel_tie_rules_match_plain(case):
    """The emulated kernel against the plain version, bit for bit.  On the
    flat-doppler input (exact ties in the grid, in every refine window and
    among the refined heights, and padding) each scene's entries are
    compared as a set: the plain version's top-K order among equal heights
    is torch.topk's, which torch leaves unspecified, and the stable sort
    keeps it; the first maximum of each window shows in f, which the tie
    across the window's rows leaves at the window's first row.  Without
    ties the lists agree entry by entry."""
    if case == "flat_doppler":
        phi, Nb, Nd, cfg = _phi(16, 4, seed=3), 1, 4, FLAT_DOPPLER
    else:
        cfg = PRODUCTION_PEAKS if case == "random_production" else PeakSearchConfig()
        phi, Nb, Nd = _phi(8, seed=4), 10, 10
    emulated = _kernel_rules(phi, Nb, Nd, cfg)
    plain = [x.numpy() for x in find_peaks_plain(phi, Nb, Nd, cfg)]
    if case == "flat_doppler":
        assert _by_entry(emulated) == _by_entry(plain)
        # each round keeps its window's first row: f0 - half_f, clamped
        f = torch.from_numpy(_coarse_axes(cfg)[1])
        for half in (cfg.doppler_step, cfg.doppler_step * cfg.reduce_factor):
            f = torch.clamp(f + half * torch.linspace(-1.0, 1.0, cfg.refine_points)[0],
                            cfg.doppler_min, cfg.doppler_max - 1e-6)
        assert np.isin(emulated[1], f.numpy()).all()
    else:
        for e, p in zip(emulated, plain):
            np.testing.assert_array_equal(e, p)


@pytest.mark.parametrize("seed", [0, 1])
def test_first_max_is_torch_argmax_on_ties(seed):
    flat = np.random.default_rng(seed).integers(0, 3, size=(6, 4, 121)).astype(np.float32)
    np.testing.assert_array_equal(_first_max(flat),
                                  torch.argmax(torch.from_numpy(flat), dim=-1).numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_rank_order_is_the_stable_argsort_on_ties(seed):
    h = np.random.default_rng(seed).integers(0, 3, size=(6, 16)).astype(np.float32)
    h[h == 0] = -np.inf  # padded entries: equal at -inf
    np.testing.assert_array_equal(
        _rank_order(h), torch.argsort(-torch.from_numpy(h), dim=-1, stable=True).numpy())


def test_top_k_takes_the_values_of_topk():
    """The kernel's top K holds torch.topk's heights; on equal heights it
    takes the earlier points, one of the sets torch.topk may take."""
    z = np.random.default_rng(2).integers(0, 4, size=(12, 9)).astype(np.float32)
    scores = torch.where(torch.from_numpy(z) >= torch.nn.functional.max_pool2d(
        torch.from_numpy(z)[None, None], 3, 1, 1)[0, 0], torch.from_numpy(z), -torch.inf)
    vals = torch.topk(scores.reshape(-1), 6).values.numpy()
    idx = _top_k(z, 6)
    np.testing.assert_array_equal(z.ravel()[idx], vals)
    assert np.all(np.diff(idx[z.ravel()[idx] == z.ravel()[idx][0]]) > 0)
