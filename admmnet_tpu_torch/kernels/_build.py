"""Build the CUDA kernels of ``csrc/`` and load them with ctypes.

The sources are compiled by ``nvcc`` for ``sm_90a`` (Hopper), one ``nvcc``
process per ``.cu`` file, all started together, and linked into one shared
library with a plain C interface, named by a hash of the sources, under
``build/kernels/`` at the repository root.  The build runs at the first
kernel launch of a process, never at import, so the package imports on a
machine without CUDA.  Two processes building at once each write their own
temporary files and rename the library into place.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
# C entry points: name -> argtypes (every one returns a cudaError_t as int)
SIGNATURES = {
    # Mr, Mi, Pr, Pi, B, P, m, coeffs, nsteps, hi_steps, bf16_store, stream
    "polar_psd_launch": (_P, _P, _P, _P, _I, _I, _I, _P, _I, _I, _I, _P),
    # yob_r, yob_i, w, A, phi_r, phi_i, B, n, P, num_iters, rho, lam_inv_sq,
    # coeffs, nsteps, hi_steps, outer_iters, inner_iters, final_hi,
    # warm_root, all_hi, three_pass, fold_diag, lists, ablate, stream
    "fused_admm_fast_launch": (
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P, _I, _I, _I,
        _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ),
    # yob_r, yob_i, w, A, phi_r, phi_i, zscratch (Z's two planes), B, n, P,
    # num_iters, rho, lam_inv_sq, coeffs, nsteps, outer_iters, inner_iters,
    # stream
    "fused_admm_launch": (
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P, _I, _I, _I, _P,
    ),
    # Mr, Mi, coeffs, Gr, Gi, b1r, b1i, b2r, b2i (carries: all null, or all
    # written), B, P, m, degree, final_hi, stream
    "cheb_filter_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # Mr, Mi, coeffs, Yr, Yi, b1r, b1i, b2r, b2i, ABr, ABi, cbar, B, P, m,
    # degree, three_pass, stream
    "cheb_bwd_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                        _P),
    # phi, S, DcT, taus, fs, rel, tau, f, height, valid, B, Nb, Nd, ny, nx, K, P,
    # smem, iters, one_pass, tau_lo, tau_hi, f_lo, f_hi, half_t, half_f, reduce, stream
    "peak_search_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                           _I, _I, _I, _F, _F, _F, _F, _D, _D, _D, _P),
    # M, w, V, sweeps, B, m, max_sweeps, smem, stream
    "eigh_jacobi_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
}

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of this process's build, None if cached
build_logs = {}  # source name -> nvcc's report (registers, shared memory, spills)
compile_seconds = {}  # source name -> wall time of its nvcc


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libadmmnet_kernels_{h.hexdigest()[:16]}.so"


def _run(cmd, what):
    """(output, wall seconds) of a command that must succeed."""
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{what} failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    return proc.stdout + proc.stderr, time.time() - t0


def build() -> Path:
    """Compile the sources unless the library for their hash exists."""
    global build_seconds, build_logs, compile_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    sources = sorted(CSRC.glob("*.cu"))
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    t0 = time.time()
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        futures = {
            src.name: pool.submit(_run, [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                                  f"nvcc {src.name}")
            for src, obj in zip(sources, objs)
        }
        results = {name: fut.result() for name, fut in futures.items()}
    tmp = out.with_name(f"{tag}.tmp")
    _run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)], "nvcc link")
    build_seconds = time.time() - t0
    build_logs = {name: log for name, (log, _) in results.items()}
    compile_seconds = {name: secs for name, (_, secs) in results.items()}
    os.replace(tmp, out)
    for obj in objs:
        obj.unlink()
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
