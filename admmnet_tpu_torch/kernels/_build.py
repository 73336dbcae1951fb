"""Build the CUDA kernels of ``csrc/`` and load them with ctypes.

The sources are compiled by ``nvcc`` for ``sm_90a`` (Hopper), one ``nvcc``
process per ``.cu`` file, all started together, and linked into one shared
library with a plain C interface, named by a hash of the sources, under
``build/kernels/`` at the repository root.  The build runs at the first
kernel launch of a process, never at import, so the package imports on a
machine without CUDA.  Two processes building at once each write their own
temporary files and rename the library into place.

``launch`` is the one way the kernels' wrappers call an entry point: by the
argument names ``SIGNATURES`` states, after ``require_card``.
"""

from __future__ import annotations

import ctypes
import hashlib
import operator
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

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


def _args(spec: str, ctype):
    return tuple((name, ctype) for name in spec.split())


# C entry points: name -> (argument name, ctype) in the C order.  Every one
# ends with the stream (left out here) and returns a cudaError_t as int, or
# -1 where the caller's count of a block's shared memory is not the C
# layout's.  A pointer argument takes a tensor, a host address or None.
SIGNATURES = {
    "polar_psd_launch": (
        _args("Mr Mi Pr Pi", _P) + _args("B P m", _I) + _args("coeffs", _P)
        + _args("nsteps hi_steps bf16_store", _I)),
    "fused_admm_fast_launch": (
        _args("yob_r yob_i w A phi_r phi_i", _P) + _args("B n P num_iters", _I)
        + _args("rho lam_inv_sq", _F) + _args("coeffs", _P)
        + _args("nsteps hi_steps outer_iters inner_iters final_hi warm_root all_hi three_pass "
                "fold_diag lists ablate", _I)),
    "fused_admm_launch": (
        _args("yob_r yob_i w A phi_r phi_i zscratch", _P) + _args("B n P num_iters", _I)
        + _args("rho lam_inv_sq", _F) + _args("coeffs", _P)
        + _args("nsteps outer_iters inner_iters", _I)),
    # the carries b1r .. b2i: all None, or all written
    "cheb_filter_launch": (
        _args("Mr Mi coeffs Gr Gi b1r b1i b2r b2i", _P) + _args("B P m degree final_hi", _I)),
    "cheb_bwd_launch": (
        _args("Mr Mi coeffs Yr Yi b1r b1i b2r b2i ABr ABi cbar", _P)
        + _args("B P m degree three_pass", _I)),
    "peak_search_launch": (
        _args("phi S DcT taus fs rel tau f height valid", _P)
        + _args("B Nb Nd ny nx K P smem iters one_pass", _I)
        + _args("tau_lo tau_hi f_lo f_hi", _F) + _args("half_t half_f reduce", _D)),
    "eigh_jacobi_launch": _args("M w V sweeps", _P) + _args("B m max_sweeps smem", _I),
}
ARGS = {entry: tuple(name for name, _ in sig) for entry, sig in SIGNATURES.items()}
_ORDER = {entry: operator.itemgetter(*names) for entry, names in ARGS.items()}
_POINTERS = {entry: tuple(i for i, (_, ctype) in enumerate(sig) if ctype is _P)
             for entry, sig in SIGNATURES.items()}

_lock = threading.Lock()
_lib = None
_fns = {}  # entry -> its bound C function, once the library is loaded
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
            for name, sig in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = [ctype for _, ctype in sig] + [_P]
                fn.restype = ctypes.c_int
                _fns[name] = fn
            _lib = handle
    return _lib


def require_card(*tensors) -> int:
    """Return the index of the one CUDA device that every tensor is on;
    raise unless each is a contiguous tensor of it."""
    index = tensors[0].get_device()
    for t in tensors:
        if not (t.is_cuda and t.get_device() == index and t.is_contiguous()):
            raise ValueError(f"unsupported device or layout: the kernels take contiguous tensors "
                             f"of one CUDA device, got {t.device}"
                             f"{'' if t.is_contiguous() else ', not contiguous'} among "
                             f"{', '.join(str(x.device) for x in tensors)}")
    return index


def launch(entry: str, counter, **args) -> None:
    """Launch the C entry point ``entry`` with the arguments of
    ``SIGNATURES[entry]`` by name (a pointer takes a tensor, which passes
    its ``data_ptr()``, a host address or None) on the current stream of
    the device that ``require_card`` finds the tensors on; raise on a CUDA
    error and add one to ``counter.count``.  A missing or unknown name
    raises TypeError before the library loads."""
    try:
        values = list(_ORDER[entry](args))
    except KeyError:
        values = None
    if values is None or len(values) != len(args):
        names = set(ARGS[entry])
        raise TypeError(f"{entry}: missing arguments {sorted(names - args.keys())}, "
                        f"unknown arguments {sorted(args.keys() - names)}")
    tensors = []
    for i in _POINTERS[entry]:  # a tensor is whatever is neither None nor an address
        v = values[i]
        if v is not None and type(v) is not int:
            tensors.append(v)
            values[i] = v.data_ptr()
    index = require_card(*tensors)
    if _lib is None:
        lib()
    # the raw stream handle and the current device are each a C call, where
    # torch.cuda.current_stream(...).cuda_stream and torch.cuda.device(...)
    # cost ~4 and ~2 us a launch on the host.  _cuda_getCurrentRawStream is
    # private to torch: if an upgrade drops it, every launch raises here.
    stream = torch._C._cuda_getCurrentRawStream(index)
    if torch.cuda.current_device() == index:
        err = _fns[entry](*values, stream)
    else:
        with torch.cuda.device(index):
            err = _fns[entry](*values, stream)
    if err == -1:
        raise RuntimeError(f"{entry}: the caller's shared memory count is not the C layout's")
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err}")
    counter.count += 1
