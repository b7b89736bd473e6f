"""Build and load the hand-written CUDA kernels under ``csrc/``.

All ``csrc/*.cu`` files are compiled by nvcc (one process per source, in
parallel) and linked into one shared library with a plain C interface
(no PyTorch headers, so a build takes seconds),
targeting Hopper (``sm_90a``), and loaded with ctypes. The library is
built at first use into ``f2nerf_torch/_build/`` under a name keyed by a
hash of the sources and flags, so an edited kernel is rebuilt and a
current one is reused.

Each C entry point returns ``cudaGetLastError()`` after its launch;
``check`` turns a non-zero code into an exception. Pointers and the
stream go in as ``c_void_p`` (a bare Python int would be cut to 32 bits).

Nothing here runs at import: importing the package must work on a host
with no nvcc and no GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# no --use_fast_math: K2/K3's, K5/K6's, K7-K9's, K12's and K15's arithmetic
# must round exactly like the plain versions (see csrc/hash_block.cu,
# hash3d.cu, ray_march.cu, traverse.cu, march_parallel.cu, warp.cu,
# rays.cu), and K3, K6 and K10/K11 add in a fixed order
# (csrc/hash_block.cu, hash3d.cu, segment.cu)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_vp, _i, _ll, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "f2_fused_adam": [_vp, _vp, _vp, _vp, _ll, _vp, _vp,
                      _f, _f, _f, _f, _f, _f, _vp],
    "f2_hash_block_fwd": [_vp, _vp, _vp, _vp, _vp, _vp, _vp,
                          _i, _i, _i, _vp],
    "f2_hash_block_bwd": [_vp, _vp, _vp, _i, _vp, _vp, _vp, _i,
                          _vp, _vp, _vp, _vp, _vp, _i, _i, _vp],
    "f2_hash_block_bwd_scratch_bytes": [_ll, _i],
    "f2_row_gather": [_vp, _vp, _i, _vp, _ll, _i, _vp],
    "f2_hash3d_fwd": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _ll, _i, _i, _vp],
    "f2_hash3d_bwd": [_vp] * 8 + [_ll, _i, _i, _vp],
    "f2_hash3d_bwd_scratch_bytes": [_ll],
    "f2_ray_march_lockstep": [_vp] * 16 + [_i, _i, _i, _i, _f, _i, _vp],
    "f2_traverse": [_vp] * 13 + [_i, _i, _i, _i, _vp],
    "f2_ray_march_parallel": [_vp] * 18 + [_i, _i, _i, _f, _i, _i, _i, _vp],
    "f2_ray_offsets": [_vp] * 5 + [_ll, _i, _i, _vp],
    "f2_segment_reduce": [_vp, _ll, _ll, _vp, _vp, _i, _i, _vp],
    "f2_segment_scan": [_vp] * 4 + [_ll, _i, _i, _vp],
    "f2_compact_a_warp": [_vp] * 18 + [_ll, _i, _i, _i, _vp],
    "f2_sample_edges": [_vp] * 10 + [_i, _i, _i, _vp],
    "f2_compact_keep": [_vp] * 22 + [_ll, _ll, _i, _vp],
    "f2_compact_keep_state_bytes": [_ll],
    "f2_occupancy_votes": [_vp] * 8 + [_ll, _i, _i, _vp],
    "f2_occupancy_fold": [_vp] * 12 + [_i, _vp],
    "f2_rays": [_vp] * 3 + [_i] + [_vp] * 11 + [_ll] * 5 + [_i, _i, _vp],
}

# entry points that return something other than a cudaError_t
_RESTYPES = {"f2_compact_keep_state_bytes": ctypes.c_longlong,
             "f2_hash_block_bwd_scratch_bytes": ctypes.c_longlong,
             "f2_hash3d_bwd_scratch_bytes": ctypes.c_longlong}


class _State:
    lib: ctypes.CDLL | None = None
    build_seconds: float | None = None
    ptxas_log: str = ""


_state = _State()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA "
                       "kernels cannot be built on this host")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libf2kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands at once; raise on the first failure; return their
    stderr (ptxas's report) joined."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    outs = [p.communicate() for p in procs]
    for c, p, (out, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{' '.join(c)}"
                               f"\n{out}\n{err}")
    return "".join(err for _, err in outs)


def build() -> Path:
    """Compile the kernels if no current build exists; return the path.
    One nvcc per source, all started together, then one link."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    t0 = time.perf_counter()
    ptxas = _run_all([[_nvcc(), *flags, "-c", "-o", str(o), str(src)]
                      for src, o in zip(sources(), objs)])
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    _run_all([[_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, objs)]])
    for o in objs:
        o.unlink()
    os.replace(tmp, so)
    _state.build_seconds = time.perf_counter() - t0
    _state.ptxas_log = ptxas
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call, under the span
    ``setup.kernels``)."""
    if _state.lib is None:
        from .utils.spans import span
        with span("setup.kernels"):
            lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _RESTYPES.get(name, ctypes.c_int)
        _state.lib = lib
    return _state.lib


def build_info() -> dict:
    """Seconds the last build in this process took (None if the library
    was already built) and ptxas's register/shared-memory report."""
    return dict(seconds=_state.build_seconds, ptxas=_state.ptxas_log)


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA launch of {name} failed: cudaError {code}")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(name: str, *tensors) -> None:
    """The kernels take contiguous CUDA tensors on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: every tensor must be contiguous and on "
                             f"{dev}; got {t.device}, contiguous="
                             f"{t.is_contiguous()}")
