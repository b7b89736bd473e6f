"""The port's native (C++) octree engine, loaded with ctypes.

``octree_ops.cpp`` is a copy of the JAX package's engine with the same C
ABI (``f2_proc_octree``, ``f2_edge_pool``, ``f2_sample_pixels``). It is
compiled at first use by the system C++ compiler (g++, else c++) into
``f2nerf_torch/_build/``, under a name keyed by a hash of the source and
the flags, so an edited source is rebuilt and a current build is reused.
The compiler writes a temporary file that is then renamed into place, so
processes that build at once do not read a half-written library.

A failed build raises with the compiler's message: the training path has
no numpy fallback (the numpy versions in ``sampler/octree.py`` are the
plain versions the tests hold this engine against).

Bound here: ``proc_octree`` (ProcOctree, PersSampler.cpp:120-330),
``edge_pool`` (ConstructEdgePool, PersSampler.cpp:614-659) and
``sample_pixels`` (the ``data_at_gpu=false`` host loader's multithreaded
gt-pixel gather).

Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "octree_ops.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]


class _State:
    lib: ctypes.CDLL | None = None


_state = _State()


def _compiler() -> str:
    for cc in ("g++", "c++"):
        found = shutil.which(cc)
        if found:
            return found
    raise RuntimeError("no C++ compiler (g++ or c++) on PATH: the native "
                       "octree engine (f2nerf_torch/native) cannot be built")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libf2octree_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the engine if no current build exists; return its path."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_compiler(), *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native octree engine failed "
                           f"({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    """The loaded engine (built on first call, under the span
    ``setup.kernels``)."""
    if _state.lib is None:
        from ..utils.spans import span
        with span("setup.kernels"):
            lib = ctypes.CDLL(str(build()))
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.f2_proc_octree.restype = ctypes.c_int
        lib.f2_proc_octree.argtypes = [
            ctypes.c_int, f32p, f32p, i32p, i32p, u8p, i32p, i32p, i32p, i32p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            f32p, f32p, i32p, i32p, u8p, i32p, i32p, i32p]
        lib.f2_edge_pool.restype = ctypes.c_long
        lib.f2_edge_pool.argtypes = [
            ctypes.c_int, f32p, f32p, i32p, ctypes.c_long, i32p, f32p, f32p, f32p]
        lib.f2_sample_pixels.restype = None
        lib.f2_sample_pixels.argtypes = [
            u8p, ctypes.c_long, ctypes.c_long, i32p, i32p, i32p, ctypes.c_long, f32p]
        _state.lib = lib
    return _state.lib


def _node_arrays(tree) -> list[np.ndarray]:
    n = tree.n_nodes
    out = [np.ascontiguousarray(tree.center, np.float32),
           np.ascontiguousarray(tree.side, np.float32),
           np.ascontiguousarray(tree.parent, np.int32),
           np.ascontiguousarray(tree.childs, np.int32),
           np.ascontiguousarray(tree.is_leaf, np.uint8),
           np.ascontiguousarray(tree.trans_idx, np.int32),
           np.ascontiguousarray(tree.weight_stats, np.int32),
           np.ascontiguousarray(tree.alpha_stats, np.int32),
           np.ascontiguousarray(tree.visit_cnt, np.int32)]
    shapes = [(n, 3), (n,), (n,), (n, 8)] + [(n,)] * 5
    for a, s in zip(out, shapes):
        if a.shape != s:
            raise ValueError(f"octree arrays disagree on the node count {n}: "
                             f"{[x.shape for x in out]}")
    return out


def proc_octree(tree, compact: bool, subdivide: bool,
                brute_force: bool) -> dict:
    """Native ProcOctree on a host tree (compact dead leaves, path-compress
    single-child chains, optionally split visited valid leaves 8 ways).
    Returns the new node arrays by OctreeHost field name; the caller keeps
    the warp table, edge pool and milestones."""
    n = tree.n_nodes
    # a split turns one leaf into 9 nodes, so 9n bounds the output
    max_out = max(9 * n if subdivide else n, 1)
    o = dict(center=np.empty((max_out, 3), np.float32),
             side=np.empty(max_out, np.float32),
             parent=np.empty(max_out, np.int32),
             childs=np.empty((max_out, 8), np.int32),
             is_leaf=np.empty(max_out, np.uint8),
             trans_idx=np.empty(max_out, np.int32),
             weight_stats=np.empty(max_out, np.int32),
             alpha_stats=np.empty(max_out, np.int32))
    nn = library().f2_proc_octree(
        n, *_node_arrays(tree), int(compact), int(subdivide), int(brute_force),
        max_out, *o.values())
    if nn < 0:
        raise RuntimeError(f"f2_proc_octree: output exceeds {max_out} nodes")
    out = {k: v[:nn].copy() for k, v in o.items()}
    out["is_leaf"] = out["is_leaf"].astype(bool)
    return out


def sample_pixels(images: np.ndarray, img_idx: np.ndarray, ys: np.ndarray,
                  xs: np.ndarray) -> np.ndarray:
    """Multithreaded gt-pixel gather for the host data loader:
    images [n, h, w, 3] uint8 at (img_idx, ys, xs) [k] -> [k, 3] f32 in
    [0, 1] (``images[img_idx, ys, xs] / 255``)."""
    if images.ndim != 4 or images.shape[3] != 3:
        raise ValueError(f"sample_pixels: images must be [n, h, w, 3], got "
                         f"{images.shape}")
    img_idx, ys, xs = (np.ascontiguousarray(a, np.int32) for a in (img_idx, ys, xs))
    k = len(img_idx)
    if not (len(ys) == len(xs) == k):
        raise ValueError("sample_pixels: index arrays differ in length")
    out = np.empty((k, 3), np.float32)
    library().f2_sample_pixels(np.ascontiguousarray(images, np.uint8),
                               images.shape[1], images.shape[2], img_idx, ys,
                               xs, k, out)
    return out


def edge_pool(tree, max_edges: int = 1 << 16) -> tuple[np.ndarray, ...]:
    """Native ConstructEdgePool: (edge_t [e, 2] i32, edge_center, edge_dir0,
    edge_dir1 [e, 3] f32), in the order of the valid leaves' pairs. The
    buffers grow until the pool fits."""
    center, side, _, _, _, trans = _node_arrays(tree)[:6]
    while True:
        e_t = np.empty((max_edges, 2), np.int32)
        e_c, e_0, e_1 = (np.empty((max_edges, 3), np.float32) for _ in range(3))
        cnt = library().f2_edge_pool(tree.n_nodes, center, side, trans,
                                     max_edges, e_t, e_c, e_0, e_1)
        if cnt >= 0:
            return tuple(a[:cnt].copy() for a in (e_t, e_c, e_0, e_1))
        max_edges *= 4
