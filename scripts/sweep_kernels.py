"""Sweep the launch shapes and variants of K8-K12, K14's votes and the
offsets launch, and show what their time is made of, on one CUDA card.

    python scripts/sweep_kernels.py [--kernels k8,k9,k10,k11,offsets,k12,k14]
        [--baseline ROOT] [--out results.json]

Each variant is a copy of a source in f2nerf_torch/csrc/ (traverse.cu,
march_parallel.cu, segment.cu, warp.cu or occupancy.cu) with a few text
edits, built alone with nvcc (the package's flags) into a library of its
own under f2nerf_torch/_build/sweep/, and timed on the same inputs as the
unedited kernel, in turns (CUDA events after ~1 ms of a busy stream,
median). Variants that keep the kernel's function are held to the
unedited kernel's outputs bit for bit (K10's, which add in another order,
to the plain version within 1e-5 of each ray's sum of |x|; K12's and
K14's to their plain versions); diagnostic ones (``diag``) change the
arithmetic or drop work to show what that work costs, and are only timed.
With ``--baseline ROOT`` (an earlier tree, e.g. a ``git archive`` of it,
whose compact_a_warp writes no ray offsets and whose votes search rid)
the k12 and k14 sweeps also build ROOT's warp.cu and occupancy.cu and
their diagnostic variants (``EARLIER_*``: the per-block scan
alone, no warp, no divisions, 1 and 2 slots a thread, every row before
the first division; 64- and 128-thread edge blocks, a thread a (sample,
frame); the votes' init and barrier alone, no init, the searches alone),
timed in the same turns as this tree's.

Inputs: K8 on the slice's tree (confs/wanjinyou.yaml at full width on the
ball scene, 945 nodes) with 2,048 uniform rays (hit cap 64) and with the
longest of them repeated 2,048 times (every warp on one path: the cost of
an iteration without divergence), each also with the tree read from
global memory; K9 on that tree with 2,048 uniform rays at hit cap 64 and
max_s 512, at 1, 2 and 4 rays a block; K11 at the slice's B buffer shape
(262,144 rows: 2,048 rays of 0-127 samples, the rest padding) and at
393,216 rows of 2,048 rays of 192; K10 (given the offsets launch's
offsets) and the offsets launch at 2,048 rays of 192 rows and at a
B-shaped buffer (2,048 rays of 0-139 rows), K10 at C = 1, 2, 6 and 16 and
at C = 16 read from the first 16 columns of a [n, 32] buffer (the layout
of the appearance gather's gradient); K12 and K14's votes at the slice
step's shapes (``step_warp_inputs``: 2,048 rays, cap1 262,144, 146,012
valid slots in runs of 1-32 at one leaf, 393,216 nodes, 8,192 edge
samples) and at the slice's uniform shape (K12: ``uniform_a``, 393,216
slots at random leaves; votes: ``uniform_votes``). A one-element torch add
is timed the same way: the floor of a launch.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from f2nerf_torch import kernels  # noqa: E402

SWEEP_DIR = os.path.join(REPO, "f2nerf_torch", "_build", "sweep")
PREFILL_CYCLES = 2_000_000
REPS = 20
ROUNDS = 3

K8_FILL = "for (int k = cj + lane; k < H; k += 32) {"
# staging by cp.async instead (every copy in flight, no registers, one wait)
K8_STAGE = """      int4 v[kStage];
#pragma unroll
      for (int k = 0; k < kStage; ++k)
        if (i0 + k * kThreads < total) v[k] = __ldg(rec_g + i0 + k * kThreads);
#pragma unroll
      for (int k = 0; k < kStage; ++k)
        if (i0 + k * kThreads < total) smem[i0 + k * kThreads] = v[k];
    }
    for (int i = threadIdx.x; i < n_nodes; i += kThreads) strans[i] = __ldg(trans_g + i);"""
K8_STAGE_ASYNC = """      for (int k = 0; k < kStage; ++k)
        if (i0 + k * kThreads < total)
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
              (unsigned)__cvta_generic_to_shared(smem + i0 + k * kThreads)),
              "l"(rec_g + i0 + k * kThreads) : "memory");
    }
    for (int i = threadIdx.x; i < n_nodes; i += kThreads)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
          (unsigned)__cvta_generic_to_shared(strans + i)), "l"(trans_g + i) : "memory");
    asm volatile("cp.async.wait_all;" ::: "memory");"""
K8_VARIANTS = {
    "base": [],
    "threads32": [("constexpr int kThreads = 64;", "constexpr int kThreads = 32;")],
    "threads128": [("constexpr int kThreads = 64;", "constexpr int kThreads = 128;")],
    "diag_fast_div": [("__fdiv_rn(", "__fdividef(")],
    "diag_no_fill": [(K8_FILL, "for (int k = H; k < H; k += 32) {")],
    "diag_no_emit_store": [("if (emit) {", "if (emit && H < 0) {")],
    "stage1": [("constexpr int kStage = 16;", "constexpr int kStage = 1;")],
    "stage8": [("constexpr int kStage = 16;", "constexpr int kStage = 8;")],
    "stage_cp_async": [(K8_STAGE, K8_STAGE_ASYNC)],
}
K11_LOOKBACK = "for (long long b = (long long)tile - 1; b >= 0; b -= 32) {"
K11_VARIANTS = {
    "base": [],
    "tile4096": [("constexpr int kChunks = 8;", "constexpr int kChunks = 16;")],
    "tile1024": [("constexpr int kChunks = 8;", "constexpr int kChunks = 4;")],
    "warps4": [("constexpr int kWarps = 8;", "constexpr int kWarps = 4;")],
    "diag_no_lookback": [(K11_LOOKBACK, "for (long long b = -1; b >= 0; b -= 32) {")],
}
K10_VARIANTS = {
    "base": [],
    "vec2": [("constexpr int kUnrollVec = 4;", "constexpr int kUnrollVec = 2;")],
    "vec8": [("constexpr int kUnrollVec = 4;", "constexpr int kUnrollVec = 8;")],
    "tile4": [("constexpr int kTile = 8;", "constexpr int kTile = 4;")],
    # a launch that reads each ray's offsets and writes its zeros, no rows
    "diag_no_rows": [
        ("for (long long i = s + lane / Q; i < e;", "for (long long i = e; i < e;"),
        ("for (long long i = s + lane; i < e;", "for (long long i = e; i < e;")],
}
# the offsets launch's grid: every block the card holds at once (base), or
# one or two a multiprocessor (fewer blocks at the grid barrier, more rows
# a thread)
OFFSETS_GRID = "    resident[dev] = sms * per_sm;"
OFFSETS_VARIANTS = {
    "base": [],
    "one_a_sm": [(OFFSETS_GRID, "    resident[dev] = sms;")],
    "two_a_sm": [(OFFSETS_GRID, "    resident[dev] = 2 * sms;")],
}
K9_BOUNDS = "__global__ void __launch_bounds__(kMaxThreads, 4)"
K9_ROW_LOAD = ("      const float4 r0 = __ldg(m4 + 8 * kq + 2 * kk), "
               "r1 = __ldg(m4 + 8 * kq + 2 * kk + 1);")
K9_VARIANTS = {
    "base": [],
    # 79 registers, no spills, but fewer rays resident at once
    "regs128": [(K9_BOUNDS, "__global__ void __launch_bounds__(kMaxThreads, 2)")],
    # a group's eight w2xz float4s loaded up front (spills at 64 registers)
    "rows_per_group": [
        ("    float4 w[3];\n",
         "    float4 w[3], m[8];\n#pragma unroll\n"
         "    for (int j = 0; j < 8; ++j) m[j] = __ldg(m4 + 8 * kq + j);\n"),
        (K9_ROW_LOAD, "      const float4 r0 = m[2 * kk], r1 = m[2 * kk + 1];")],
}
K9_RAYS_PER_BLOCK = (1, 2, 4)    # csrc/march_parallel.cu: at most 256 threads a block

# the earlier K12 and K14 (the sources of --baseline ROOT):
# the unedited kernels and diagnostic variants that each remove one
# suspect. Both K12 entry points share warp.cu's libraries.
EARLIER_A_SLOT = "    if (j >= p.cap) continue;\n    const bool ok = owner[k] >= 0;"
EARLIER_EDGE_IDX = "  const int i = blockIdx.x * kThreads + threadIdx.x;\n  if (i >= p.n) return;"
EARLIER_EDGE_LAUNCH = "sample_edges_kernel<<<(n + kThreads - 1) / kThreads, kThreads,"
EARLIER_EDGE_BODY = """#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int ts = __ldg(p.edge_t + 2 * e + s);"""
EARLIER_WARP_LOADS = """  out[0] = out[1] = out[2] = 0.0f;
#pragma unroll
  for (int kq = 0; kq < kPros / 4; ++kq) {
    float4 w[3];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) w[ax] = __ldg(w4 + 3 * ax + kq);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 r0 = __ldg(m4 + 8 * kq + 2 * kk), r1 = __ldg(m4 + 8 * kq + 2 * kk + 1);"""
# every row of the leaf loaded before the first division
EARLIER_WARP_UPFRONT = """  float4 m[24], w9[9];
#pragma unroll
  for (int q = 0; q < 24; ++q) m[q] = __ldg(m4 + q);
#pragma unroll
  for (int q = 0; q < 9; ++q) w9[q] = __ldg(w4 + q);
  out[0] = out[1] = out[2] = 0.0f;
#pragma unroll
  for (int kq = 0; kq < kPros / 4; ++kq) {
    float4 w[3];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) w[ax] = w9[3 * ax + kq];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 r0 = m[8 * kq + 2 * kk], r1 = m[8 * kq + 2 * kk + 1];"""


def earlier_edge_threads(t: int) -> list:
    return [(EARLIER_EDGE_IDX, "  const int i = blockIdx.x * blockDim.x + threadIdx.x;\n"
                            "  if (i >= p.n) return;"),
            (EARLIER_EDGE_LAUNCH, f"sample_edges_kernel<<<(n + {t - 1}) / {t}, {t},")]


EARLIER_WARP_VARIANTS = {
    "base": [],
    # compact_a_warp: the per-block scan alone (each slot's owner stored)
    "diag_scan_only": [(EARLIER_A_SLOT, "    if (j >= p.cap) continue;\n    p.rid[j] = owner[k];\n"
                                     "    continue;\n    const bool ok = owner[k] >= 0;")],
    # compact_a_warp: the scan and the gathers, no warp
    "diag_no_warp": [("      warp_point(p.w2xz, p.weight, tr, x, w);",
                      "      w[0] = x[0]; w[1] = x[1]; w[2] = x[2];")],
    # both: the warp with products for the divisions (wrong bits)
    "diag_no_div": [("const float v = __fdiv_rn(", "const float v = __fmul_rn(")],
    "slots1": [("constexpr int kSlots = 4;", "constexpr int kSlots = 1;")],
    "slots2": [("constexpr int kSlots = 4;", "constexpr int kSlots = 2;")],
    # both: the leaf's 33 float4 rows loaded before the first division
    "rows_upfront": [(EARLIER_WARP_LOADS, EARLIER_WARP_UPFRONT)],
    # sample_edges: 64- and 128-thread blocks; a thread a (sample, frame)
    "edges_threads64": earlier_edge_threads(64),
    "edges_threads128": earlier_edge_threads(128),
    "edges_per_frame": [
        (EARLIER_EDGE_IDX, "  const int i = (blockIdx.x * kThreads + threadIdx.x) >> 1;\n"
                        "  if (i >= p.n) return;"),
        (EARLIER_EDGE_BODY, "  {\n    const int s = threadIdx.x & 1;\n"
                         "    const int ts = __ldg(p.edge_t + 2 * e + s);"),
        (EARLIER_EDGE_LAUNCH, "sample_edges_kernel<<<(2 * n + kThreads - 1) / kThreads, kThreads,")],
}
EARLIER_A_NAMES = ("base", "diag_scan_only", "diag_no_warp", "diag_no_div", "slots1", "slots2",
                "rows_upfront")
EARLIER_EDGE_NAMES = ("base", "diag_no_div", "rows_upfront", "edges_threads64",
                   "edges_threads128", "edges_per_frame")
# this tree's K12 and K14: launch shapes, the layouts and diagnostic
# variants
WARP_FINAL = ("    if (owner[k] >= 0) valid_slot(p, j, owner[k], start[k]); "
              "else pad_slot(p, j);")
WARP_GROUP = """    float a[4], b[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      a[kk] = row_dot(__ldg(m4 + 8 * kq + 2 * kk), x);
      b[kk] = row_dot(__ldg(m4 + 8 * kq + 2 * kk + 1), x);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float v = __fdiv_rn(a[kk], b[kk]);"""
# the earlier order: each projection's rows loaded just before its division
WARP_PER_PROJECTION = """#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float v = __fdiv_rn(row_dot(__ldg(m4 + 8 * kq + 2 * kk), x),
                                row_dot(__ldg(m4 + 8 * kq + 2 * kk + 1), x));"""


def edge_threads(t: int) -> list:
    return [("constexpr int kEdgeThreads = 64;", f"constexpr int kEdgeThreads = {t};")]


# one scan by block 0, a grid barrier (a cooperative launch), the owners
# searched in the offsets in L2, or a warp a ray over its slots: the
# alternatives to a scan a block (warp.cu keeps the faster)
WARP_KERNEL = "__global__ void __launch_bounds__(kThreads, kMinBlocks) compact_a_warp_kernel"
WARP_LAUNCH = """  const long long blocks = (cap + kBlockSlots - 1) / kBlockSlots;
  compact_a_warp_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}"""
SCAN_ONCE_FUNCS = """// block 0: offsets[r] = min(the sum of n_s before r, cap) for
// r <= R, a pass of kChunkRays rays at a time
__device__ void scan_offsets(const CompactA& p) {
  __shared__ int s_warp[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long carry = 0;
  for (int r0 = 0; r0 < p.n_rays; r0 += kChunkRays) {
    int v[kRayStep];
    load_counts(p, r0, v);
    int sum = 0;
#pragma unroll
    for (int i = 0; i < kRayStep; ++i) sum += v[i];
    int incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    long long start = carry + incl - sum;
    long long chunk = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      start += w < warp ? s_warp[w] : 0;
      chunk += s_warp[w];
    }
#pragma unroll
    for (int i = 0; i < kRayStep; ++i) {
      const int r = r0 + kRayStep * threadIdx.x + i;
      if (r < p.n_rays) p.offsets[r] = (int)min(start, p.cap);
      start += v[i];
    }
    carry += chunk;
    __syncthreads();           // s_warp is rewritten by the next pass
  }
  if (threadIdx.x == 0) p.offsets[p.n_rays] = (int)min(carry, p.cap);
}

// block 0 writes every offset, a grid barrier, then a thread a slot
// (grid-stride) finds its owner in the offsets (the last ray whose offset
// is <= j), or a warp a ray, then the padding
__device__ void scan_once_slots(const CompactA& p) {
  if (blockIdx.x == 0) scan_offsets(p);
  cooperative_groups::this_grid().sync();
  const int* off = p.offsets;    // written in this launch: plain loads, not __ldg
  const long long total = off[p.n_rays];
  const long long stride = (long long)gridDim.x * kThreads;
  const long long j0 = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (RAY_WARPS) {
    const int lane = threadIdx.x & 31;
    const int n_warps = (int)(stride >> 5);
    for (int r = (int)(j0 >> 5); r < p.n_rays; r += n_warps) {
      const int s = off[r], e = off[r + 1];
      for (long long j = s + lane; j < e; j += 32) valid_slot(p, j, r, s);
    }
    for (long long j = total + j0; j < p.cap; j += stride) pad_slot(p, j);
    return;
  }
  for (long long j = j0; j < p.cap; j += stride) {
    if (j >= total) {
      pad_slot(p, j);
      continue;
    }
    int lo = 0, hi = p.n_rays - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (off[mid] <= j) lo = mid; else hi = mid - 1;
    }
    valid_slot(p, j, lo, off[lo]);
  }
}

"""
SCAN_ONCE_LAUNCH = """  static int resident[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, compact_a_warp_kernel,
                                                        kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    if (sms * per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
    resident[dev] = sms * per_sm;
  }
  const long long want = (cap + kThreads - 1) / kThreads;
  const unsigned grid = (unsigned)(want < resident[dev] ? want : resident[dev]);
  void* args[] = {(void*)&p};
  e = cudaLaunchCooperativeKernel((const void*)compact_a_warp_kernel, dim3(grid),
                                  dim3(kThreads), args, 0, (cudaStream_t)stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}"""


def scan_once(ray_warps: bool) -> list:
    return [("#include <cuda_runtime.h>", "#include <cooperative_groups.h>\n#include <cuda_runtime.h>"),
            (WARP_KERNEL, SCAN_ONCE_FUNCS.replace("RAY_WARPS", "true" if ray_warps else "false")
             + WARP_KERNEL),
            ("compact_a_warp_kernel(const CompactA p) {\n",
             "compact_a_warp_kernel(const CompactA p) {\n  scan_once_slots(p);\n  return;\n"),
            (WARP_LAUNCH, SCAN_ONCE_LAUNCH)]


WARP_VARIANTS = {
    "base": [],
    "slots1": [("constexpr int kSlots = 2;", "constexpr int kSlots = 1;")],
    "slots4": [("constexpr int kSlots = 2;", "constexpr int kSlots = 4;")],
    "chunk2048": [("constexpr int kRayStep = 4;", "constexpr int kRayStep = 8;")],
    # one scan and a grid barrier (a cooperative launch), the owners
    # searched in the offsets in global memory; and a warp a ray with it
    "scan_once": scan_once(False),
    "scan_once_ray_warps": scan_once(True),
    "min_blocks4": [("constexpr int kMinBlocks = 3;", "constexpr int kMinBlocks = 4;")],
    "min_blocks2": [("constexpr int kMinBlocks = 3;", "constexpr int kMinBlocks = 2;")],
    "per_projection": [(WARP_GROUP, WARP_PER_PROJECTION)],
    # the scan and the owner search alone (each slot's owner stored)
    "diag_scan_only": [(WARP_FINAL, "    p.rid[j] = owner[k];")],
    "edge_threads32": edge_threads(32),
    "edge_threads128": edge_threads(128),
}
WARP_A_NAMES = ("base", "slots1", "slots4", "chunk2048", "scan_once", "scan_once_ray_warps",
                "min_blocks4", "min_blocks2", "per_projection", "diag_scan_only")
WARP_EDGE_NAMES = ("base", "per_projection", "edge_threads32", "edge_threads128")
VOTES_GRID = "  const unsigned grid = (unsigned)(want < resident[dev] ? want : resident[dev]);"
VOTES_EARLY = "  if (r0 < p.n_rays) load_window(p, r0, lane, s, e, nd, wv, av);\n"
VOTES_RUN_STORES = """  if (last && valid && nd < p.n_nodes) {      // a node past the capacity would be the dump
    const long long run0 = upto ? base + first : run_start;
    p.mark[nd] = 1;
    if ((vw & span) || (!upto && vote_w)) p.adder_w[nd] = kWeightBase;
    if ((va & span) || (!upto && vote_a)) p.adder_a[nd] = kAlphaBase;
    atomicMax(p.visit_max + nd, (int)(i - run0 + 1));
  }"""
# the earlier stores: every valid row stores mark and its own votes
VOTES_ROW_STORES = """  if (valid && nd < p.n_nodes) {
    p.mark[nd] = 1;
    if (wi > tw) p.adder_w[nd] = kWeightBase;
    if (ai > ta) p.adder_a[nd] = kAlphaBase;
    if (last) atomicMax(p.visit_max + nd, (int)(i - (upto ? base + first : run_start) + 1));
  }"""
VOTES_ATOMIC = "    atomicMax(p.visit_max + nd, (int)(i - run0 + 1));"
VOTES_ATOMIC_CHECKED = """    const int len = (int)(i - run0 + 1);
    if (__ldcg(p.visit_max + nd) < len) atomicMax(p.visit_max + nd, len);"""
VOTES_VARIANTS = {
    "base": [],
    "diag_init_only": [("for (int r = r0; r < p.n_rays; r += n_warps) {",
                        "for (int r = r0; r < 0; r += n_warps) {")],
    "diag_no_init": [("u < p.n_nodes; u += stride) {", "u < 0; u += stride) {")],
    "window4": [("constexpr int kWindow = 16;", "constexpr int kWindow = 4;")],
    "window8": [("constexpr int kWindow = 16;", "constexpr int kWindow = 8;")],
    # the first ray's rows loaded after the barrier, not before the init
    "late_loads": [(VOTES_EARLY, ""), ("    if (r != r0) load_window(", "    load_window(")],
    "row_stores": [(VOTES_RUN_STORES, VOTES_ROW_STORES)],
    # a run's atomicMax only where visit_max (read from L2) is below its length
    "check_atomic": [(VOTES_ATOMIC, VOTES_ATOMIC_CHECKED)],
    # every block the card holds, as the earlier kernel launched
    "grid_resident": [(VOTES_GRID, "  const unsigned grid = (unsigned)resident[dev];")],
}
EARLIER_VOTE_INIT = "u < p.n_nodes; u += stride) {"
EARLIER_VOTE_RAYS = "r < p.n_rays; r += n_warps) {"
EARLIER_VOTE_SEARCH = "    const long long e = warp_lower_bound(p.rid, p.n, r + 1, lane);\n"
EARLIER_VOTES_VARIANTS = {
    "base": [],
    # the init and the grid barrier alone
    "diag_init_only": [(EARLIER_VOTE_RAYS, "r < 0; r += n_warps) {")],
    # everything but the init (the barrier kept)
    "diag_no_init": [(EARLIER_VOTE_INIT, "u < 0; u += stride) {")],
    # the barrier and the two searches a ray (each ray's row count stored)
    "diag_search_only": [(EARLIER_VOTE_INIT, "u < 0; u += stride) {"),
                         (EARLIER_VOTE_SEARCH, EARLIER_VOTE_SEARCH +
                          "    if (lane == 0) p.visit_max[r] = (int)(e - s);\n    continue;\n")],
}


def log(*a):
    print(*a, flush=True)


def build(kind: str, variants: dict, csrc: str = None, tag: str = "") -> dict:
    """One library a variant, all nvcc processes started together; the
    sources from ``csrc`` (this tree's f2nerf_torch/csrc/ by default), the
    files named with ``tag`` first (a library is loaded once a path)."""
    os.makedirs(SWEEP_DIR, exist_ok=True)
    src = open(os.path.join(csrc or kernels.CSRC, f"{kind}.cu")).read()
    procs = {}
    for name, edits in variants.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{kind} {name}: {old!r} not in the source")
            text = text.replace(old, new)
        cu = os.path.join(SWEEP_DIR, f"{tag}{kind}_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = cu[:-3] + ".so"
        procs[name] = (so, subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", so, cu],
                                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                            text=True))
    libs = {}
    for name, (so, p) in procs.items():
        out, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {kind} {name}:\n{err}")
        regs = [ln.strip() for ln in err.splitlines() if "registers" in ln or "stack" in ln]
        log(f"[build] {tag}{kind} {name}: {regs}")
        libs[name] = ctypes.CDLL(so)
    return libs


def cuda_ms(fn) -> list:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(REPS):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(PREFILL_CYCLES)
        s.record()
        fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e))
    return out


def in_turns(fns: dict) -> dict:
    times = {k: [] for k in fns}
    order = list(fns)
    for r in range(ROUNDS):
        for k in (order if r % 2 == 0 else order[::-1]):
            times[k] += cuda_ms(fns[k])
    return {k: statistics.median(v) for k, v in times.items()}


def bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def slice_tree():
    from f2nerf_torch.train.trainer import Trainer
    from f2nerf_torch.utils.config import compose
    from f2nerf_torch.utils.synthetic import write_ball_dataset
    tmp = tempfile.mkdtemp(prefix="f2sweep_")
    cfg = compose(os.path.join(REPO, "confs"), "wanjinyou", ["+train.fused_adam=true"])
    tr = Trainer(cfg, os.path.join(tmp, "exp"), write_ball_dataset(os.path.join(tmp, "ball")),
                 seed=2022, device="cuda")
    return tr.tree, float(cfg["pts_sampler"]["near"])


def sweep_k8() -> dict:
    from f2nerf_torch.sampler import device as dv
    libs = build("traverse", K8_VARIANTS)
    vp, i = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        lib.f2_traverse.argtypes = [vp] * 13 + [i, i, i, i, vp]
        lib.f2_traverse.restype = ctypes.c_int
    tree, near = slice_tree()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    R, H = 2048, 64
    o = torch.rand((R, 3), generator=gen, device=dev) * 2.0 - 1.0
    d = torch.randn((R, 3), generator=gen, device=dev)
    d = d / dv.norm3(d)[:, None]
    nr, fr = torch.full((R,), near, device=dev), torch.full((R,), 1e8, device=dev)
    dv.traverse(tree, o, d, nr, fr, H)
    longest = int(torch.argmax(dv.traverse.last_iters))
    cases = {"uniform": (o, d, dv.traverse_smem_nodes(tree)),
             "one_ray_x2048": (o[longest].expand(R, 3).contiguous(),
                               d[longest].expand(R, 3).contiguous(),
                               dv.traverse_smem_nodes(tree))}
    i32 = dict(dtype=torch.int32, device=dev)

    def run(lib, ro, rd, smem):
        outs = (torch.empty((R, H), **i32), torch.empty((R, H), device=dev),
                torch.empty((R, H), device=dev), torch.empty((R,), **i32),
                torch.empty((R,), dtype=torch.bool, device=dev), torch.empty((R,), **i32),
                torch.empty((), **i32))
        kernels.check(lib.f2_traverse(
            tree.node_rec.data_ptr(), tree.trans_idx.data_ptr(),
            *(x.data_ptr() for x in (ro, rd, nr, fr) + outs), smem, R, H, 4096,
            kernels.stream_ptr(dev)), "sweep traverse")
        return outs

    res = {}
    for case, (ro, rd, smem) in cases.items():
        want = run(libs["base"], ro, rd, smem)
        torch.cuda.synchronize()
        iters = want[5]
        equal = {}
        for name, lib in libs.items():
            got = run(lib, ro, rd, smem)
            torch.cuda.synchronize()
            equal[name] = all(torch.equal(bits(g), bits(w)) for g, w in zip(got, want))
            if not name.startswith("diag") and not equal[name]:
                raise AssertionError(f"K8 {name} differs from the base kernel ({case})")
        # each variant, and the unedited kernel reading the tree from global
        # memory (in L1 after its first touch at this size) instead
        fns = {name: (lambda lib=lib: run(lib, ro, rd, smem)) for name, lib in libs.items()}
        fns["base_global"] = lambda: run(libs["base"], ro, rd, 0)
        equal["base_global"] = all(torch.equal(bits(g), bits(w))
                                   for g, w in zip(run(libs["base"], ro, rd, 0), want))
        t = in_turns(fns)
        loop = int(iters.max())
        res[case] = dict(ms=t, equal=equal, loop_iters=loop,
                         mean_iters=float(iters.float().mean()), smem_nodes=smem)
        log(f"[K8] {case} (R {R}, loop {loop} iterations, mean "
            f"{float(iters.float().mean()):.1f}, shared-memory nodes {smem}): " +
            ", ".join(f"{k} {v:.4f} ms ({v * 1e6 / loop:.0f} ns an iteration; equal "
                      f"{equal[k]})" for k, v in t.items()))
    return res


def sweep_k11() -> dict:
    from f2nerf_torch.ops import segment as sg
    libs = build("segment", K11_VARIANTS)
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dev = torch.device("cuda")
    states = {}
    for name, lib in libs.items():
        lib.f2_segment_scan.argtypes = [vp] * 4 + [ll, i, i, vp]
        lib.f2_segment_scan.restype = ctypes.c_int
        states[name] = torch.zeros((1 << 16,), dtype=torch.uint8, device=dev)
    rng = np.random.RandomState(3)
    cases = {}
    rid = np.repeat(np.arange(2048), rng.randint(0, 128, 2048))
    cases["step_b_262144"] = np.concatenate([rid, np.full(262144 - rid.shape[0], 2048)])
    cases["uniform_393216"] = np.repeat(np.arange(2048), 192)

    def run(name, x, first):
        out = torch.empty_like(x)
        kernels.check(libs[name].f2_segment_scan(
            x.data_ptr(), first.data_ptr(), out.data_ptr(), states[name].data_ptr(),
            x.shape[0], 1, 0, kernels.stream_ptr(dev)), "sweep segment_scan")
        return out

    res = {}
    for case, r in cases.items():
        rid_d = torch.from_numpy(r.astype(np.int32)).to(dev)
        first = sg.first_flags_from_ray_id(rid_d, 2048)
        x = torch.rand(rid_d.shape, device=dev)
        want = sg.segment_cumsum_plain(x, first)
        err, again = {}, {}
        for name in libs:
            got = run(name, x, first)
            rep = run(name, x, first)
            torch.cuda.synchronize()
            err[name] = (got - want).abs().max().item()
            again[name] = torch.equal(bits(got), bits(rep))
            if not name.startswith("diag") and not (err[name] <= 1e-6 * (1 + want.abs().max().item())
                                                    and again[name]):
                raise AssertionError(f"K11 {name} is off ({case}): {err[name]}, {again[name]}")
        t = in_turns({name: (lambda name=name: run(name, x, first)) for name in libs})
        res[case] = dict(ms=t, max_abs_err=err, repeats=again, n=int(r.shape[0]))
        log(f"[K11] {case}: " + ", ".join(f"{k} {v:.4f} ms (err {err[k]:.1e})"
                                          for k, v in t.items()))
    return res


def step_like_ray_ids() -> dict:
    rng = np.random.RandomState(5)
    rid = np.repeat(np.arange(2048), rng.randint(0, 140, 2048))
    return {"step_b_262144": np.concatenate([rid, np.full(262144 - rid.shape[0], 2048)]),
            "uniform_393216": np.repeat(np.arange(2048), 192)}


def sweep_k10() -> dict:
    from f2nerf_torch.ops import segment as sg
    libs = build("segment", {f"k10_{k}": v for k, v in K10_VARIANTS.items()})
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for lib in libs.values():
        lib.f2_segment_reduce.argtypes = [vp, ll, ll, vp, vp, i, i, vp]
        lib.f2_segment_reduce.restype = ctypes.c_int
    dev = torch.device("cuda")

    def run(name, x, offsets, c):
        out = torch.empty((2048, c), device=dev)
        kernels.check(libs[name].f2_segment_reduce(
            x.data_ptr(), x.stride(0) if x.dim() == 2 else 1, x.shape[0], offsets.data_ptr(),
            out.data_ptr(), 2048, c, kernels.stream_ptr(dev)), "sweep segment_reduce")
        return out

    res = {}
    for case, r in step_like_ray_ids().items():
        rid_d = torch.from_numpy(r.astype(np.int32)).to(dev)
        offsets = sg.ray_offsets(rid_d, 2048)[0]
        # C = 16 also as the appearance gather's gradient is laid out: the
        # first 16 columns of a [n, 32] buffer
        for c, width in ((1, 1), (2, 2), (6, 6), (16, 16), (16, 32)):
            x = torch.rand((rid_d.shape[0], width), device=dev)[:, :c]
            want = run("k10_base", x, offsets, c)
            plain = sg.segment_sum_plain(x, rid_d, 2048)
            scale = sg.segment_sum_plain(x.abs(), rid_d, 2048)
            torch.cuda.synchronize()
            equal = {}
            for name in libs:
                got = run(name, x, offsets, c)
                torch.cuda.synchronize()
                equal[name] = torch.equal(bits(got), bits(want))
                # the unrolls and tiles change the order of the adds
                if not name.startswith("k10_diag") and \
                        not bool(((got - plain).abs() <= 1e-5 * scale).all()):
                    raise AssertionError(f"K10 {name} is off ({case}, C {c})")
            t = in_turns({name: (lambda name=name: run(name, x, offsets, c)) for name in libs})
            res[f"{case}_c{c}_ld{width}"] = dict(ms=t, equal_to_base=equal)
            log(f"[K10] {case}, C {c}, row stride {width}: " + ", ".join(
                f"{k[4:]} {v:.4f} ms (bits of base {equal[k]})" for k, v in t.items()))
    return res


def sweep_offsets() -> dict:
    from f2nerf_torch.ops import segment as sg
    libs = build("segment", {f"offsets_{k}": v for k, v in OFFSETS_VARIANTS.items()})
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for lib in libs.values():
        lib.f2_ray_offsets.argtypes = [vp] * 4 + [ll, i, vp]
        lib.f2_ray_offsets.restype = ctypes.c_int
    dev = torch.device("cuda")

    def run(name, rid):
        n = rid.shape[0]
        outs = (torch.empty((2049,), dtype=torch.int32, device=dev),
                torch.empty((2048,), device=dev), torch.empty((n,), dtype=torch.int32, device=dev))
        kernels.check(libs[name].f2_ray_offsets(
            rid.data_ptr(), *(o.data_ptr() for o in outs), n, 2048, kernels.stream_ptr(dev)),
            "sweep ray_offsets")
        return outs

    res = {}
    for case, r in step_like_ray_ids().items():
        rid_d = torch.from_numpy(r.astype(np.int32)).to(dev)
        want = sg.ray_offsets_plain(rid_d, 2048)
        for name in libs:
            got = run(name, rid_d)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"ray_offsets {name} differs from its plain version ({case})")
        t = in_turns({name: (lambda name=name: run(name, rid_d)) for name in libs})
        res[case] = t
        log(f"[offsets] {case}: " + ", ".join(f"{k[8:]} {v:.4f} ms" for k, v in t.items()))
    return res


def sweep_k9() -> dict:
    from f2nerf_torch.sampler import device as dv
    libs = build("march_parallel", K9_VARIANTS)
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for lib in libs.values():
        lib.f2_ray_march_parallel.argtypes = [vp] * 18 + [i, i, i, f, i, i, i, vp]
        lib.f2_ray_march_parallel.restype = ctypes.c_int
    tree, near = slice_tree()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    R, H, max_s = 2048, 64, 512
    o = torch.rand((R, 3), generator=gen, device=dev) * 2.0 - 1.0
    d = torch.randn((R, 3), generator=gen, device=dev)
    d = d / dv.norm3(d)[:, None]
    hits = dv.traverse(tree, o, d, torch.full((R,), near, device=dev),
                       torch.full((R,), 1e8, device=dev), H)[:4]
    jitter = torch.rand((R, max_s), generator=gen, device=dev) * (1 - 1e-4) + 1e-4
    fineness = torch.ones((), device=dev)
    args = (tree, o, d, *hits, jitter, fineness, 1.0 / 256, True, max_s)
    want = dv.ray_march_parallel_plain(*args)
    ray_threads = dv.ray_march_parallel_geometry(H)["ray_threads"]

    def run(lib, k):
        outs = (torch.empty((R, max_s), device=dev), torch.empty((R, max_s), device=dev),
                torch.empty((R, max_s), dtype=torch.int32, device=dev),
                torch.empty((R,), dtype=torch.int32, device=dev), torch.empty((R,), device=dev))
        ins = (*hits, o, d, jitter, fineness, tree.trans_idx, tree.w2xz, tree.weight,
               tree.t_center, tree.t_dis)
        kernels.check(lib.f2_ray_march_parallel(
            *(x.data_ptr() for x in ins + outs), R, H, max_s, 1.0 / 256, 1, ray_threads, k,
            kernels.stream_ptr(dev)), "sweep ray_march_parallel")
        return outs

    fns, equal = {}, {}
    for name, lib in libs.items():
        for k in K9_RAYS_PER_BLOCK:
            got = run(lib, k)
            torch.cuda.synchronize()
            equal[f"{name}_k{k}"] = all(torch.equal(bits(g), bits(w)) for g, w in zip(got, want))
            if not equal[f"{name}_k{k}"]:
                raise AssertionError(f"K9 {name}, {k} rays a block, differs from the plain version")
            fns[f"{name}_k{k}"] = lambda lib=lib, k=k: run(lib, k)
    t = in_turns(fns)
    log(f"[K9] uniform rays (R {R}, H {H}, {int(hits[3].sum())} hits, "
        f"{int(want[3].sum())} samples; {ray_threads} threads a ray, _k rays a block): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in t.items()))
    return dict(ms=t, equal=equal)


# the slice step's shapes for K12 and K14 (PERF.md §6): 2,048 rays,
# max_s 512, cap1 262,144 slots of which 146,012 valid, 8,192 edge samples
STEP_RAYS, STEP_MAX_S, STEP_CAP1, STEP_VALID, STEP_EDGES = 2048, 512, 262144, 146012, 8192


def step_warp_inputs(tree, seed: int = 12) -> dict:
    """compact_a_warp's, sample_edges' and the votes' inputs at the slice
    step's shapes on the slice's tree: n_s U[0, 143) adjusted to
    STEP_VALID samples in all, each ray's samples in runs of 1-32 at one
    leaf with increasing t; uniform rays; the votes over the plain
    version's buffer A with weights U[0, 0.05) and alphas U[0, 0.1)."""
    from f2nerf_torch.render import renderer as rd
    from f2nerf_torch.sampler import device as dv
    dev = torch.device("cuda")
    rng = np.random.RandomState(seed)
    R, max_s, cap = STEP_RAYS, STEP_MAX_S, STEP_CAP1
    n_s = rng.randint(0, 143, R)
    while n_s.sum() != STEP_VALID:
        step = 1 if n_s.sum() < STEP_VALID else -1
        i = rng.randint(R)
        n_s[i] = min(max(n_s[i] + step, 0), max_s)
    leaves = np.nonzero(tree.trans_idx.cpu().numpy() >= 0)[0]
    node = np.repeat(rng.choice(leaves, R * max_s), rng.randint(1, 33, R * max_s))[:R * max_s]
    live = np.arange(max_s)[None, :] < n_s[:, None]
    out_node = np.where(live, node.reshape(R, max_s), -1).astype(np.int32)
    out_t = np.where(live, np.cumsum(rng.uniform(0, 0.01, (R, max_s)), 1), 0).astype(np.float32)
    out_dt = np.where(live, rng.uniform(0, 0.01, (R, max_s)), 0).astype(np.float32)
    o = rng.uniform(-1, 1, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in dict(
        n_s=n_s.astype(np.int32), out_t=out_t, out_dt=out_dt, out_node=out_node, o=o,
        d=d).items()}
    a_args = (tree, t["n_s"], t["out_t"], t["out_dt"], t["out_node"], t["o"], t["d"], cap)
    a, rid_a, _ = rd.compact_a_warp_plain(*a_args)[:3]
    w = torch.from_numpy(rng.uniform(0, 0.05, cap).astype(np.float32)).to(dev)
    alpha = torch.from_numpy(rng.uniform(0, 0.1, cap).astype(np.float32)).to(dev)
    e = torch.from_numpy(rng.randint(0, max(tree.n_edges, 1), STEP_EDGES).astype(np.int32)).to(dev)
    coord = torch.from_numpy(rng.uniform(-1, 1, (STEP_EDGES, 2)).astype(np.float32)).to(dev)
    dv.check_warp_tables("sweep", tree)
    return dict(a=a_args, votes=(tree, a["node"], rid_a, w, alpha, R), edges=(tree, e, coord))


def uniform_a(tree, seed: int = 13, R: int = 2048, max_s: int = 512, cap: int = 393216) -> tuple:
    """compact_a_warp's input at the slice's uniform shape (as
    chip_smoke.py's dense_uniform_args): n_s U[0, 384) (every 97th ray
    empty), each sample at a random leaf or, a tenth of them, at a node
    whose leaf row is -1, t within the root; uniform rays."""
    dev = torch.device("cuda")
    rng = np.random.RandomState(seed)
    ti = tree.trans_idx.cpu().numpy()
    leaves, dead = np.nonzero(ti >= 0)[0], np.nonzero(ti < 0)[0]
    n_s = rng.randint(0, 384, R)
    n_s[::97] = 0
    live = np.arange(max_s)[None, :] < n_s[:, None]
    node = np.where(rng.rand(R, max_s) < 0.1, rng.choice(dead, (R, max_s)),
                    rng.choice(leaves, (R, max_s)))
    side = float(tree.side[0])
    t = {"n_s": n_s.astype(np.int32),
         "out_t": np.where(live, rng.uniform(0, side, (R, max_s)), 0).astype(np.float32),
         "out_dt": np.where(live, rng.uniform(0, 0.01, (R, max_s)), 0).astype(np.float32),
         "out_node": np.where(live, node, -1).astype(np.int32),
         "o": rng.uniform(-1, 1, (R, 3)).astype(np.float32)}
    d = rng.normal(size=(R, 3)).astype(np.float32)
    t["d"] = d / np.linalg.norm(d, axis=1, keepdims=True)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in t.items()}
    return (tree, t["n_s"], t["out_t"], t["out_dt"], t["out_node"], t["o"], t["d"], cap)


def _sig(lib, name: str, argtypes: list) -> None:
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int


def earlier_outputs(cap: int, dev) -> tuple:
    """compact_a_warp's eight [cap] outputs: t, dt, node, rid, ok, trans,
    pts01, dirs."""
    f32, i32 = dict(dtype=torch.float32, device=dev), dict(dtype=torch.int32, device=dev)
    return (torch.empty((cap,), **f32), torch.empty((cap,), **f32), torch.empty((cap,), **i32),
            torch.empty((cap,), **i32), torch.empty((cap,), dtype=torch.bool, device=dev),
            torch.empty((cap,), **i32), torch.empty((cap, 3), **f32), torch.empty((cap, 3), **f32))


def earlier_compact_a(lib, tree, n_s, out_t, out_dt, out_node, o, d, cap):
    """The earlier f2_compact_a_warp (no offsets output)."""
    dev = n_s.device
    R, max_s = out_t.shape
    outs = earlier_outputs(cap, dev)
    kernels.check(lib.f2_compact_a_warp(
        *(x.data_ptr() for x in (n_s, out_t, out_dt, out_node, o, d, tree.trans_idx,
                                 tree.w2xz, tree.weight, *outs)),
        cap, R, max_s, tree.trans_idx.shape[0], kernels.stream_ptr(dev)), "sweep compact_a_warp")
    return outs


def run_edges(lib, tree, e, coord):
    """f2_sample_edges (the same interface in both trees)."""
    dev = e.device
    n = e.shape[0]
    pts = torch.empty((n, 2, 3), dtype=torch.float32, device=dev)
    trans = torch.empty((n, 2), dtype=torch.int32, device=dev)
    kernels.check(lib.f2_sample_edges(
        *(x.data_ptr() for x in (e, coord, tree.edge_t, tree.edge_center, tree.edge_dir0,
                                 tree.edge_dir1, tree.w2xz, tree.weight, pts, trans)),
        n, tree.edge_t.shape[0], tree.w2xz.shape[0], kernels.stream_ptr(dev)),
        "sweep sample_edges")
    return pts, trans


def earlier_votes(lib, tree, node, rid, w, a, n_rays):
    """The earlier f2_occupancy_votes (no offsets input: it searches rid)."""
    N = tree.trans_idx.shape[0]
    out = torch.empty((4, N), dtype=torch.int32, device=node.device)
    kernels.check(lib.f2_occupancy_votes(
        *(x.data_ptr() for x in (node, rid, w, a)), *(out[k].data_ptr() for k in range(4)),
        node.shape[0], n_rays, N, kernels.stream_ptr(node.device)), "sweep occupancy_votes")
    return out


def same_bits(got, want) -> bool:
    return all(torch.equal(bits(g), bits(w)) for g, w in zip(got, want))


def new_compact_a(lib, tree, n_s, out_t, out_dt, out_node, o, d, cap):
    """This tree's f2_compact_a_warp (offsets [R + 1] out)."""
    dev = n_s.device
    R = out_t.shape[0]
    outs = earlier_outputs(cap, dev) + (torch.empty((R + 1,), dtype=torch.int32, device=dev),)
    kernels.check(lib.f2_compact_a_warp(
        *(x.data_ptr() for x in (n_s, out_t, out_dt, out_node, o, d, tree.trans_idx,
                                 tree.w2xz, tree.weight, *outs)),
        cap, R, out_t.shape[1], tree.trans_idx.shape[0], kernels.stream_ptr(dev)),
        "sweep compact_a_warp")
    return outs


def new_votes(lib, tree, node, rid, w, a, n_rays, offsets):
    """This tree's f2_occupancy_votes (the buffer's offsets in)."""
    N = tree.trans_idx.shape[0]
    out = torch.empty((4, N), dtype=torch.int32, device=node.device)
    kernels.check(lib.f2_occupancy_votes(
        *(x.data_ptr() for x in (node, w, a, offsets)), *(out[k].data_ptr() for k in range(4)),
        node.shape[0], n_rays, N, kernels.stream_ptr(node.device)), "sweep occupancy_votes")
    return out


def _held(tag: str, name: str, got, want, equal: dict) -> None:
    torch.cuda.synchronize()
    equal[name] = same_bits(got, want)
    if "diag" not in name and not equal[name]:
        raise AssertionError(f"{tag} {name} differs from the plain version")


def sweep_k12(baseline: str | None) -> dict:
    """K12's two entry points at the slice step's shapes: this tree's
    kernel and its variants, and with --baseline the earlier kernel and its
    diagnostic variants, each entry point's all timed in turns."""
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs = build("warp", WARP_VARIANTS)
    for lib in libs.values():
        _sig(lib, "f2_compact_a_warp", [vp] * 18 + [ll, i, i, i, vp])
        _sig(lib, "f2_sample_edges", [vp] * 10 + [i, i, i, vp])
    old = {}
    if baseline:
        old = build("warp", EARLIER_WARP_VARIANTS, os.path.join(baseline, "f2nerf_torch", "csrc"),
                    "earlier_")
        for lib in old.values():
            _sig(lib, "f2_compact_a_warp", [vp] * 17 + [ll, i, i, i, vp])
            _sig(lib, "f2_sample_edges", [vp] * 10 + [i, i, i, vp])
    from f2nerf_torch.render import renderer as rd
    from f2nerf_torch.sampler import device as dv
    tree, _ = slice_tree()
    ins = step_warp_inputs(tree)
    res = {}
    for case, args in (("step", ins["a"]), ("uniform", uniform_a(tree))):
        a, rid, ok, offsets = rd.compact_a_warp_plain(*args)
        want = (a["t"], a["dt"], a["node"], rid, ok, a["trans"], a["pts01"], a["dirs"])
        fns, equal = {}, {}
        for name in WARP_A_NAMES:
            _held("K12 compact_a_warp", name, new_compact_a(libs[name], *args),
                  want + (offsets,), equal)
            fns[name] = lambda lib=libs[name], args=args: new_compact_a(lib, *args)
        for name in EARLIER_A_NAMES if old else ():
            _held("K12 compact_a_warp", f"earlier_{name}", earlier_compact_a(old[name], *args), want,
                  equal)
            fns[f"earlier_{name}"] = lambda lib=old[name], args=args: earlier_compact_a(lib, *args)
        t = in_turns(fns)
        res[f"compact_a_warp_{case}"] = dict(ms=t, equal=equal)
        log(f"[K12 A] {case} (R {args[1].shape[0]}, cap1 {args[-1]}, {int(offsets[-1])} valid): "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in t.items()) + f"; bit for bit {equal}")
    want = dv.sample_edges_plain(*ins["edges"])
    fns, equal = {}, {}
    for name in WARP_EDGE_NAMES:
        _held("K12 sample_edges", name, run_edges(libs[name], *ins["edges"]), want, equal)
        fns[name] = lambda lib=libs[name]: run_edges(lib, *ins["edges"])
    for name in EARLIER_EDGE_NAMES if old else ():
        _held("K12 sample_edges", f"earlier_{name}", run_edges(old[name], *ins["edges"]), want,
              equal)
        fns[f"earlier_{name}"] = lambda lib=old[name]: run_edges(lib, *ins["edges"])
    t = in_turns(fns)
    res["sample_edges"] = dict(ms=t, equal=equal)
    log(f"[K12 edges] {STEP_EDGES} samples: " + ", ".join(f"{k} {v:.4f} ms" for k, v in t.items())
        + f"; bit for bit {equal}")
    return res


def sweep_k14(baseline: str | None) -> dict:
    """K14's votes at the slice step's shapes (buffer A's offsets given):
    this tree's kernel and its variants, and with --baseline the earlier
    kernel and its diagnostic variants, all timed in turns."""
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs = build("occupancy", VOTES_VARIANTS)
    for lib in libs.values():
        _sig(lib, "f2_occupancy_votes", [vp] * 8 + [ll, i, i, vp])
    old = {}
    if baseline:
        old = build("occupancy", EARLIER_VOTES_VARIANTS,
                    os.path.join(baseline, "f2nerf_torch", "csrc"), "earlier_")
        for lib in old.values():
            _sig(lib, "f2_occupancy_votes", [vp] * 8 + [ll, i, i, vp])
    from f2nerf_torch.render import renderer as rd
    from f2nerf_torch.sampler import device as dv
    tree, _ = slice_tree()
    ins = step_warp_inputs(tree)
    cases = {"step": (ins["votes"], rd.compact_a_warp_plain(*ins["a"])[3]),
             "uniform": uniform_votes(tree)}
    res = {}
    for case, (args, offsets) in cases.items():
        want = dv.compute_occupancy_adders_plain(*args)
        want = [want[k] for k in dv.OCC_VOTES]
        fns, equal = {}, {}
        for name, lib in libs.items():
            _held("K14 votes", name, new_votes(lib, *args, offsets), want, equal)
            fns[name] = lambda lib=lib, args=args, offsets=offsets: new_votes(lib, *args, offsets)
        for name, lib in old.items():
            _held("K14 votes", f"earlier_{name}", earlier_votes(lib, *args), want, equal)
            fns[f"earlier_{name}"] = lambda lib=lib, args=args: earlier_votes(lib, *args)
        t = in_turns(fns)
        res[case] = dict(ms=t, equal=equal)
        log(f"[K14 votes] {case} ({int(offsets[-1])} rows in rays of {args[1].shape[0]}, R "
            f"{args[-1]}, N {tree.trans_idx.shape[0]}): "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in t.items()) + f"; bit for bit {equal}")
    return res


def uniform_votes(tree, R: int = 2048, per: int = 192, cap: int = 393216, seed: int = 14):
    """The votes at the slice's uniform shape (as chip_smoke.py's
    votes_uniform_args): ray r has U[0, 2 per) rows, a tenth of the rays
    none, in runs of 1-8 rows at one of 4,096 of the tree's leaves, a
    twentieth at node -1, padding to cap; and the buffer's offsets."""
    from f2nerf_torch.ops import segment as sg
    rng = np.random.RandomState(seed)
    counts = rng.randint(0, 2 * per, R)
    counts[rng.rand(R) < 0.1] = 0
    rid = np.repeat(np.arange(R), counts)[:cap]
    n = len(rid)
    leaves = np.nonzero(tree.trans_idx.cpu().numpy() >= 0)[0]
    pool = rng.choice(leaves, 4096)
    node = np.repeat(rng.choice(pool, n), rng.randint(1, 9, n))[:n]
    node[rng.rand(n) < 0.05] = -1
    rid = np.concatenate([rid, np.full(cap - n, R)]).astype(np.int32)
    node = np.concatenate([node, np.full(cap - n, -1)]).astype(np.int32)
    w = rng.uniform(0, 0.05, cap).astype(np.float32)
    a = rng.uniform(0, 0.1, cap).astype(np.float32)
    t = [torch.from_numpy(x).cuda() for x in (node, rid, w, a)]
    return (tree, *t, R), sg.ray_offsets_plain(t[1], R)[0]


SWEEPS = {"k8": sweep_k8, "k9": sweep_k9, "k10": sweep_k10, "k11": sweep_k11,
          "offsets": sweep_offsets, "k12": sweep_k12, "k14": sweep_k14}
TAKES_BASELINE = ("k12", "k14")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", default=",".join(SWEEPS),
                    help="comma-separated sweeps to run, of " + ", ".join(SWEEPS))
    ap.add_argument("--out", default=os.path.join(SWEEP_DIR, "sweep_kernels.json"))
    ap.add_argument("--baseline", default=None, metavar="ROOT",
                    help="an earlier tree (a git archive) whose K12 writes no ray offsets: "
                         "the k12 and k14 sweeps also build its csrc/warp.cu and "
                         "csrc/occupancy.cu and time them in the same turns")
    args = ap.parse_args()
    chosen = args.kernels.split(",")
    unknown = [k for k in chosen if k not in SWEEPS]
    if unknown:
        raise SystemExit(f"unknown sweeps {unknown}; choose from {list(SWEEPS)}")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(f"card: {smi}")
    one = torch.zeros(1, device="cuda")
    floor = statistics.median(cuda_ms(lambda: one.add_(0)))
    log(f"[floor] a one-element add: {floor:.4f} ms")
    t0 = time.perf_counter()
    out = dict(card=smi, floor_ms=floor, **{
        k: SWEEPS[k](args.baseline) if k in TAKES_BASELINE else SWEEPS[k]() for k in chosen})
    log(f"[time] {time.perf_counter() - t0:.1f} s")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
