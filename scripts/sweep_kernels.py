"""Sweep the launch shapes and variants of K3, K6, K8-K14 (K14: the votes)
and the offsets launch, time K15 against its plain route, and show what
their time is made of, on one CUDA card.

    python scripts/sweep_kernels.py [--kernels k3,k6,k8,k9,k10,k11,offsets,k12,k13,k14,k15]
        [--baseline ROOT] [--out results.json]

Each variant is a copy of a source in f2nerf_torch/csrc/ (hash_block.cu,
hash3d.cu, traverse.cu, march_parallel.cu, segment.cu, warp.cu, compact.cu or
occupancy.cu) with a few text edits, built alone with nvcc (the package's
flags) into a library of its own under f2nerf_torch/_build/sweep/, and
timed on the same inputs as the unedited kernel, in turns (CUDA events
after ~1 ms of a busy stream, median). Variants that keep the kernel's
function are held to the unedited kernel's outputs bit for bit (K10's,
which add in another order, to the plain version within 1e-5 of each
ray's sum of |x|; K3's, K6's, K12's and K14's to their plain versions,
K3's at the variant's window, K6's at its chunk); diagnostic ones (``diag``) change the arithmetic or
drop work to show what that work costs, and are only timed. The k13
sweep times K13 (``K13_VARIANTS``: 2, 4 and 8 rows a thread, 2 or 4 rows'
loads in flight, tiles from a ticket instead of the block index, padding
blocks of 1,024-4,096 slots; diagnostics without the copies, the padding,
the segments, and with only the loads, scans, look-back and waits). The
k3 sweep times K3 (``K3_VARIANTS``: windows of 32, 64 and 128 positions,
2 or 4 windows a block, sort tiles of 2,048, the finish with 4 or 8 loads
in flight; diagnostics: the keys alone, the keys and the
sort, no stores, the dense write alone, the samples read in position
order, no walk) at a slice step's own call, the uniform shape and the skewed one,
prints the step's active pairs a row by level and times the library call
(index_add_ of the prebuilt dense rows, deterministic). The k6
sweep times K6 (``K6_VARIANTS``: reduce chunks of 1,024, 2,048 and 4,096
records; diagnostics: the counts and their scan alone, without the
reduce, the scatter without its stores) at variants (a)'s step's own call (the reference-semantics
config after 20 steps), the uniform shape, the skewed one and
log2_table_size 20 (chip_smoke's k6_args), its launches' device ms, the
library call (chip_smoke.k6_library_ms), and with ``--baseline ROOT`` (an
earlier tree whose K6 adds with atomics, e.g. a ``git archive`` of it)
ROOT's K6 with the zero-fill its wrapper did (chip_smoke.baseline_k6), in
turns.

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
slots at random leaves; votes: ``uniform_votes``); K13 on the step's buffer
A (``step_keep_inputs``: those 262,144 slots, 97% of the valid ones kept,
cap2 262,144) and at the slice's uniform shape (393,216 rows of 2,048 rays,
half kept, cap2 262,144). The k15 sweep times K15 (``sample_rays`` at 512
and 2,048 draws, ``pixel_to_ray`` over one 756x1008 image) on a scene
shaped as the benchmark's (``rays_scene``), bit for bit against the plain
route, whose device ms is the sum of its launches (torch.profiler) and
whose host ms a call it prints beside. A one-element torch add is timed
the same way: the floor of a launch.
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
# K13 (csrc/compact.cu): its launch shapes and diagnostics (the designs it
# replaced are in PERF.md §6)
K13_ROWS = "constexpr int kRows = 4;"
K13_COPY = "constexpr int kCopy = kRows < 4 ? kRows : 4;"
K13_PAD = "constexpr int kPadSlots = kThreads * 8;"
K13_N_COPY = "  const int n_copy = (int)max(0LL, min((long long)cnt, cap - excl));"
K13_STARTS = "    if ((starts >> k) & 1u) {"
K13_LOCAL = "    if (kept[k] && kk < cap) {"
K13_VARIANTS = {
    "base": [],
    "rows2": [(K13_ROWS, "constexpr int kRows = 2;")],
    "rows8": [(K13_ROWS, "constexpr int kRows = 8;")],
    "copy2": [(K13_COPY, "constexpr int kCopy = 2;")],
    # a block's tile or padding range from a ticket taken as it starts (one
    # atomic on the state's unused word a block), not its index
    "ticket": [("  const unsigned b = blockIdx.x;\n",
                "  __shared__ unsigned s_b;\n  if (threadIdx.x == 0) s_b = atomicAdd(p.counters, 1u);"
                "\n  __syncthreads();\n  const unsigned b = s_b;\n"),
               ("      p.counters[1] = 0;", "      p.counters[0] = 0;\n      p.counters[1] = 0;")],
    "pad1024": [(K13_PAD, "constexpr int kPadSlots = kThreads * 4;")],
    "pad4096": [(K13_PAD, "constexpr int kPadSlots = kThreads * 16;")],
    "diag_no_copy": [(K13_N_COPY, "  const int n_copy = 0;")],
    "diag_no_pad": [("  const long long lo = max(s0, m);", "  const long long lo = s1;")],
    "diag_no_segments": [(K13_STARTS, K13_STARTS.replace(" {", " if (p.n < 0) {")),
                         (K13_LOCAL, K13_LOCAL.replace(") {", " && p.n < 0) {"))],
    # the tiles' loads, scans and look-back, the padding blocks' waits
    "diag_skeleton": [(K13_N_COPY, "  const int n_copy = 0;"),
                      (K13_STARTS, K13_STARTS.replace(" {", " if (p.n < 0) {")),
                      (K13_LOCAL, K13_LOCAL.replace(") {", " && p.n < 0) {")),
                      ("  const long long lo = max(s0, m);", "  const long long lo = s1;")],
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
# K3 (csrc/hash_block.cu): the window (the reduce block sized so that its
# staged entries fit 48 KB of shared memory; a window other than 64 is
# another order, held to the plain version at that window), 2 windows a
# block, sort tiles of 2,048 records, the finish with 4 or 8 loads in
# flight, and diagnostics: the keys launch alone, the keys and the sort, the
# call with the reduce storing nothing and no finish, the dense write
# alone (the finish storing every row as zeros), the reduce reading its
# entries' samples in position order instead of by their index (what
# keeping the samples' data in the sorted list could save), and the reduce
# without its walk (its loads, locates and staging)
K3_WINDOW = "constexpr int kWindow = 64;"
K3_WARPS = "constexpr int kReduceWarps = 4;"
K3_TILE = "constexpr int kSortTile = 4096;"
K3_IN_FLIGHT = "constexpr int kInFlight = 16;"
K3_KEYED = "  // keyed: sort each level's pairs by row, low digit then high digit\n"
K3_BUCKETED = "  // bucketed: the windows, then the rows\n"
K3_STORE = "    *reinterpret_cast<float4*>(out) = acc;"
K3_GATHER = "    idx[j] = k < cnt ? si[k] : -1;"
K3_WALK = "    for (int kk = k; kk < e; ++kk) {"


def k3_window(w: int, warps: int) -> list:
    return [(K3_WINDOW, f"constexpr int kWindow = {w};"),
            (K3_WARPS, f"constexpr int kReduceWarps = {warps};")]


K3_VARIANTS = {
    "base": [],
    "window32": k3_window(32, 8),
    "window128": k3_window(128, 2),
    "warps2": [(K3_WARPS, "constexpr int kReduceWarps = 2;")],
    "tile2048": [(K3_TILE, "constexpr int kSortTile = 2048;")],
    "finish4": [(K3_IN_FLIGHT, "constexpr int kInFlight = 4;")],
    "finish8": [(K3_IN_FLIGHT, "constexpr int kInFlight = 8;")],
    "diag_keys": [(K3_KEYED, "  return 0;\n")],
    "diag_keys_sort": [(K3_BUCKETED, "  return 0;\n")],
    "diag_no_store": [(K3_STORE, "    if (acc.x == 1234.5f) " + K3_STORE.strip()),
                      ("  k3_finish_kernel<<<", "  if (0) k3_finish_kernel<<<")],
    "diag_dense_write": [(f"  k3_{k}_kernel<<<", f"  if (0) k3_{k}_kernel<<<")
                         for k in ("keys", "hist", "scan", "scatter", "reduce")],
    "diag_no_gather": [(K3_GATHER, "    idx[j] = k < cnt ? (int)((p0 + k) % s.n) : -1;")],
    "diag_no_walk": [(K3_WALK, K3_WALK.replace("kk = k;", "kk = e;"))],
}
K3_WINDOWS = {"base": 64, "window32": 32, "window128": 128, "warps2": 64, "tile2048": 64,
              "finish4": 64, "finish8": 64}

K6_CHUNK = "constexpr int kChunk = 2048;"
K6_WRITE = "      out[S.base[e >> lo] + j] = make_uint4("
K6_VARIANTS = {
    "base": [],
    "chunk1024": [(K6_CHUNK, "constexpr int kChunk = 1024;")],
    "chunk4096": [(K6_CHUNK, "constexpr int kChunk = 4096;")],
    "diag_counts": [(f"  k6_{k}_kernel<<<", f"  if (0) k6_{k}_kernel<<<")
                    for k in ("scatter", "reduce")],
    "diag_no_reduce": [("  k6_reduce_kernel<<<", "  if (0) k6_reduce_kernel<<<")],
    "diag_no_write": [(K6_WRITE, "      if (j < 0) " + K6_WRITE.lstrip())],
}
K6_CHUNKS = {"base": 2048, "chunk1024": 1024, "chunk4096": 4096}


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
        lib.f2_ray_offsets.argtypes = [vp] * 5 + [ll, i, i, vp]
        lib.f2_ray_offsets.restype = ctypes.c_int
    dev = torch.device("cuda")

    def run(name, rid, given=None):
        n = rid.shape[0]
        outs = (torch.empty((2049,), dtype=torch.int32, device=dev) if given is None else given,
                torch.empty((2048,), device=dev), torch.empty((n,), dtype=torch.int32, device=dev),
                torch.empty((n,), dtype=torch.bool, device=dev))
        kernels.check(libs[name].f2_ray_offsets(
            rid.data_ptr(), *(o.data_ptr() for o in outs), n, 2048, int(given is not None),
            kernels.stream_ptr(dev)), "sweep ray_offsets")
        return outs

    res = {}
    for case, r in step_like_ray_ids().items():
        rid_d = torch.from_numpy(r.astype(np.int32)).to(dev)
        want = sg.ray_offsets_plain(rid_d, 2048)
        given = want[0].clone()
        for name in libs:
            for got in (run(name, rid_d), run(name, rid_d, given)):
                torch.cuda.synchronize()
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise AssertionError(f"ray_offsets {name} differs from its plain version "
                                         f"({case})")
        fns = {name: (lambda name=name: run(name, rid_d)) for name in libs}
        fns["offsets_given"] = lambda: run("offsets_base", rid_d, given)
        t = in_turns(fns)
        res[case] = t
        log(f"[offsets] {case}: " + ", ".join(f"{k[8:]} {v:.4f} ms" for k, v in t.items()))
    return res


def step_keep_inputs(tree, seed: int = 17) -> tuple:
    """K13's input at the slice step's shapes: buffer A as the plain K12
    makes it from ``step_warp_inputs`` (cap1 262,144 slots, STEP_VALID
    valid), each valid slot kept with probability 0.97 (a step early in
    training keeps ~97% of its samples), cap2 262,144."""
    from f2nerf_torch.render import renderer as rd
    a, rid, ok = rd.compact_a_warp_plain(*step_warp_inputs(tree)["a"])[:3]
    g = torch.Generator(device=rid.device).manual_seed(seed)
    keep = ok & (torch.rand(ok.shape, generator=g, device=ok.device) < 0.97)
    return keep, 262144, {k: a[k] for k, _, _ in rd.KEEP_FIELDS}, rid, STEP_RAYS


def uniform_keep(seed: int = 18, n: int = 393216, cap: int = 262144, R: int = 2048) -> tuple:
    """K13 at the slice's uniform shape (as chip_smoke.py's
    keep_uniform_args): R rays of U[0, 2 n / R) rows, padding past the
    last, each row kept with probability one half."""
    from f2nerf_torch.render import renderer as rd
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    counts = torch.randint(0, 2 * n // R, (R,), generator=g, device=dev)
    rid = torch.repeat_interleave(torch.arange(R, device=dev), counts)[:n]
    rid = torch.cat([rid, torch.full((n - rid.numel(),), R, device=dev)]).to(torch.int32)
    fields = {k: (torch.rand((n,) if c == 1 else (n, c), generator=g, device=dev)
                  if dt == torch.float32 else
                  torch.randint(0, 1 << 16, (n,), generator=g, device=dev, dtype=dt))
              for k, dt, c in rd.KEEP_FIELDS}
    keep = (torch.rand((n,), generator=g, device=dev) < 0.5) & (rid < R)
    return keep, cap, fields, rid, R


def keep_outputs(cap: int, n_rays: int, dev) -> list:
    """K13's outputs: the six fields, rid, ok, idx, offsets, counts, local
    and first."""
    from f2nerf_torch.render import renderer as rd
    outs = [torch.empty((cap,) if c == 1 else (cap, c), dtype=dt, device=dev)
            for _, dt, c in rd.KEEP_FIELDS]
    return outs + [torch.empty((cap,), dtype=torch.int32, device=dev),
                   torch.empty((cap,), dtype=torch.bool, device=dev),
                   torch.empty((cap,), dtype=torch.int64, device=dev),
                   torch.empty((n_rays + 1,), dtype=torch.int32, device=dev),
                   torch.empty((n_rays,), dtype=torch.float32, device=dev),
                   torch.empty((cap,), dtype=torch.int32, device=dev),
                   torch.empty((cap,), dtype=torch.bool, device=dev)]


_K13_STATES: dict = {}


def new_keep(lib, keep, cap, fields, rid, n_rays):
    """This tree's f2_compact_keep (B's segments out; its zeroed state)."""
    from f2nerf_torch.ops import segment as sg
    from f2nerf_torch.render import renderer as rd
    dev = keep.device
    outs = keep_outputs(cap, n_rays, dev)
    stream = kernels.stream_ptr(dev)
    state = sg.zeroed_state(_K13_STATES, dev, stream, lib.f2_compact_keep_state_bytes(
        keep.shape[0]))
    ins = (keep, *(fields[k] for k, _, _ in rd.KEEP_FIELDS), rid)
    kernels.check(lib.f2_compact_keep(*(x.data_ptr() for x in (*ins, *outs, state)),
                                      keep.shape[0], cap, n_rays, stream), "sweep compact_keep")
    return outs


def sweep_k13() -> dict:
    """K13 at the slice step's shapes and the uniform one: this tree's
    launch shapes and diagnostics, timed in turns. Every non-diagnostic run
    is held bit for bit to the plain version."""
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs = build("compact", K13_VARIANTS)
    for lib in libs.values():
        _sig(lib, "f2_compact_keep", [vp] * 22 + [ll, ll, i, vp])
        lib.f2_compact_keep_state_bytes.argtypes = [ll]
        lib.f2_compact_keep_state_bytes.restype = ll
    from f2nerf_torch.render import renderer as rd
    tree, _ = slice_tree()
    res = {}
    for case, args in (("step", step_keep_inputs(tree)), ("uniform", uniform_keep())):
        b, rid, ok, idx, seg = rd.compact_keep_plain(*args)
        want = [b[k] for k, _, _ in rd.KEEP_FIELDS] + [rid, ok, idx, *seg]
        fns, equal = {}, {}
        for name, lib in libs.items():
            _held("K13", name, new_keep(lib, *args), want, equal)
            fns[name] = lambda lib=lib, args=args: new_keep(lib, *args)
        t = in_turns(fns)
        kept = int(args[0].sum())
        res[case] = dict(ms=t, equal=equal, n=int(args[0].shape[0]), cap=args[1], kept=kept)
        log(f"[K13] {case} (n {args[0].shape[0]}, cap {args[1]}, {kept} kept, R {args[4]}): "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in t.items()) + f"; bit for bit {equal}")
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


def a_outputs(cap: int, dev) -> tuple:
    """compact_a_warp's eight [cap] outputs: t, dt, node, rid, ok, trans,
    pts01, dirs."""
    f32, i32 = dict(dtype=torch.float32, device=dev), dict(dtype=torch.int32, device=dev)
    return (torch.empty((cap,), **f32), torch.empty((cap,), **f32), torch.empty((cap,), **i32),
            torch.empty((cap,), **i32), torch.empty((cap,), dtype=torch.bool, device=dev),
            torch.empty((cap,), **i32), torch.empty((cap, 3), **f32), torch.empty((cap, 3), **f32))


def run_edges(lib, tree, e, coord):
    """f2_sample_edges."""
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


def same_bits(got, want) -> bool:
    return all(torch.equal(bits(g), bits(w)) for g, w in zip(got, want))


def new_compact_a(lib, tree, n_s, out_t, out_dt, out_node, o, d, cap):
    """This tree's f2_compact_a_warp (offsets [R + 1] out)."""
    dev = n_s.device
    R = out_t.shape[0]
    outs = a_outputs(cap, dev) + (torch.empty((R + 1,), dtype=torch.int32, device=dev),)
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


def sweep_k12() -> dict:
    """K12's two entry points at the slice step's shapes: the kernel and
    its variants, each entry point's all timed in turns."""
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs = build("warp", WARP_VARIANTS)
    for lib in libs.values():
        _sig(lib, "f2_compact_a_warp", [vp] * 18 + [ll, i, i, i, vp])
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
        t = in_turns(fns)
        res[f"compact_a_warp_{case}"] = dict(ms=t, equal=equal)
        log(f"[K12 A] {case} (R {args[1].shape[0]}, cap1 {args[-1]}, {int(offsets[-1])} valid): "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in t.items()) + f"; bit for bit {equal}")
    want = dv.sample_edges_plain(*ins["edges"])
    fns, equal = {}, {}
    for name in WARP_EDGE_NAMES:
        _held("K12 sample_edges", name, run_edges(libs[name], *ins["edges"]), want, equal)
        fns[name] = lambda lib=libs[name]: run_edges(lib, *ins["edges"])
    t = in_turns(fns)
    res["sample_edges"] = dict(ms=t, equal=equal)
    log(f"[K12 edges] {STEP_EDGES} samples: " + ", ".join(f"{k} {v:.4f} ms" for k, v in t.items())
        + f"; bit for bit {equal}")
    return res


def sweep_k14() -> dict:
    """K14's votes at the slice step's shapes (buffer A's offsets given):
    the kernel and its variants, all timed in turns."""
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs = build("occupancy", VOTES_VARIANTS)
    for lib in libs.values():
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


def device_breakdown(fn, reps: int = 10) -> dict:
    """Device milliseconds a call of fn, by activity name (kernels,
    memsets), over reps calls after a warm-up (torch.profiler; a later
    profiler session in a process may miss events, so this is printed, not
    held)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            name = e.name.replace("(anonymous namespace)::", "").split("(")[0].strip()
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    return out


def k3_run(lib, g, prim, bias, pts, vol, l2t, shape):
    """A built f2_hash_block_bwd on hash_block_bwd's arguments."""
    from f2nerf_torch.fields import hash_block as hb
    from f2nerf_torch.fields.hash_encoding import _scales
    segs = [(gk.contiguous(), pk.contiguous(), vk.contiguous())
            for gk, pk, vk in zip(hb._segments(g), hb._segments(pts), hb._segments(vol))]
    ptrs = [(gk.data_ptr(), pk.data_ptr(), vk.data_ptr(), vk.shape[0])
            for gk, pk, vk in segs] + [(None, None, None, 0)]
    n, nb = sum(p[3] for p in ptrs), hb.n_blocks(l2t)
    dev = segs[0][0].device
    d = torch.empty(shape, dtype=torch.float32, device=dev)
    scratch = torch.empty((lib.f2_hash_block_bwd_scratch_bytes(n, nb),), dtype=torch.uint8,
                          device=dev)
    kernels.check(lib.f2_hash_block_bwd(*ptrs[0], *ptrs[1], prim.data_ptr(), bias.data_ptr(),
                                        _scales(str(dev)).data_ptr(), d.data_ptr(),
                                        scratch.data_ptr(), prim.shape[1], nb,
                                        kernels.stream_ptr(dev)), "sweep hash_block_bwd")
    return d


def step_k3_inputs() -> tuple:
    """K3's call at a slice step (confs/wanjinyou.yaml at full width on the
    ball scene, after 20 steps): B at cap2 plus the edge samples, with the
    step's own gradient (chip_smoke.capture_calls)."""
    import chip_smoke as cs
    from f2nerf_torch.fields import hash_block as hb
    from f2nerf_torch.train.trainer import Trainer
    from f2nerf_torch.utils.config import compose
    from f2nerf_torch.utils.synthetic import write_ball_dataset
    tmp = tempfile.mkdtemp(prefix="f2sweep_")
    cfg = compose(os.path.join(REPO, "confs"), "wanjinyou", ["+train.fused_adam=true"])
    tr = Trainer(cfg, os.path.join(tmp, "exp"), write_ball_dataset(os.path.join(tmp, "ball")),
                 seed=2022, device="cuda")
    for _ in range(20):
        tr.train_one()
    (args,) = cs.capture_calls(tr, {"hash_block_bwd": hb})["hash_block_bwd"]
    return args


def sweep_k3() -> dict:
    """K3 at the slice step's own call, the uniform shape and the skewed
    one (chip_smoke's k3_uniform_args, k3_skew_args): the active pairs a
    row by level at the step, the windows and the diagnostics
    (``K3_VARIANTS``) and the library call (chip_smoke.k3_library_ms), all
    timed in turns. The variants that keep the function are held bit for
    bit to the plain version at their window, and to a second run."""
    import chip_smoke as cs
    from f2nerf_torch.fields import hash_block as hb
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs = build("hash_block", K3_VARIANTS)
    for lib in libs.values():
        _sig(lib, "f2_hash_block_bwd", [vp, vp, vp, i, vp, vp, vp, i] + [vp] * 5 + [i, i, vp])
        lib.f2_hash_block_bwd_scratch_bytes.argtypes = [ll, i]
        lib.f2_hash_block_bwd_scratch_bytes.restype = ll
    gen = torch.Generator(device="cuda").manual_seed(3)
    step = step_k3_inputs()
    hist = cs.k3_rows_histogram([step])
    log("[K3] active pairs a row at the slice step, by level (pairs, rows, median, p99, max): "
        + "; ".join(f"{l}: {h['pairs']}, {h['rows']}, {h['median']:g}, {h['p99']:g}, "
                    f"{h['max']}" for l, h in hist.items()))
    res = {"histogram": hist}
    for case, args in (("step", step), ("uniform", cs.k3_uniform_args(gen)),
                       ("skew", cs.k3_skew_args(gen))):
        want = {w: hb.hash_block_bwd_plain(*args, window=w) for w in set(K3_WINDOWS.values())}
        fns, equal = {}, {}
        for name, lib in libs.items():
            got = k3_run(lib, *args)
            if name in K3_WINDOWS:
                equal[name] = (same_bits([got], [want[K3_WINDOWS[name]]])
                               and same_bits([k3_run(lib, *args)], [got]))
                if not equal[name]:
                    raise AssertionError(f"K3 {name} ({case}) differs from the plain version "
                                         f"at window {K3_WINDOWS[name]} or from its repeat")
            fns[name] = lambda lib=lib, args=args: k3_run(lib, *args)
        del want
        t = in_turns(fns)
        lib_ms = cs.k3_library_ms([args]) if case != "skew" else None
        parts = device_breakdown(fns["base"])
        res[case] = dict(ms=t, equal=equal, library_ms=lib_ms, base_launches_ms=parts)
        log(f"[K3] {case}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in t.items())
            + f"; library index_add_ {lib_ms}; bit for bit {equal}; base by launch: "
            + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()))
        torch.cuda.empty_cache()
    return res


def k6_run(lib, g, prim, bias, pts, vol, l2t, pool):
    """A built f2_hash3d_bwd on hash_encode_bwd's arguments."""
    from f2nerf_torch.fields.hash_encoding import N_CHANNELS, _scales, local_size
    g, pts, vol = g.contiguous(), pts.contiguous(), vol.contiguous()
    n, dev = pts.shape[0], pts.device
    d = torch.empty((pool, N_CHANNELS), dtype=torch.float32, device=dev)
    scratch = torch.empty((lib.f2_hash3d_bwd_scratch_bytes(n),), dtype=torch.uint8, device=dev)
    kernels.check(lib.f2_hash3d_bwd(g.data_ptr(), prim.data_ptr(), bias.data_ptr(),
                                    _scales(str(dev)).data_ptr(), pts.data_ptr(),
                                    vol.data_ptr(), d.data_ptr(), scratch.data_ptr(), n,
                                    prim.shape[1], local_size(l2t), kernels.stream_ptr(dev)),
                  "sweep hash_encode_bwd")
    return d


def step_k6_inputs() -> tuple:
    """K6's call at variants (a)'s step (confs/wanjinyou.yaml with
    chip_smoke's REF_OVERRIDES at full width on the ball scene, after 20
    steps): B at cap2 plus the edge samples, with the step's own gradient
    (chip_smoke.capture_calls)."""
    import chip_smoke as cs
    from f2nerf_torch.fields import hash_encoding as he
    from f2nerf_torch.train.trainer import Trainer
    from f2nerf_torch.utils.synthetic import write_ball_dataset
    tmp = tempfile.mkdtemp(prefix="f2sweep_")
    tr = Trainer(cs._compose(cs.REF_OVERRIDES), os.path.join(tmp, "exp"),
                 write_ball_dataset(os.path.join(tmp, "ball")), seed=2022, device="cuda")
    for _ in range(20):
        tr.train_one()
    (args,) = cs.capture_calls(tr, {"hash_encode_bwd": he})["hash_encode_bwd"]
    return args


def sweep_k6(baseline: str | None) -> dict:
    """K6 at variants (a)'s step's own call, the uniform shape, the skewed
    one and log2_table_size 20 (chip_smoke's k6_args): the chunks and the
    diagnostics (``K6_VARIANTS``), each launch's device ms, the library
    call (chip_smoke.k6_library_ms), and with --baseline ROOT's K6 with its
    zero-fill (chip_smoke.baseline_k6), all timed in turns. The variants
    that keep the function are held bit for bit to the plain version at
    their chunk, and to a second run."""
    import chip_smoke as cs
    from f2nerf_torch.fields import hash_encoding as he
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs = build("hash3d", K6_VARIANTS)
    for lib in libs.values():
        _sig(lib, "f2_hash3d_bwd", [vp] * 8 + [ll, i, i, vp])
        lib.f2_hash3d_bwd_scratch_bytes.argtypes = [ll]
        lib.f2_hash3d_bwd_scratch_bytes.restype = ll
    old = cs.baseline_k6(baseline) if baseline else None
    gen = torch.Generator(device="cuda").manual_seed(3)
    res = {}
    for case, make in (("step", step_k6_inputs), ("uniform", lambda: cs.k6_args(gen)),
                       ("skew", lambda: cs.k6_args(gen, n=1 << 18, skew=True)),
                       ("l2t20", lambda: cs.k6_args(gen, l2t=20))):
        args = make()
        fns, equal = {}, {}
        for name, lib in libs.items():
            got = k6_run(lib, *args)
            if name in K6_CHUNKS:
                want = he.hash_encode_bwd_plain(*args, chunk=K6_CHUNKS[name])
                equal[name] = (same_bits([got], [want])
                               and same_bits([k6_run(lib, *args)], [got]))
                del want
                if not equal[name]:
                    raise AssertionError(f"K6 {name} ({case}) differs from the plain version "
                                         f"at chunk {K6_CHUNKS[name]} or from its repeat")
            del got
            fns[name] = lambda lib=lib, args=args: k6_run(lib, *args)
        if old is not None:
            fns["baseline_with_zero_fill"] = lambda args=args: old(*args)
        t = in_turns(fns)
        lib_ms = cs.k6_library_ms(args)
        parts = device_breakdown(fns["base"])
        res[case] = dict(ms=t, equal=equal, library_ms=lib_ms, base_launches_ms=parts)
        log(f"[K6] {case} (n={args[3].shape[0]}, log2_table_size {args[5]}): "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in t.items())
            + f"; library index_add_ {lib_ms:.4f}; bit for bit {equal}; base by launch: "
            + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()))
        del args, fns
        torch.cuda.empty_cache()
    return res


K15_CAM_BYTES = 4 + 48 + 36 + 16 + 8  # a camera's train id, pose, intrinsics, distortion, bounds


def rays_scene(seed: int = 15, n_cams: int = 24, h: int = 756, w: int = 1008) -> dict:
    """Camera tables and train images shaped as the benchmark's scene (24
    cameras at 756x1008, every eighth a test camera), distorted, on the
    card."""
    rng = np.random.RandomState(seed)
    rot = np.linalg.qr(rng.randn(n_cams, 3, 3))[0]
    poses = np.concatenate([rot, rng.randn(n_cams, 3, 1)], axis=2)
    intri = np.zeros((n_cams, 3, 3))
    intri[:, 0, 0], intri[:, 1, 1] = rng.uniform(700, 900, n_cams), rng.uniform(700, 900, n_cams)
    intri[:, 0, 2], intri[:, 1, 2], intri[:, 2, 2] = w / 2, h / 2, 1.0
    dist = np.array([0.05, -0.01, 0.001, -0.002]) * rng.uniform(0.5, 2.0, (n_cams, 4))
    bounds = np.stack([rng.uniform(0.01, 0.5, n_cams), rng.uniform(2, 9, n_cams)], -1)
    ids = np.nonzero(np.arange(n_cams) % 8 != 0)[0].astype(np.int32)
    images = rng.randint(0, 256, (len(ids), h, w, 3)).astype(np.uint8)
    out = dict(poses=poses, intri=intri, dist=dist, bounds=bounds)
    out = {k: torch.from_numpy(v.astype(np.float32)).cuda() for k, v in out.items()}
    out.update(train_ids=torch.from_numpy(ids).cuda(), train_images=torch.from_numpy(images).cuda())
    return out


def sweep_k15() -> dict:
    """K15 at the step's 512 rays, at 2,048, and over one full 756x1008
    image (the one-camera form, as camera_rays calls it), against the plain
    route on the card (its device ms summed over its launches, its launches
    and its host ms a call) and the bytes bound (a ray's draws in, 3 image
    bytes in and 48 bytes out, each camera's rows once; the image: the f32
    pixel in and the rays out)."""
    from f2nerf_torch.core import camera as cam
    from f2nerf_torch.data import dataset as ds
    data = rays_scene()
    h, w = data["train_images"].shape[1:3]
    g = torch.Generator(device="cuda").manual_seed(15)
    res = {}
    for case in ("step_512", "rays_2048", "image_756x1008"):
        if case == "image_756x1008":
            ii, jj = ds._pixel_grid(h, w, 1, "cuda")
            args = (data["poses"][1], data["intri"][1], data["dist"][1], ii, jj)
            k15 = lambda args=args: cam.pixel_to_ray(*args)  # noqa: E731
            plain = lambda args=args: cam.pixel_to_ray_plain(*args)  # noqa: E731
            n = ii.shape[0]
            nbytes = n * (8 + 24) + K15_CAM_BYTES - 12  # the camera without train id, bounds
        else:
            n = int(case.split("_")[1])
            d = ds.draw_rays(data, g, n, h, w)
            args = (data, d["cam_pick"], d["i"], d["j"])
            k15 = lambda args=args: ds.sample_rays(*args)  # noqa: E731
            plain = lambda args=args: ds.sample_rays_plain(*args)  # noqa: E731
            n_cams = int(torch.unique(data["train_ids"][d["cam_pick"]]).numel())
            nbytes = n * (24 + 3 + 48) + n_cams * K15_CAM_BYTES
        equal = all(torch.equal(bits(a.contiguous()), bits(b.contiguous()))
                    for a, b in zip(k15(), plain()))
        ms = statistics.median(cuda_ms(k15))
        dev = {k: device_breakdown(f) for k, f in (("k15", k15), ("plain", plain))}
        host = {}
        for k, f in (("k15", k15), ("plain", plain)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(REPS):
                f()
            torch.cuda.synchronize()
            host[k] = (time.perf_counter() - t0) * 1e3 / REPS
        res[case] = dict(n=n, k15_ms=ms, k15_device_ms=sum(dev["k15"].values()),
                         plain_device_ms=sum(dev["plain"].values()),
                         plain_launches=len(dev["plain"]), k15_call_ms=host["k15"],
                         plain_call_ms=host["plain"], bound_ms=nbytes / 3.35e12 * 1e3,
                         bytes=nbytes, equal=equal)
        r = res[case]
        log(f"[K15] {case} ({n} rays): K15 {ms:.4f} ms (device {r['k15_device_ms']:.4f}), plain "
            f"device {r['plain_device_ms']:.4f} ms over {r['plain_launches']} kernel names; a "
            f"call K15 {host['k15']:.4f} / plain {host['plain']:.4f} ms; bound "
            f"{r['bound_ms']:.5f} ms ({nbytes} bytes); bit for bit {equal}")
    return res


SWEEPS = {"k3": sweep_k3, "k6": sweep_k6, "k8": sweep_k8, "k9": sweep_k9, "k10": sweep_k10, "k11": sweep_k11,
          "offsets": sweep_offsets, "k12": sweep_k12, "k13": sweep_k13, "k14": sweep_k14,
          "k15": sweep_k15}
TAKES_BASELINE = ("k6",)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", default=",".join(SWEEPS),
                    help="comma-separated sweeps to run, of " + ", ".join(SWEEPS))
    ap.add_argument("--out", default=os.path.join(SWEEP_DIR, "sweep_kernels.json"))
    ap.add_argument("--baseline", default=None, metavar="ROOT",
                    help="an earlier tree (a git archive) whose K6 adds with atomics: the "
                         "k6 sweep also builds its csrc/hash3d.cu and times its K6 with the "
                         "zero-fill its wrapper did, in the same turns")
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
