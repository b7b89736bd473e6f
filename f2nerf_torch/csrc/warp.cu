// K12: the per-leaf perspective warp (QueryFrameTransform,
// PersSampler.cu:155-168), in two entry points that share one __device__
// warp:
//
// compact_a_warp: the dense marcher output [R, max_s] becomes flat buffer
// A [cap1], each slot with its world point warped into [-1, 1]^3, and A's
// ray offsets. Replaces f2nerf_tpu/render/renderer.py:96
// (_compact_rowpacked) with the rest of the A side of render (:223-240):
// the ray ends' search, the row gathers, the leaf's row, xyz = o + d t,
// f2nerf_tpu/sampler/device.py:193 (apply_warp) and the pin of padding
// slots. Its port was a chain of ~250 torch launches (apply_warp alone
// launches 9 mul, 9 add and 1 div for each of the 12 projections). Per slot
// j:
//   the owner r = the first ray whose running end (the prefix of n_s)
//   exceeds j; ok = j < the total; src = r * max_s + (j - start_r);
//   t, dt, node = out_*[src] (0 where not ok); rid = r (R where not ok);
//   trans = max(trans_idx[node], 0) (a negative node indexes from the end,
//   as torch's gather does); rc = ok ? r : R - 1;
//   pts01 = ok ? (warp(trans, o[rc] + d[rc] t) + 1) * 0.5 : 0.5;
//   dirs = d[rc];
// and offsets[r] = min(start_r, cap) for r <= R (start_R the total): A's
// offsets as the offsets launch (segment.cu) gives them for rid, so the
// votes (occupancy.cu) read a ray's rows without a search and no launch
// computes them. A block takes kBlockSlots consecutive slots (kSlots a
// thread, kThreads apart, so each store is coalesced) and scans n_s
// itself, kChunkRays rays a pass (int4 loads, a block-wide prefix through
// warp shuffles, the pass's ray ends in shared memory, so any R fits):
// each slot the pass's ends cover finds its owner by a binary search
// there. Block 0 scans every ray and writes the offsets (those of rays
// that start at or past cap too); any other block stops once its last slot
// is owned (a block of padding slots reads all of n_s: 8 KB at the slice's
// 2,048 rays, from L2). Then each slot's gathers, warp and stores.
// At the slice step's shapes (scripts/sweep_kernels.py --kernels k12,
// PERF.md §6) this ran 0.0146 ms against the earlier kernel's 0.0226,
// which scanned in 1,024-ray passes of scalar loads, ran 4 slots a thread
// one after another at 68 registers (2 blocks an SM at the step) and
// loaded and divided the 12 projections one at a time. One scan by block
// 0 and a grid barrier in a cooperative launch, the owners then searched
// in the offsets in L2, ran 0.0195, and with it a warp a ray over its
// slots 0.0208 (the sweep's scan_once variants).
//
// sample_edges: points on leaf-face adjacencies (GetEdgeSamplesKernel,
// PersSampler.cu:436-473), warped into both neighbour frames. Replaces
// f2nerf_tpu/sampler/device.py:649 (sample_edges, whose two apply_warp
// calls were ~460 torch launches in the port). A thread a (sample, frame),
// kEdgeThreads a block, so the slice's 8,192 samples give 256 blocks, every
// SM some (a thread a sample in 32 blocks ran 0.0136 ms against 0.0084 in
// the sweep):
//   e = edge_idx[i]; world = (center[e] + dir0[e] c0) + dir1[e] c1;
//   trans[i, s] = edge_t[e, s], pts[i, s] = warp(edge_t[e, s], world).
// Both threads of a sample compute world with the same rounded operations,
// so the bits are those of one thread doing both frames.
//
// The warp: for the leaf's rows m = w2xz[tr] [96] and w = weight[tr] [36],
// for k = 0..11: a = ((m[8k] x + m[8k+1] y) + m[8k+2] z) + m[8k+3], b the
// same with m[8k+4..7], v = a / b, out[ax] = out[ax] + w[12 ax + k] v from
// 0. The rows are read as float4s (33 a leaf; the wrappers check their
// 16-byte alignment), as K9 reads them, 4 projections a group
// (warp_point). Every operation rounds as the plain version's torch ops
// do, in their order (__fmul_rn / __fadd_rn / __fdiv_rn: nvcc would
// contract a multiply-add into an FMA), so both entry points are bit for
// bit their plain versions on the card, the degenerate warp's inf and NaN
// included.
//
// Bound: bytes. compact_a_warp reads n_s, the valid slots' t, dt, node,
// their rays and the touched leaves' rows once and writes 45 bytes a slot
// and the offsets: ~0.0041 ms at 3.35 TB/s at the slice step (cap1
// 262,144, 146,012 valid slots), ~0.0068 ms at 393,216 uniform slots. The
// warp is ~230 f32 operations a slot, ~0.09 GFLOP at 393,216 slots, 1.4
// us at the card's 67 TFLOP/s f32: under the bytes. sample_edges at 8,192
// samples moves ~0.4 MB (and the touched rows), ~0.0002 ms.
//
// Each entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 3;                   // compact_a_warp: blocks an SM (<= 85 registers)
constexpr int kSlots = 2;                       // compact_a_warp: slots a thread
constexpr int kBlockSlots = kThreads * kSlots;  // slots a block
constexpr int kRayStep = 4;                     // rays a thread in a pass of the scan (int4s)
constexpr int kChunkRays = kThreads * kRayStep; // rays a pass
static_assert(kRayStep % 4 == 0, "a thread's rays of a pass are read as int4s");
constexpr int kEdgeThreads = 64;                // sample_edges: threads a block
constexpr int kPros = 12;
constexpr unsigned kFull = 0xffffffffu;

// ((m0 x0 + m1 x1) + m2 x2) + m3: a or b of one projection
__device__ __forceinline__ float row_dot(const float4 m, const float x[3]) {
  return __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(m.x, x[0]), __fmul_rn(m.y, x[1])), __fmul_rn(m.z, x[2])),
      m.w);
}

__device__ __forceinline__ float lane4(const float4 v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// apply_warp of one point through warp row tr: projection k = 4 kq + kk
// takes w2xz's float4s 2k and 2k + 1 and lane kk of weight's float4 kq of
// each axis (weight[12 ax + k]). A group of 4 projections forms its
// numerators and denominators before its 4 divisions: a division's slow
// path is a branch, which the next projection's loads would not cross, so
// a thread waits on its rows 3 times, not 12 (all 24 at once need ~70
// registers and ran slower: PERF.md §6).
__device__ __forceinline__ void warp_point(const float* __restrict__ w2xz,
                                           const float* __restrict__ weight, long long tr,
                                           const float x[3], float out[3]) {
  const float4* m4 = reinterpret_cast<const float4*>(w2xz + 96LL * tr);
  const float4* w4 = reinterpret_cast<const float4*>(weight + 36LL * tr);
  out[0] = out[1] = out[2] = 0.0f;
#pragma unroll
  for (int kq = 0; kq < kPros / 4; ++kq) {
    float4 w[3];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) w[ax] = __ldg(w4 + 3 * ax + kq);
    float a[4], b[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      a[kk] = row_dot(__ldg(m4 + 8 * kq + 2 * kk), x);
      b[kk] = row_dot(__ldg(m4 + 8 * kq + 2 * kk + 1), x);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float v = __fdiv_rn(a[kk], b[kk]);
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) out[ax] = __fadd_rn(out[ax], __fmul_rn(lane4(w[ax], kk), v));
    }
  }
}

// torch's gather index: a negative index counts from the end
__device__ __forceinline__ long long wrap(long long i, long long n) { return i < 0 ? i + n : i; }

struct CompactA {
  const int* n_s;            // [R]
  const float* out_t;        // [R, max_s]
  const float* out_dt;       // [R, max_s]
  const int* out_node;       // [R, max_s]
  const float* rays_o;       // [R, 3]
  const float* rays_d;       // [R, 3]
  const int* trans_idx;      // [N]
  const float* w2xz;         // [M, 96]
  const float* weight;       // [M, 36]
  float* t;                  // [cap] each
  float* dt;
  int* node;
  int* rid;
  unsigned char* ok;
  int* trans;
  float* pts01;              // [cap, 3]
  float* dirs;               // [cap, 3]
  int* offsets;              // [R + 1]
  long long cap;
  int n_rays;
  int max_s;
  int n_nodes;               // trans_idx's rows
};

// n_s of this thread's kRayStep consecutive rays of the pass at r0 (0 past
// the last ray), as int4s where n_s is 16-byte aligned and the rays are in
// range
__device__ __forceinline__ void load_counts(const CompactA& p, int r0, int v[kRayStep]) {
  const int r = r0 + kRayStep * threadIdx.x;
  if ((reinterpret_cast<uintptr_t>(p.n_s) & 15) == 0 && r + kRayStep <= p.n_rays) {
#pragma unroll
    for (int q = 0; q < kRayStep / 4; ++q) {
      const int4 c = __ldg(reinterpret_cast<const int4*>(p.n_s + r) + q);
      v[4 * q] = c.x;
      v[4 * q + 1] = c.y;
      v[4 * q + 2] = c.z;
      v[4 * q + 3] = c.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kRayStep; ++i) v[i] = r + i < p.n_rays ? __ldg(p.n_s + r + i) : 0;
  }
}

// a valid slot j of ray r, whose first slot is start
__device__ __forceinline__ void valid_slot(const CompactA& p, long long j, int r, int start) {
  // n_s[r] <= max_s: the min never cuts, it keeps a bad n_s in bounds
  const long long s = min((long long)r * p.max_s + (j - start), (long long)p.n_rays * p.max_s - 1);
  const float t = __ldg(p.out_t + s), dt = __ldg(p.out_dt + s);
  const int node = __ldg(p.out_node + s);
  const int tr = max(__ldg(p.trans_idx + wrap(node, p.n_nodes)), 0);
  float x[3], d[3], w[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    d[ax] = __ldg(p.rays_d + 3LL * r + ax);
    x[ax] = __fadd_rn(__ldg(p.rays_o + 3LL * r + ax), __fmul_rn(d[ax], t));
  }
  warp_point(p.w2xz, p.weight, tr, x, w);
  p.t[j] = t;
  p.dt[j] = dt;
  p.node[j] = node;
  p.rid[j] = r;
  p.ok[j] = 1;
  p.trans[j] = tr;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    p.pts01[3 * j + ax] = __fmul_rn(__fadd_rn(w[ax], 1.0f), 0.5f);
    p.dirs[3 * j + ax] = d[ax];
  }
}

// a padding slot: node 0's leaf row, the last ray's direction
__device__ __forceinline__ void pad_slot(const CompactA& p, long long j) {
  const int rc = p.n_rays - 1;
  p.t[j] = 0.0f;
  p.dt[j] = 0.0f;
  p.node[j] = 0;
  p.rid[j] = p.n_rays;
  p.ok[j] = 0;
  p.trans[j] = max(__ldg(p.trans_idx), 0);
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    p.pts01[3 * j + ax] = 0.5f;
    p.dirs[3 * j + ax] = __ldg(p.rays_d + 3LL * rc + ax);
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks) compact_a_warp_kernel(const CompactA p) {
  __shared__ int s_end[kChunkRays];
  __shared__ int s_warp[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool every_ray = blockIdx.x == 0;
  const long long j0 = (long long)blockIdx.x * kBlockSlots + threadIdx.x;
  const long long j_last = (long long)blockIdx.x * kBlockSlots + kBlockSlots - 1;
  int owner[kSlots], start[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) owner[k] = -1, start[k] = 0;
  long long carry = 0;         // the samples before the pass: the same in every thread
  for (int r0 = 0; r0 < p.n_rays && (every_ray || carry <= j_last); r0 += kChunkRays) {
    // this thread's kRayStep consecutive rays of the pass, their sum, then
    // the block's exclusive prefix of the sums
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
    int end = (int)carry + incl - sum, chunk = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      end += w < warp ? s_warp[w] : 0;
      chunk += s_warp[w];
    }
#pragma unroll
    for (int i = 0; i < kRayStep; ++i) {
      const int r = r0 + kRayStep * threadIdx.x + i;
      if (every_ray && r < p.n_rays) p.offsets[r] = (int)min((long long)end, p.cap);
      end += v[i];
      s_end[kRayStep * threadIdx.x + i] = end;
    }
    __syncthreads();
    const int n_pass = min(kChunkRays, p.n_rays - r0);
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const long long j = j0 + (long long)k * kThreads;
      if (owner[k] < 0 && j >= carry && j < carry + chunk) {
        // searchsorted(right=True): the first ray of the pass whose end > j
        int lo = 0, hi = n_pass - 1;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (s_end[mid] > j) hi = mid; else lo = mid + 1;
        }
        owner[k] = r0 + lo;
        start[k] = lo > 0 ? s_end[lo - 1] : (int)carry;
      }
    }
    carry += chunk;
    __syncthreads();           // s_end and s_warp are rewritten by the next pass
  }
  if (every_ray && threadIdx.x == 0) p.offsets[p.n_rays] = (int)min(carry, p.cap);
  // a slot without an owner lies at or past the total
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const long long j = j0 + (long long)k * kThreads;
    if (j >= p.cap) break;
    if (owner[k] >= 0) valid_slot(p, j, owner[k], start[k]); else pad_slot(p, j);
  }
}

struct Edges {
  const int* edge_idx;       // [n]
  const float* coord;        // [n, 2]
  const int* edge_t;         // [E, 2]
  const float* center;       // [E, 3]
  const float* dir0;         // [E, 3]
  const float* dir1;         // [E, 3]
  const float* w2xz;         // [M, 96]
  const float* weight;       // [M, 36]
  float* pts;                // [n, 2, 3]
  int* trans;                // [n, 2]
  int n;
  int n_edges;               // the edge arrays' rows
  int n_trans;               // the warp tables' rows
};

__global__ void __launch_bounds__(kEdgeThreads) sample_edges_kernel(const Edges p) {
  const long long q = (long long)blockIdx.x * kEdgeThreads + threadIdx.x;
  const long long i = q >> 1;
  const int s = (int)(q & 1);
  if (i >= p.n) return;
  const long long e = wrap(__ldg(p.edge_idx + i), p.n_edges);
  const float c0 = __ldg(p.coord + 2 * i), c1 = __ldg(p.coord + 2 * i + 1);
  const int ts = __ldg(p.edge_t + 2 * e + s);
  float world[3], w[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax)
    world[ax] = __fadd_rn(__fadd_rn(__ldg(p.center + 3 * e + ax), __fmul_rn(__ldg(p.dir0 + 3 * e + ax), c0)),
                          __fmul_rn(__ldg(p.dir1 + 3 * e + ax), c1));
  warp_point(p.w2xz, p.weight, wrap(ts, p.n_trans), world, w);
  p.trans[q] = ts;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) p.pts[3 * q + ax] = w[ax];
}

}  // namespace

// n_s [n_rays] i32 (each ray's samples, at most max_s); out_t, out_dt
// [n_rays, max_s] f32 and out_node i32; rays_o, rays_d [n_rays, 3] f32;
// trans_idx [n_nodes] i32; w2xz [., 96], weight [., 36] f32, 16-byte
// aligned. Writes every one of the cap slots of the eight outputs and the
// n_rays + 1 offsets (i32). A block a kBlockSlots slots.
extern "C" int f2_compact_a_warp(const void* n_s, const void* out_t, const void* out_dt,
                                 const void* out_node, const void* rays_o, const void* rays_d,
                                 const void* trans_idx, const void* w2xz, const void* weight,
                                 void* t, void* dt, void* node, void* rid, void* ok, void* trans,
                                 void* pts01, void* dirs, void* offsets, long long cap,
                                 int n_rays, int max_s, int n_nodes, void* stream) {
  if (cap <= 0) return 0;
  if (n_rays <= 0 || max_s <= 0 || n_nodes <= 0 || cap > 0x7fffffffLL ||
      (long long)n_rays * max_s > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const CompactA p{(const int*)n_s, (const float*)out_t, (const float*)out_dt,
             (const int*)out_node, (const float*)rays_o, (const float*)rays_d,
             (const int*)trans_idx, (const float*)w2xz, (const float*)weight,
             (float*)t, (float*)dt, (int*)node, (int*)rid, (unsigned char*)ok,
             (int*)trans, (float*)pts01, (float*)dirs, (int*)offsets, cap, n_rays, max_s,
             n_nodes};
  const long long blocks = (cap + kBlockSlots - 1) / kBlockSlots;
  compact_a_warp_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// edge_idx [n] i32, coord [n, 2] f32; the tree's edge_t [n_edges, 2] i32,
// edge_center, edge_dir0, edge_dir1 [n_edges, 3] f32; w2xz, weight as
// above ([n_trans, .]). pts [n, 2, 3] f32, trans [n, 2] i32.
extern "C" int f2_sample_edges(const void* edge_idx, const void* coord, const void* edge_t,
                               const void* center, const void* dir0, const void* dir1,
                               const void* w2xz, const void* weight, void* pts, void* trans,
                               int n, int n_edges, int n_trans, void* stream) {
  if (n <= 0) return 0;
  if (n_edges <= 0 || n_trans <= 0) return (int)cudaErrorInvalidValue;
  const Edges p{(const int*)edge_idx, (const float*)coord, (const int*)edge_t,
                (const float*)center, (const float*)dir0, (const float*)dir1,
                (const float*)w2xz, (const float*)weight, (float*)pts, (int*)trans,
                n, n_edges, n_trans};
  const long long threads = 2LL * n;
  sample_edges_kernel<<<(unsigned)((threads + kEdgeThreads - 1) / kEdgeThreads), kEdgeThreads, 0,
                        (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
