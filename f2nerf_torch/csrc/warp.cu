// K12: the per-leaf perspective warp (QueryFrameTransform,
// PersSampler.cu:155-168), in two entry points that share one __device__
// warp:
//
// compact_a_warp: the dense marcher output [R, max_s] becomes flat buffer
// A [cap1], each slot with its world point warped into [-1, 1]^3. Replaces
// f2nerf_tpu/render/renderer.py:96 (_compact_rowpacked) with the rest of
// the A side of render (:223-240): the ray ends' search, the row gathers,
// the leaf's row, xyz = o + d t, f2nerf_tpu/sampler/device.py:193
// (apply_warp) and the pin of padding slots. Its port was a chain of
// ~250 torch launches (apply_warp alone issues 9 mul, 9 add and 1 div for
// each of the 12 projections). Per slot j:
//   the owner r = the first ray whose running end (the prefix of n_s)
//   exceeds j; ok = j < the total; src = r * max_s + (j - start_r);
//   t, dt, node = out_*[src] (0 where not ok); rid = r (R where not ok);
//   trans = max(trans_idx[node], 0) (a negative node indexes from the end,
//   as torch's gather does); rc = ok ? r : R - 1;
//   pts01 = ok ? (warp(trans, o[rc] + d[rc] t) + 1) * 0.5 : 0.5;
//   dirs = d[rc].
// A block takes 1,024 consecutive slots (4 a thread, 256 apart, so each
// store is coalesced) and scans n_s itself, a chunk of 1,024 rays at a
// time (a block-wide prefix through warp shuffles), so no launch before it
// computes the ends and any R fits its 4 KB of shared memory: each slot
// the chunk's ends cover finds its owner by a binary search there, and the
// block stops once its last slot is owned (the padding blocks read all of
// n_s: 8 KB at the slice's 2,048 rays, from L2).
//
// sample_edges: points on leaf-face adjacencies (GetEdgeSamplesKernel,
// PersSampler.cu:436-473), warped into both neighbour frames. Replaces
// f2nerf_tpu/sampler/device.py:649 (sample_edges, whose two apply_warp
// calls were ~460 torch launches in the port). A thread an edge sample:
//   e = edge_idx[i]; world = (center[e] + dir0[e] c0) + dir1[e] c1;
//   trans[i, s] = edge_t[e, s], pts[i, s] = warp(edge_t[e, s], world).
//
// The warp: for the leaf's rows m = w2xz[tr] [96] and w = weight[tr] [36],
// for k = 0..11: a = ((m[8k] x + m[8k+1] y) + m[8k+2] z) + m[8k+3], b the
// same with m[8k+4..7], v = a / b, out[ax] = out[ax] + w[12 ax + k] v from
// 0. The rows are read as float4s (33 a leaf; the wrappers check their
// 16-byte alignment), as K9 reads them. Every operation rounds as the
// plain version's torch ops do, in their order (__fmul_rn / __fadd_rn /
// __fdiv_rn: nvcc would contract a multiply-add into an FMA), so both
// entry points are bit for bit their plain versions on the card, the
// degenerate warp's inf and NaN included.
//
// Bound: bytes. compact_a_warp reads n_s, the valid slots' t, dt, node,
// their rays and the touched leaves' rows once and writes 49 bytes a slot;
// at the slice's cap1 of 393,216 slots ~23 MB, ~0.007 ms at 3.35 TB/s.
// The warp is ~230 f32 operations a slot, ~0.09 GFLOP there, 1.4 us at
// the card's 67 TFLOP/s f32: under the bytes. sample_edges at 8,192
// samples moves ~0.4 MB (and the touched rows), ~0.0002 ms.
//
// Each entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 4;                       // compact_a_warp: slots a thread
constexpr int kBlockSlots = kThreads * kSlots;  // slots a block
constexpr int kRayStep = 4;                     // rays a thread in a chunk of the scan
constexpr int kChunkRays = kThreads * kRayStep; // rays a chunk
constexpr int kPros = 12;
constexpr unsigned kFull = 0xffffffffu;

// ((m0 x0 + m1 x1) + m2 x2): a and b before the translation
__device__ __forceinline__ float row_dot(const float4 m, const float x[3]) {
  return __fadd_rn(__fadd_rn(__fmul_rn(m.x, x[0]), __fmul_rn(m.y, x[1])), __fmul_rn(m.z, x[2]));
}

__device__ __forceinline__ float lane4(const float4 v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// apply_warp of one point through warp row tr: projection k = 4 kq + kk
// takes w2xz's float4s 2k and 2k + 1 and lane kk of weight's float4 kq of
// each axis (weight[12 ax + k])
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
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 r0 = __ldg(m4 + 8 * kq + 2 * kk), r1 = __ldg(m4 + 8 * kq + 2 * kk + 1);
      const float v = __fdiv_rn(__fadd_rn(row_dot(r0, x), r0.w), __fadd_rn(row_dot(r1, x), r1.w));
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
  long long cap;
  int n_rays;
  int max_s;
  int n_nodes;               // trans_idx's rows
};

__global__ void __launch_bounds__(kThreads) compact_a_warp_kernel(const CompactA p) {
  __shared__ int s_end[kChunkRays];
  __shared__ int s_warp[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long j0 = (long long)blockIdx.x * kBlockSlots;
  const long long j_last = j0 + kBlockSlots - 1;
  int owner[kSlots];
  long long src[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    owner[k] = -1;
    src[k] = 0;
  }
  // the ends before the chunk: the same value in every thread
  long long carry = 0;
  for (int r0 = 0; r0 < p.n_rays && carry <= j_last; r0 += kChunkRays) {
    // this thread's kRayStep consecutive rays of the chunk, their sum, then
    // the block's exclusive prefix of the sums
    int v[kRayStep];
    int sum = 0;
#pragma unroll
    for (int i = 0; i < kRayStep; ++i) {
      const int r = r0 + kRayStep * threadIdx.x + i;
      v[i] = r < p.n_rays ? __ldg(p.n_s + r) : 0;
      sum += v[i];
    }
    int incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    int before = 0, chunk = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? s_warp[w] : 0;
      chunk += s_warp[w];
    }
    int end = (int)carry + before + incl - sum;
#pragma unroll
    for (int i = 0; i < kRayStep; ++i) {
      end += v[i];
      s_end[kRayStep * threadIdx.x + i] = end;
    }
    __syncthreads();
    const int n_chunk = min(kChunkRays, p.n_rays - r0);
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const long long j = j0 + (long long)k * kThreads + threadIdx.x;
      if (owner[k] < 0 && j >= carry && j < carry + chunk) {
        // searchsorted(right=True): the first ray of the chunk whose end > j
        int lo = 0, hi = n_chunk - 1;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if ((long long)s_end[mid] > j) hi = mid; else lo = mid + 1;
        }
        const long long start = lo > 0 ? s_end[lo - 1] : carry;
        owner[k] = r0 + lo;
        src[k] = (long long)(r0 + lo) * p.max_s + (j - start);
      }
    }
    carry += chunk;
    __syncthreads();           // s_end and s_warp are rewritten by the next chunk
  }
  // a slot still without an owner lies at or past the total (the loop ran
  // over every ray: carry is the total)
  const long long n_src = (long long)p.n_rays * p.max_s;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const long long j = j0 + (long long)k * kThreads + threadIdx.x;
    if (j >= p.cap) continue;
    const bool ok = owner[k] >= 0;
    const int rc = ok ? owner[k] : p.n_rays - 1;
    float t = 0.0f, dt = 0.0f;
    int node = 0;
    if (ok) {
      const long long s = min(src[k], n_src - 1);     // n_s[r] <= max_s: never cut
      t = __ldg(p.out_t + s);
      dt = __ldg(p.out_dt + s);
      node = __ldg(p.out_node + s);
    }
    const int tr = max(__ldg(p.trans_idx + wrap(node, p.n_nodes)), 0);
    float d[3], pts[3] = {0.5f, 0.5f, 0.5f};
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) d[ax] = __ldg(p.rays_d + 3LL * rc + ax);
    if (ok) {
      float x[3], w[3];
#pragma unroll
      for (int ax = 0; ax < 3; ++ax)
        x[ax] = __fadd_rn(__ldg(p.rays_o + 3LL * rc + ax), __fmul_rn(d[ax], t));
      warp_point(p.w2xz, p.weight, tr, x, w);
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) pts[ax] = __fmul_rn(__fadd_rn(w[ax], 1.0f), 0.5f);
    }
    p.t[j] = t;
    p.dt[j] = dt;
    p.node[j] = node;
    p.rid[j] = ok ? rc : p.n_rays;
    p.ok[j] = ok ? 1 : 0;
    p.trans[j] = tr;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      p.pts01[3 * j + ax] = pts[ax];
      p.dirs[3 * j + ax] = d[ax];
    }
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

__global__ void __launch_bounds__(kThreads) sample_edges_kernel(const Edges p) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.n) return;
  const long long e = wrap(__ldg(p.edge_idx + i), p.n_edges);
  const float c0 = __ldg(p.coord + 2LL * i), c1 = __ldg(p.coord + 2LL * i + 1);
  float world[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax)
    world[ax] = __fadd_rn(__fadd_rn(__ldg(p.center + 3 * e + ax), __fmul_rn(__ldg(p.dir0 + 3 * e + ax), c0)),
                          __fmul_rn(__ldg(p.dir1 + 3 * e + ax), c1));
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int ts = __ldg(p.edge_t + 2 * e + s);
    float w[3];
    warp_point(p.w2xz, p.weight, wrap(ts, p.n_trans), world, w);
    p.trans[2LL * i + s] = ts;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) p.pts[6LL * i + 3 * s + ax] = w[ax];
  }
}

}  // namespace

// n_s [n_rays] i32 (each ray's samples, at most max_s); out_t, out_dt
// [n_rays, max_s] f32 and out_node i32; rays_o, rays_d [n_rays, 3] f32;
// trans_idx [n_nodes] i32; w2xz [., 96], weight [., 36] f32, 16-byte
// aligned. Writes every one of the cap slots of the eight outputs.
extern "C" int f2_compact_a_warp(const void* n_s, const void* out_t, const void* out_dt,
                                 const void* out_node, const void* rays_o, const void* rays_d,
                                 const void* trans_idx, const void* w2xz, const void* weight,
                                 void* t, void* dt, void* node, void* rid, void* ok, void* trans,
                                 void* pts01, void* dirs, long long cap, int n_rays, int max_s,
                                 int n_nodes, void* stream) {
  if (cap <= 0) return 0;
  if (n_rays <= 0 || max_s <= 0 || n_nodes <= 0 || (long long)n_rays * max_s > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (cap + kBlockSlots - 1) / kBlockSlots;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const CompactA p{(const int*)n_s, (const float*)out_t, (const float*)out_dt,
                   (const int*)out_node, (const float*)rays_o, (const float*)rays_d,
                   (const int*)trans_idx, (const float*)w2xz, (const float*)weight,
                   (float*)t, (float*)dt, (int*)node, (int*)rid, (unsigned char*)ok,
                   (int*)trans, (float*)pts01, (float*)dirs, cap, n_rays, max_s, n_nodes};
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
  sample_edges_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
