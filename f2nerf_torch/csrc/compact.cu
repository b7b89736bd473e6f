// K13: the keep-set compaction A -> B (the prefilter's survivors into the
// grad pass's buffer). Replaces f2nerf_tpu/render/renderer.py:72 (_compact
// with a ray-id source: jnp.nonzero(size=cap) and one where/gather a
// field); its port was a cumsum, a scatter-amin into a dump slot, a clamp
// and two launches a field (~20 launches). For keep flags over A's n rows:
//   slot p < min(total, cap) takes the p-th kept row i: t, dt, node,
//   trans, pts01 [3], dirs [3] = A's row i, rid = rid_a[i], ok = 1,
//   idx = i (int64, the cached-B gather's index);
//   kept rows past cap are dropped;
//   slots p >= total: zeros, rid = n_rays, ok = 0, idx = n - 1 (the JAX
//   fill index, which the cached-B gather reads).
// One cooperative launch (every block resident, as the offsets launch in
// segment.cu), a block a contiguous range of rows:
//   1. the block counts its kept rows;
//   2. a grid-wide barrier;
//   3. the block's first slot is the sum of the counts of the blocks
//      before it (and every block sums all of them for the total: one
//      int a block, ~1,000 of them, read from L2);
//   4. the block walks its rows in order, 256 at a time: a kept row's
//      slot is the carry plus the kept rows before it in the tile (a
//      ballot's popcount within a warp, the warps' counts through shared
//      memory), and it copies its row there if the slot is below cap;
//   5. the grid writes the padding slots.
// Integers and copies only, so the result does not depend on any order
// and equals the plain version bit for bit.
//
// Bound: bytes: the flags read once; the kept rows (41 bytes of A's fields
// and rid_a) read once and 53 bytes a slot written. At the slice (cap1
// 393,216, cap2 262,144) ~14 MB, ~0.004 ms at 3.35 TB/s.
//
// Each entry point returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

struct Keep {
  const unsigned char* keep;   // [n]
  const float* t;              // [n] each
  const float* dt;
  const int* node;
  const int* trans;
  const float* pts01;          // [n, 3]
  const float* dirs;           // [n, 3]
  const int* rid_src;          // [n]
  float* o_t;                  // [cap] each
  float* o_dt;
  int* o_node;
  int* o_trans;
  float* o_pts01;              // [cap, 3]
  float* o_dirs;               // [cap, 3]
  int* o_rid;
  unsigned char* o_ok;
  long long* o_idx;
  int* counts;                 // [gridDim.x] scratch
  long long n;
  long long cap;
  long long rows_per_block;
  int n_rays;
};

// the block's sum of v (every thread gets it); s holds kWarps ints
__device__ __forceinline__ long long block_sum(long long v, long long* s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  if ((threadIdx.x & 31) == 0) s[threadIdx.x >> 5] = v;
  __syncthreads();
  long long total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += s[w];
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(kThreads) compact_keep_kernel(const Keep p) {
  __shared__ long long s_sum[kWarps];
  __shared__ int s_warp[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long r0 = (long long)blockIdx.x * p.rows_per_block;
  const long long r1 = min(p.n, r0 + p.rows_per_block);

  // 1. the block's kept rows
  long long mine = 0;
  for (long long i = r0 + threadIdx.x; i < r1; i += kThreads) mine += p.keep[i] != 0;
  const long long count = block_sum(mine, s_sum);
  if (threadIdx.x == 0) p.counts[blockIdx.x] = (int)count;
  // 2.
  cooperative_groups::this_grid().sync();
  // 3. the kept rows before the block, and all of them
  long long before = 0, all = 0;
  for (unsigned b = threadIdx.x; b < gridDim.x; b += kThreads) {
    const long long c = __ldcg(p.counts + b);
    all += c;
    if (b < blockIdx.x) before += c;
  }
  before = block_sum(before, s_sum);
  all = block_sum(all, s_sum);

  // 4. the block's rows in order, a tile of kThreads rows at a time
  long long carry = before;
  for (long long base = r0; base < r1 && carry < p.cap; base += kThreads) {
    const long long i = base + threadIdx.x;
    const bool kept = i < r1 && p.keep[i] != 0;
    const unsigned m = __ballot_sync(kFull, kept);
    if (lane == 0) s_warp[warp] = __popc(m);
    __syncthreads();
    long long pos = carry + __popc(m & ((1u << lane) - 1u));
    int tile = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      pos += w < warp ? s_warp[w] : 0;
      tile += s_warp[w];
    }
    if (kept && pos < p.cap) {
      p.o_t[pos] = p.t[i];
      p.o_dt[pos] = p.dt[i];
      p.o_node[pos] = p.node[i];
      p.o_trans[pos] = p.trans[i];
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        p.o_pts01[3 * pos + ax] = p.pts01[3 * i + ax];
        p.o_dirs[3 * pos + ax] = p.dirs[3 * i + ax];
      }
      p.o_rid[pos] = p.rid_src[i];
      p.o_ok[pos] = 1;
      p.o_idx[pos] = i;
    }
    carry += tile;
    __syncthreads();           // s_warp is rewritten by the next tile
  }

  // 5. the padding slots
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long q = min(all, p.cap) + (long long)blockIdx.x * kThreads + threadIdx.x;
       q < p.cap; q += stride) {
    p.o_t[q] = 0.0f;
    p.o_dt[q] = 0.0f;
    p.o_node[q] = 0;
    p.o_trans[q] = 0;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      p.o_pts01[3 * q + ax] = 0.0f;
      p.o_dirs[3 * q + ax] = 0.0f;
    }
    p.o_rid[q] = p.n_rays;
    p.o_ok[q] = 0;
    p.o_idx[q] = p.n - 1;
  }
}

}  // namespace

// The most blocks K13 launches (the scratch of counts the caller passes
// holds this many ints at least).
extern "C" int f2_compact_keep_max_blocks() { return 4096; }

// keep [n] bool; A's t, dt [n] f32, node, trans [n] i32, pts01, dirs
// [n, 3] f32, rid_src [n] i32; the B outputs [cap] (pts01, dirs [cap, 3];
// idx int64); counts: f2_compact_keep_max_blocks() ints of scratch. n >= 1.
// The grid is at most what the card holds at once (read once a device and
// process), at most a block a 256 rows.
extern "C" int f2_compact_keep(const void* keep, const void* t, const void* dt,
                               const void* node, const void* trans, const void* pts01,
                               const void* dirs, const void* rid_src, void* o_t, void* o_dt,
                               void* o_node, void* o_trans, void* o_pts01, void* o_dirs,
                               void* o_rid, void* o_ok, void* o_idx, void* counts, long long n,
                               long long cap, int n_rays, void* stream) {
  if (cap <= 0) return 0;
  if (n <= 0 || n_rays < 0) return (int)cudaErrorInvalidValue;
  static int resident[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, compact_keep_kernel, kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    if (sms * per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
    resident[dev] = sms * per_sm;
  }
  long long grid = (n + kThreads - 1) / kThreads;
  if (grid > resident[dev]) grid = resident[dev];
  if (grid > f2_compact_keep_max_blocks()) grid = f2_compact_keep_max_blocks();
  Keep p{(const unsigned char*)keep, (const float*)t, (const float*)dt, (const int*)node,
         (const int*)trans, (const float*)pts01, (const float*)dirs, (const int*)rid_src,
         (float*)o_t, (float*)o_dt, (int*)o_node, (int*)o_trans, (float*)o_pts01,
         (float*)o_dirs, (int*)o_rid, (unsigned char*)o_ok, (long long*)o_idx, (int*)counts,
         n, cap, (n + grid - 1) / grid, n_rays};
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel((const void*)compact_keep_kernel, dim3((unsigned)grid),
                                  dim3(kThreads), args, 0, (cudaStream_t)stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
