// K14: the occupancy votes (MarkVistNodeKernel, PersSampler.cu:475-534) and
// their fold into the hysteresis counters (UpdateOctNodes' host formulas
// and MarkInvalidNodes, PersSampler.cu:536-615).
//
// occupancy_votes replaces f2nerf_tpu/sampler/device.py:667
// (compute_occupancy_adders, with f2nerf_tpu/ops/segment.py:33,
// segment_max, for the thresholds); its port was two scatter-amax
// segment maxima, three int32 scatter-maxes, a run-length cumsum and
// index_add and ~30 elementwise launches. Over a ray-sorted flat buffer
// (node, rid [n] i32, w, a [n] f32; padding rows rid == n_rays), a row
// is valid if rid < n_rays and node >= 0, and for each node u:
//   adder_w[u] = 512 if a valid row at u has w > thres_w[its ray], else -1;
//   adder_a[u] = 32 likewise with a and thres_a, else -1;
//   mark[u] = 1 if a valid row lies at u, else 0;
//   visit_max[u] = the longest run of consecutive valid rows of one ray at
//                  u, else 0;
// thres_w[r] = min(max over r's valid rows of w * 0.1, 0.01) and thres_a
// with 0.1 and 0.02, the max NaN if any of them is NaN and -inf for a ray
// without one (segment_max's scatter-amax), the min keeping a NaN (torch's
// clamp). One cooperative launch:
//   1. the grid sets the four outputs to -1, -1, 0, 0;
//   2. a grid-wide barrier;
//   3. a warp a ray (grid-stride over the rays): the ray's rows
//      [lower_bound(rid, r), lower_bound(rid, r + 1)) from two 32-ary
//      searches over rid (a lane a probe, ~5 rounds each at 393k rows);
//      the ray's maxima (fmaxf over the lanes' rows, then over the lanes;
//      a NaN is flagged apart, since fmaxf drops it), the thresholds,
//      then the rows again in chunks of 32: a valid row stores 512 / 32 /
//      1 at its node where it votes, and the last row of each run of one
//      node takes atomicMax(visit_max[node], its run's length), the run's
//      start the latest change of node at or before it (a ballot's
//      highest bit, carried from chunk to chunk).
// The stores write constants and the atomics take a max of integers, so
// the result does not depend on their order, and the maxima's order
// moves only the sign of a zero maximum, which no comparison sees: every
// output equals the plain version's bit for bit, NaN, inf and -0.0
// weights included.
//
// occupancy_fold replaces f2nerf_tpu/sampler/device.py:719
// (apply_occupancy_adders), ~20 elementwise int32 launches over the
// node capacity in its port; one thread a node:
//   occ = adder > 0; s = max(stats, occ * adder) + mark * (1 - occ) *
//   adder, clamped to [-100, 2^20], for the weight and alpha stats;
//   trans = -1 where either stat < 0, else trans_idx;
//   visit = max(visit_cnt, visit_max).
//
// Bound: bytes. The votes read the buffer (16 bytes a row) and write the
// four [N] outputs; at the slice (cap1 393,216 rows, N 393,216) ~12.6 MB,
// ~0.004 ms at 3.35 TB/s. The fold reads seven [N] int32 arrays and
// writes four: ~17.3 MB, ~0.005 ms.
//
// Each entry point returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// the reference's constants (PersSampler.cu:11-17; sampler/device.py)
constexpr int kWeightBase = 512;
constexpr int kAlphaBase = 32;
constexpr float kRelWeight = 0.1f, kAbsWeight = 0.01f;
constexpr float kRelAlpha = 0.1f, kAbsAlpha = 0.02f;

struct Votes {
  const int* node;     // [n]
  const int* rid;      // [n], sorted
  const float* w;      // [n]
  const float* a;      // [n]
  int* adder_w;        // [N] each
  int* adder_a;
  int* mark;
  int* visit_max;
  long long n;
  int n_rays;
  int n_nodes;
};

// the first row in [0, n) whose rid >= key (n if none), found by the whole
// warp: each round the lanes probe 32 evenly spaced rows of [lo, hi), and
// the interval shrinks to one gap between probes
__device__ __forceinline__ long long warp_lower_bound(const int* __restrict__ rid, long long n,
                                                      int key, int lane) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long step = (hi - lo + 31) / 32;
    const long long q = lo + lane * step;
    const bool below = q < hi && __ldg(rid + q) < key;
    const int c = __popc(__ballot_sync(kFull, below));   // a prefix of the lanes
    if (c == 0) break;                                   // rid[lo] >= key
    const long long next_hi = min(hi, lo + c * step);
    lo = lo + (c - 1) * step + 1;
    hi = next_hi;
  }
  return lo;
}

// torch.clamp(x * rel, max=abs): a NaN stays NaN
__device__ __forceinline__ float threshold(float mx, bool nan, float rel, float abs_) {
  if (nan) return __int_as_float(0x7fc00000);
  const float x = __fmul_rn(mx, rel);
  return fminf(x, abs_);
}

__global__ void __launch_bounds__(kThreads) occupancy_votes_kernel(const Votes p) {
  const int lane = threadIdx.x & 31;
  // 1.
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long u = (long long)blockIdx.x * kThreads + threadIdx.x; u < p.n_nodes; u += stride) {
    p.adder_w[u] = -1;
    p.adder_a[u] = -1;
    p.mark[u] = 0;
    p.visit_max[u] = 0;
  }
  // 2.
  cooperative_groups::this_grid().sync();
  // 3.
  const int n_warps = gridDim.x * kWarps;
  for (int r = blockIdx.x * kWarps + (threadIdx.x >> 5); r < p.n_rays; r += n_warps) {
    const long long s = warp_lower_bound(p.rid, p.n, r, lane);
    const long long e = warp_lower_bound(p.rid, p.n, r + 1, lane);
    float mw = -INFINITY, ma = -INFINITY;
    bool nw = false, na = false;
    for (long long i = s + lane; i < e; i += 32) {
      if (__ldg(p.node + i) >= 0) {
        const float wi = __ldg(p.w + i), ai = __ldg(p.a + i);
        nw |= isnan(wi);
        na |= isnan(ai);
        mw = fmaxf(mw, wi);
        ma = fmaxf(ma, ai);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mw = fmaxf(mw, __shfl_xor_sync(kFull, mw, off));
      ma = fmaxf(ma, __shfl_xor_sync(kFull, ma, off));
    }
    const float tw = threshold(mw, __any_sync(kFull, nw), kRelWeight, kAbsWeight);
    const float ta = threshold(ma, __any_sync(kFull, na), kRelAlpha, kAbsAlpha);

    long long run_start = s;   // the start of the run holding the last row seen
    int prev = -2;             // the node key of the row before the chunk
    for (long long base = s; base < e; base += 32) {
      const long long i = base + lane;
      const bool in = i < e;
      const int nd = in ? __ldg(p.node + i) : -1;
      const bool valid = in && nd >= 0;
      // invalid rows take the key n_nodes, as the plain version's dump
      const int key = valid ? nd : p.n_nodes;
      const int up = __shfl_up_sync(kFull, key, 1);
      const int before = lane == 0 ? prev : up;
      const unsigned starts = __ballot_sync(kFull, in && (i == s || key != before));
      int after = __shfl_down_sync(kFull, key, 1);
      if (lane == 31 && i + 1 < e) {
        const int nx = __ldg(p.node + i + 1);
        after = nx >= 0 ? nx : p.n_nodes;
      }
      const bool last = in && (i + 1 >= e || after != key);
      const unsigned upto = starts & (kFull >> (31 - lane));
      const long long start = upto ? base + 31 - __clz(upto) : run_start;
      if (valid && nd < p.n_nodes) {      // a node past the capacity would be the dump
        p.mark[nd] = 1;
        if (__ldg(p.w + i) > tw) p.adder_w[nd] = kWeightBase;
        if (__ldg(p.a + i) > ta) p.adder_a[nd] = kAlphaBase;
        if (last) atomicMax(p.visit_max + nd, (int)(i - start + 1));
      }
      if (starts) run_start = base + 31 - __clz(starts);
      prev = __shfl_sync(kFull, key, 31);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
occupancy_fold_kernel(const int* __restrict__ adder_w, const int* __restrict__ adder_a,
                      const int* __restrict__ mark, const int* __restrict__ visit_max,
                      const int* __restrict__ weight_stats, const int* __restrict__ alpha_stats,
                      const int* __restrict__ visit_cnt, const int* __restrict__ trans_idx,
                      int* __restrict__ o_weight, int* __restrict__ o_alpha,
                      int* __restrict__ o_visit, int* __restrict__ o_trans, int n) {
  const int u = blockIdx.x * kThreads + threadIdx.x;
  if (u >= n) return;
  const int mk = mark[u];
  const int aw = adder_w[u], occ_w = aw > 0 ? 1 : 0;
  int ws = max(weight_stats[u], occ_w * aw) + mk * (1 - occ_w) * aw;
  ws = min(max(ws, -100), 1 << 20);
  const int aa = adder_a[u], occ_a = aa > 0 ? 1 : 0;
  int as = max(alpha_stats[u], occ_a * aa) + mk * (1 - occ_a) * aa;
  as = min(max(as, -100), 1 << 20);
  o_weight[u] = ws;
  o_alpha[u] = as;
  o_trans[u] = (ws < 0 || as < 0) ? -1 : trans_idx[u];
  o_visit[u] = max(visit_cnt[u], visit_max[u]);
}

}  // namespace

// node, rid [n] i32 (rid sorted, padding rows n_rays), w, a [n] f32; the
// four outputs [n_nodes] i32, every entry written. The grid is at most
// what the card holds at once (read once a device and process).
extern "C" int f2_occupancy_votes(const void* node, const void* rid, const void* w,
                                  const void* a, void* adder_w, void* adder_a, void* mark,
                                  void* visit_max, long long n, int n_rays, int n_nodes,
                                  void* stream) {
  if (n < 0 || n_rays < 0 || n_nodes <= 0) return (int)cudaErrorInvalidValue;
  static int resident[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, occupancy_votes_kernel,
                                                        kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    if (sms * per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
    resident[dev] = sms * per_sm;
  }
  long long want = ((long long)n_rays + kWarps - 1) / kWarps;
  const long long init = ((long long)n_nodes + kThreads - 1) / kThreads;
  if (init > want) want = init;
  const unsigned grid = (unsigned)(want < resident[dev] ? want : resident[dev]);
  Votes p{(const int*)node, (const int*)rid, (const float*)w, (const float*)a, (int*)adder_w,
          (int*)adder_a, (int*)mark, (int*)visit_max, n, n_rays, n_nodes};
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel((const void*)occupancy_votes_kernel, dim3(grid),
                                  dim3(kThreads), args, 0, (cudaStream_t)stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// the votes [n] i32 each (adder_w, adder_a, mark, visit_max) and the tree's
// weight_stats, alpha_stats, visit_cnt, trans_idx [n] i32 in; the new
// weight_stats, alpha_stats, visit_cnt, trans_idx [n] i32 out.
extern "C" int f2_occupancy_fold(const void* adder_w, const void* adder_a, const void* mark,
                                 const void* visit_max, const void* weight_stats,
                                 const void* alpha_stats, const void* visit_cnt,
                                 const void* trans_idx, void* o_weight, void* o_alpha,
                                 void* o_visit, void* o_trans, int n, void* stream) {
  if (n <= 0) return 0;
  occupancy_fold_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)adder_w, (const int*)adder_a, (const int*)mark, (const int*)visit_max,
      (const int*)weight_stats, (const int*)alpha_stats, (const int*)visit_cnt,
      (const int*)trans_idx, (int*)o_weight, (int*)o_alpha, (int*)o_visit, (int*)o_trans, n);
  return (int)cudaGetLastError();
}
