// K14: the occupancy votes (MarkVistNodeKernel, PersSampler.cu:475-534) and
// their fold into the hysteresis counters (UpdateOctNodes' host formulas
// and MarkInvalidNodes, PersSampler.cu:536-615).
//
// occupancy_votes replaces f2nerf_tpu/sampler/device.py:667
// (compute_occupancy_adders, with f2nerf_tpu/ops/segment.py:33,
// segment_max, for the thresholds); its port was two scatter-amax
// segment maxima, three int32 scatter-maxes, a run-length cumsum and
// index_add and ~30 elementwise launches. Over a ray-sorted flat buffer
// (node, rid [n] i32, w, a [n] f32; padding rows rid == n_rays) and its
// ray offsets (offsets [n_rays + 1] i32, as the offsets launch gives them:
// ray r's rows are [offsets[r], offsets[r + 1]); the renderer passes A's
// from K12 or B's), a row is valid if rid < n_rays and node >= 0, and for
// each node u:
//   adder_w[u] = 512 if a valid row at u has w > thres_w[its ray], else -1;
//   adder_a[u] = 32 likewise with a and thres_a, else -1;
//   mark[u] = 1 if a valid row lies at u, else 0;
//   visit_max[u] = the longest run of consecutive valid rows of one ray at
//                  u, else 0;
// thres_w[r] = min(max over r's valid rows of w * 0.1, 0.01) and thres_a
// with 0.1 and 0.02, the max NaN if any of them is NaN and -inf for a ray
// without one (segment_max's scatter-amax), the min keeping a NaN (torch's
// clamp). One cooperative launch, a warp a ray:
//   0. each warp loads its first ray's rows (offsets held to [0, n]): each
//      lane node, w and a of its rows of the ray's first kWindow chunks of
//      32 (512 rows, the slice's max_s) into registers at once;
//   1. the grid sets the four outputs to -1, -1, 0, 0;
//   2. a grid-wide barrier (the loads of 0. arrive meanwhile);
//   3. each warp's rays (grid-stride; a later ray's rows loaded as in 0.,
//      rows past the window read as the lane goes): the ray's maxima
//      (fmaxf over the lanes' rows, then over the lanes; a NaN is flagged
//      apart, since fmaxf drops it), the thresholds, then the chunks again
//      from the registers: the last row of each run of one node (its
//      start the latest change of node at or before it, a ballot's highest
//      bit, carried from chunk to chunk) stores mark 1 and 512 / 32 where a
//      row of the run votes (ballots of the votes over the run's lanes,
//      carried likewise), and takes atomicMax(visit_max[node], the run's
//      length).
// The grid is sized to the work (a warp a ray, kInitRows nodes a thread of
// the init), at most what the card holds at once. At the slice step's
// shapes (scripts/sweep_kernels.py --kernels k14, PERF.md §6) this ran
// 0.0132 ms against the earlier kernel's 0.0222, which found each ray's
// rows by two 32-ary searches over rid (~0.0035 ms), read them twice from
// L2, stored the votes from every row and ran every block resident.
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
// Bound: bytes. Given the offsets, the votes read node of the rays' rows,
// w and a of the valid ones and the offsets, and write the four [N]
// outputs (rid is not read: a ray's rows are its rows); at the slice step
// (146,012 rows in rays, all valid, N 393,216) ~8.1 MB, ~0.0024 ms at
// 3.35 TB/s (0.0029 ms counting rid and every row's node too). The
// fold reads seven [N] int32 arrays and writes four: ~17.3 MB, ~0.005 ms.
//
// Each entry point returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWindow = 16;        // chunks of 32 rows a lane holds in registers
constexpr int kInitRows = 8;       // the init: the grid has >= N / (kThreads kInitRows) blocks
constexpr unsigned kFull = 0xffffffffu;
// the reference's constants (PersSampler.cu:11-17; sampler/device.py)
constexpr int kWeightBase = 512;
constexpr int kAlphaBase = 32;
constexpr float kRelWeight = 0.1f, kAbsWeight = 0.01f;
constexpr float kRelAlpha = 0.1f, kAbsAlpha = 0.02f;

struct Votes {
  const int* node;     // [n]
  const float* w;      // [n]
  const float* a;      // [n]
  const int* offsets;  // [n_rays + 1]
  int* adder_w;        // [N] each
  int* adder_a;
  int* mark;
  int* visit_max;
  long long n;
  int n_rays;
  int n_nodes;
};

// torch.clamp(x * rel, max=abs): a NaN stays NaN
__device__ __forceinline__ float threshold(float mx, bool nan, float rel, float abs_) {
  if (nan) return __int_as_float(0x7fc00000);
  const float x = __fmul_rn(mx, rel);
  return fminf(x, abs_);
}

// a row's run key: its node if valid, n_nodes (the plain version's dump)
// otherwise
__device__ __forceinline__ int run_key(bool in, int nd, int n_nodes) {
  return in && nd >= 0 ? nd : n_nodes;
}

// a row into the ray's maxima
__device__ __forceinline__ void row_max(bool in, int nd, float wi, float ai, float& mw,
                                        float& ma, bool& nw, bool& na) {
  if (in && nd >= 0) {
    nw |= isnan(wi);
    na |= isnan(ai);
    mw = fmaxf(mw, wi);
    ma = fmaxf(ma, ai);
  }
}

// the votes of one chunk of 32 rows [base, base + 32) of a ray [s, e):
// this lane's row (nd, wi, ai), the key of the row after the chunk (read
// by lane 31 where it is in the ray), and carried from chunk to chunk the
// start of the run holding the last row seen, its key (prev) and whether
// any of its rows voted (vote_w, vote_a). Only the last row of a run of
// one node stores: mark, the run's votes and its length (a run takes
// ~5-16 rows at the slice, so the card sees that many times fewer stores
// to the few hundred leaves every ray crosses)
__device__ __forceinline__ void chunk_votes(const Votes& p, long long base, long long s,
                                            long long e, int lane, int nd, float wi, float ai,
                                            int next_key, float tw, float ta,
                                            long long& run_start, int& prev, bool& vote_w,
                                            bool& vote_a) {
  const long long i = base + lane;
  const bool in = i < e;
  const bool valid = in && nd >= 0;
  const int key = run_key(in, nd, p.n_nodes);
  const int up = __shfl_up_sync(kFull, key, 1);
  const int before = lane == 0 ? prev : up;
  const unsigned starts = __ballot_sync(kFull, in && (i == s || key != before));
  const unsigned vw = __ballot_sync(kFull, valid && wi > tw);
  const unsigned va = __ballot_sync(kFull, valid && ai > ta);
  int after = __shfl_down_sync(kFull, key, 1);
  if (lane == 31) after = next_key;
  const bool last = in && (i + 1 >= e || after != key);
  // this lane's run in the chunk: lanes [first, lane], or from an earlier
  // chunk (no start at or before this lane)
  const unsigned upto = starts & (kFull >> (31 - lane));
  const int first = upto ? 31 - __clz(upto) : 0;
  const unsigned span = (kFull >> (31 - lane)) & (kFull << first);
  if (last && valid && nd < p.n_nodes) {      // a node past the capacity would be the dump
    const long long run0 = upto ? base + first : run_start;
    p.mark[nd] = 1;
    if ((vw & span) || (!upto && vote_w)) p.adder_w[nd] = kWeightBase;
    if ((va & span) || (!upto && vote_a)) p.adder_a[nd] = kAlphaBase;
    atomicMax(p.visit_max + nd, (int)(i - run0 + 1));
  }
  // the run holding lane 31, into the next chunk
  const unsigned tail = kFull << (starts ? 31 - __clz(starts) : 0);
  vote_w = (vw & tail) || (!starts && vote_w);
  vote_a = (va & tail) || (!starts && vote_a);
  if (starts) run_start = base + 31 - __clz(starts);
  prev = __shfl_sync(kFull, key, 31);
}

// ray r's rows [s, e) from its offsets (held to [0, n]) and this lane's
// rows of its first kWindow chunks: node (-1 past e), w and a
__device__ __forceinline__ void load_window(const Votes& p, int r, int lane, long long& s,
                                            long long& e, int nd[kWindow], float wv[kWindow],
                                            float av[kWindow]) {
  s = min(max((long long)__ldg(p.offsets + r), 0LL), p.n);
  e = min(max((long long)__ldg(p.offsets + r + 1), s), p.n);
#pragma unroll
  for (int q = 0; q < kWindow; ++q) {
    const long long i = s + 32 * q + lane;
    const bool in = i < e;
    nd[q] = in ? __ldg(p.node + i) : -1;
    wv[q] = in ? __ldg(p.w + i) : 0.0f;
    av[q] = in ? __ldg(p.a + i) : 0.0f;
  }
}

// the votes of ray [s, e), its first kWindow chunks in registers
__device__ __forceinline__ void ray_votes(const Votes& p, int lane, long long s, long long e,
                                          const int nd[kWindow], const float wv[kWindow],
                                          const float av[kWindow]) {
  float mw = -INFINITY, ma = -INFINITY;
  bool nw = false, na = false;
#pragma unroll
  for (int q = 0; q < kWindow; ++q)
    row_max(s + 32 * q + lane < e, nd[q], wv[q], av[q], mw, ma, nw, na);
  for (long long i = s + 32 * kWindow + lane; i < e; i += 32)
    row_max(true, __ldg(p.node + i), __ldg(p.w + i), __ldg(p.a + i), mw, ma, nw, na);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mw = fmaxf(mw, __shfl_xor_sync(kFull, mw, off));
    ma = fmaxf(ma, __shfl_xor_sync(kFull, ma, off));
  }
  const float tw = threshold(mw, __any_sync(kFull, nw), kRelWeight, kAbsWeight);
  const float ta = threshold(ma, __any_sync(kFull, na), kRelAlpha, kAbsAlpha);

  long long run_start = s;   // the start of the run holding the last row seen
  int prev = -2;             // the node key of the row before the chunk
  bool vote_w = false, vote_a = false;
#pragma unroll
  for (int q = 0; q < kWindow; ++q) {
    const long long base = s + 32 * q;
    if (base >= e) break;    // the same in every lane
    // the key of the row after the chunk: lane 0's of the next chunk, or
    // read past the window
    int next_key;
    if (q + 1 < kWindow) {
      next_key = __shfl_sync(kFull, run_key(base + 32 + lane < e, nd[q + 1], p.n_nodes), 0);
    } else {
      next_key = base + 32 < e ? run_key(true, __ldg(p.node + base + 32), p.n_nodes)
                               : p.n_nodes;
    }
    chunk_votes(p, base, s, e, lane, nd[q], wv[q], av[q], next_key, tw, ta, run_start, prev,
                vote_w, vote_a);
  }
  for (long long base = s + 32 * kWindow; base < e; base += 32) {
    const long long i = base + lane;
    const bool in = i < e;
    const int next_key = base + 32 < e ? run_key(true, __ldg(p.node + base + 32), p.n_nodes)
                                       : p.n_nodes;
    chunk_votes(p, base, s, e, lane, in ? __ldg(p.node + i) : -1, in ? __ldg(p.w + i) : 0.0f,
                in ? __ldg(p.a + i) : 0.0f, next_key, tw, ta, run_start, prev, vote_w, vote_a);
  }
}

__global__ void __launch_bounds__(kThreads) occupancy_votes_kernel(const Votes p) {
  const int lane = threadIdx.x & 31;
  const int n_warps = gridDim.x * kWarps;
  const int r0 = blockIdx.x * kWarps + (threadIdx.x >> 5);
  // the warp's first ray's rows, loaded before the init and the barrier
  // (inputs: no store of this launch touches them), so their wait
  // overlaps both
  long long s = 0, e = 0;
  int nd[kWindow];
  float wv[kWindow], av[kWindow];
  if (r0 < p.n_rays) load_window(p, r0, lane, s, e, nd, wv, av);
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
  for (int r = r0; r < p.n_rays; r += n_warps) {
    if (r != r0) load_window(p, r, lane, s, e, nd, wv, av);
    ray_votes(p, lane, s, e, nd, wv, av);
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

// node [n] i32, w, a [n] f32 of a ray-sorted buffer and its offsets
// [n_rays + 1] i32 (each ray's first row, offsets[n_rays] the first
// padding row); the four outputs [n_nodes] i32, every entry written.
// The grid: a warp a ray and kInitRows nodes a thread, at most what the
// card holds at once (read once a device and process).
extern "C" int f2_occupancy_votes(const void* node, const void* w, const void* a,
                                  const void* offsets, void* adder_w,
                                  void* adder_a, void* mark, void* visit_max, long long n,
                                  int n_rays, int n_nodes, void* stream) {
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
  const long long init = ((long long)n_nodes + kThreads * kInitRows - 1) / (kThreads * kInitRows);
  if (init > want) want = init;
  const unsigned grid = (unsigned)(want < resident[dev] ? want : resident[dev]);
  Votes p{(const int*)node, (const float*)w, (const float*)a,
          (const int*)offsets, (int*)adder_w, (int*)adder_a, (int*)mark, (int*)visit_max, n,
          n_rays, n_nodes};
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
