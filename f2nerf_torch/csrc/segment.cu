// K10 and K11: the per-ray segment ops of the composite chain, each sum
// taken in a fixed order (no atomics), so a step gives the same bits on
// every run.
//
// K10, segment_reduce: out[r, c] = sum of x[i, c] over the rows i with
// ray_id[i] == r, for a ray-sorted flat buffer x [n, C] f32 (padding rows
// carry ray_id == n_rays and are dropped). Replaces jax.ops.segment_sum
// with indices_are_sorted=True (f2nerf_tpu/ops/segment.py:23), whose port
// was an index_add (float atomics, in no fixed order). One warp a ray: the
// warp finds its run [start_r, start_{r+1}) in the sorted ray_id itself
// (half_lower_bound: the two ends at once, 17-ary, ~5 dependent loads), the
// lanes stride the run (lane l sums rows start + l, start + l + 32, ... in
// that order), then a fixed __shfl_xor_sync tree combines the 32 lanes. A
// block's blockIdx.y picks a tile of up to 8 channels; each channel's order
// is the same whatever C is, so the composite's stacked sums (C = 6) give
// each channel the bits it would have alone.
//
// K11, segment_scan: the segmented prefix sum of JAX's segment_cumsum
// (f2nerf_tpu/ops/segment.py:38-56): segments start at is_first, rows
// after the last flag keep accumulating into the last segment, and rows
// before the first flag (a buffer with no flag) form one segment;
// exclusive or inclusive. Reverse mode runs the same scan from the end
// over the same segments (each segment's suffix sums): the scan's
// backward. The sums are taken in float64, as the plain version's global
// cumsum is, and rounded to f32 once. Its port was a float64 cumsum minus
// a cummax base, whose backward is an index_add.
// A warp a ray would be the simplest order, but the last segment of a
// compacted buffer runs through all of its padding (100k+ rows in the
// slice's B buffer), which one warp would scan alone. So the buffer is cut
// into windows of kWin = 256 rows in scan order, a warp each, in two
// kernels launched by one call:
//   1. segment_scan_tail: each window's segmented scan from a zero carry;
//      its last row's value (the sum since the window's last segment start,
//      or the whole window's sum) and whether a segment starts in it go to
//      a scratch array;
//   2. segment_scan_kernel: each window's carry is the sum of those tails
//      from the nearest earlier window that holds a start up to the window
//      before it (read back 32 windows at a time, lanes in a fixed order,
//      then the xor tree); the window is scanned again from that carry.
// Within a window, chunks of 32 rows go through a warp scan of (value,
// start) pairs (shfl_up, 5 steps), the running sum carried from chunk to
// chunk. Every order depends only on the positions and the flags, never
// on timing.
//
// Bound: bytes. K10 reads the valid rows once and writes [R, C]; K11 reads
// x and the flags and writes the output (the second kernel reads x again,
// an L2 hit at these sizes). At the slice's B buffer (cap2 262,144) each
// is ~1-2 MB: under a microsecond at 3.35 TB/s. Both are latency-bound
// first designs: K10's search and strided loop, K11's two launches and
// its chain of chunks in a window.
//
// Measured (chip_smoke.py; NVIDIA H100 80GB HBM3, 700 W): K10 0.0078 /
// 0.0088 ms at 2,048 uniform rays of 192 rows, C = 1 / 6 (12% / 38% of
// the bound), 0.0074-0.0082 ms a call at the slice step (C = 16: 0.031);
// K11 0.0153 ms at the uniform shape, ~0.019 ms a call at the step's
// 262,144 rows (3.6% of the bound). 48 registers (K10), 44 and 61 (K11).
//
// No fast math and no contraction: the adds are __fadd_rn / __dadd_rn.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 8;                  // K10: channels a block sums
constexpr int kChunks = 8;                // K11: chunks of 32 rows a window
constexpr int kWin = kChunks * 32;        // K11: rows a window
constexpr unsigned kFull = 0xffffffffu;

// First index in [0, n) with a[i] >= key (n if none), the two halves of
// the warp each searching their own key (lanes 0-15 and 16-31): each round
// a half probes 16 positions spread over its interval and keeps the gap
// between the last probe below the key and the first at or above it (a is
// sorted, so the probes below the key are a prefix of the half's lanes).
// Every lane of the warp calls it.
__device__ __forceinline__ long long half_lower_bound(const int* __restrict__ a,
                                                      long long n, int key, int lane) {
  const int h = lane & 15;
  const int shift = lane & 16;
  long long lo = 0, hi = n;
  while (__any_sync(kFull, hi > lo)) {
    const long long len = hi - lo;
    const long long p = lo + len * (h + 1) / 17;        // in [lo, hi) when len > 0
    const bool ge = len > 0 && __ldg(a + p) >= key;
    const unsigned below = (~__ballot_sync(kFull, ge) >> shift) & 0xffffu;
    const int k = __popc(below);
    const long long p_prev = __shfl_sync(kFull, p, k > 0 ? k - 1 : 0, 16);
    const long long p_next = __shfl_sync(kFull, p, k < 16 ? k : 15, 16);
    if (len > 0) {
      if (k > 0) lo = p_prev + 1;
      if (k < 16) hi = p_next;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
segment_reduce_kernel(const float* __restrict__ x, const int* __restrict__ ray_id,
                      float* __restrict__ out, long long n, int n_rays, int C) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= n_rays) return;                                // the whole warp
  const int c0 = blockIdx.y * kTile;
  const int cn = min(kTile, C - c0);
  const long long b = half_lower_bound(ray_id, n, lane < 16 ? r : r + 1, lane);
  const long long s = __shfl_sync(kFull, b, 0);
  const long long e = __shfl_sync(kFull, b, 16);
  float acc[kTile];
#pragma unroll
  for (int c = 0; c < kTile; ++c) acc[c] = 0.0f;
  for (long long i = s + lane; i < e; i += 32) {
    const float* row = x + i * C + c0;
#pragma unroll
    for (int c = 0; c < kTile; ++c)
      if (c < cn) acc[c] = __fadd_rn(acc[c], __ldg(row + c));
  }
#pragma unroll
  for (int c = 0; c < kTile; ++c) {
    if (c < cn) {                                          // cn is the warp's
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[c] = __fadd_rn(acc[c], __shfl_xor_sync(kFull, acc[c], off));
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < kTile; ++c)
      if (c < cn) out[(long long)r * C + c0 + c] = acc[c];
  }
}

// Row q of the scan order: its value (0 past n) and whether a segment
// starts there. Forward, q is the row and segments start at is_first (and
// at row 0); reverse, q is row n - 1 - q, and a segment starts (from the
// end) at each segment's last row: row n - 1, and every row before a flag.
__device__ __forceinline__ void scan_row(const float* __restrict__ x,
                                         const unsigned char* __restrict__ first,
                                         long long n, int reverse, long long q,
                                         double& v, bool& start, long long& row) {
  if (q >= n) {
    v = 0.0; start = false; row = -1;
    return;
  }
  row = reverse ? n - 1 - q : q;
  v = (double)__ldg(x + row);
  start = q == 0 || __ldg(first + (reverse ? row + 1 : row)) != 0;
}

// The segmented scan of one window (rows w0 .. w0 + kWin - 1 of the scan
// order) from ``carry``: writes each row's output if ``out`` is given and
// returns the last row's inclusive value (the carry into the next window)
// and, through ``any_start``, whether a segment starts in the window.
__device__ __forceinline__ double scan_window(const float* __restrict__ x,
                                              const unsigned char* __restrict__ first,
                                              float* __restrict__ out, long long n,
                                              int exclusive, int reverse, long long w0,
                                              double carry, int lane, bool& any_start) {
  double v[kChunks];
  bool st[kChunks];
  long long row[kChunks];
#pragma unroll
  for (int k = 0; k < kChunks; ++k)                        // every load in flight at once
    scan_row(x, first, n, reverse, w0 + k * 32 + lane, v[k], st[k], row[k]);
  unsigned any = 0;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    // inclusive scan of (value, started) pairs over the chunk's lanes
    double inc = v[k];
    bool f = st[k];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double u = __shfl_up_sync(kFull, inc, off);
      const bool g = __shfl_up_sync(kFull, (int)f, off) != 0;
      if (lane >= off) {
        if (!f) inc = __dadd_rn(u, inc);
        f = f || g;
      }
    }
    if (!f) inc = __dadd_rn(carry, inc);                   // no start up to here: carry in
    const double before = __shfl_up_sync(kFull, inc, 1);
    if (out != nullptr && row[k] >= 0) {
      const double exc = st[k] ? 0.0 : (lane == 0 ? carry : before);
      out[row[k]] = (float)(exclusive ? exc : inc);
    }
    any |= __ballot_sync(kFull, st[k]);
    carry = __shfl_sync(kFull, inc, 31);
  }
  any_start = any != 0;
  return carry;
}

__global__ void __launch_bounds__(kThreads)
segment_scan_tail(const float* __restrict__ x, const unsigned char* __restrict__ first,
                  double* __restrict__ tail, unsigned char* __restrict__ has_start,
                  long long n, int reverse, long long n_win) {
  const int lane = threadIdx.x & 31;
  const long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= n_win) return;
  bool any;
  const double t = scan_window(x, first, nullptr, n, 0, reverse, w * kWin, 0.0, lane, any);
  if (lane == 0) {
    tail[w] = t;
    has_start[w] = any ? 1 : 0;
  }
}

__global__ void __launch_bounds__(kThreads)
segment_scan_kernel(const float* __restrict__ x, const unsigned char* __restrict__ first,
                    const double* __restrict__ tail,
                    const unsigned char* __restrict__ has_start, float* __restrict__ out,
                    long long n, int exclusive, int reverse, long long n_win) {
  const int lane = threadIdx.x & 31;
  const long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= n_win) return;
  // the carry: tails of windows w - 1, w - 2, ... down to the nearest one
  // that holds a start (its tail begins at that start), lane l taking
  // windows w - 1 - l - 32 j; then the xor tree
  double acc = 0.0;
  for (long long b = w - 1; b >= 0; b -= 32) {
    const long long q = b - lane;
    const bool in = q >= 0;
    const unsigned m = __ballot_sync(kFull, in && has_start[q] != 0);
    const int stop = m ? __ffs(m) - 1 : 31;
    if (in && lane <= stop) acc = __dadd_rn(acc, tail[q]);
    if (m) break;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __dadd_rn(acc, __shfl_xor_sync(kFull, acc, off));
  bool any;
  scan_window(x, first, out, n, exclusive, reverse, w * kWin, acc, lane, any);
}

}  // namespace

extern "C" int f2_segment_reduce(const void* x, const void* ray_id, void* out, long long n,
                                 int n_rays, int c, void* stream) {
  if (n_rays <= 0 || c <= 0) return 0;
  const dim3 grid((unsigned)((n_rays + kWarps - 1) / kWarps),
                  (unsigned)((c + kTile - 1) / kTile));
  segment_reduce_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const int*)ray_id, (float*)out, n, n_rays, c);
  return (int)cudaGetLastError();
}

// scratch: ceil(n / 256) doubles (tails), then as many bytes (has_start)
extern "C" int f2_segment_scan(const void* x, const void* is_first, void* out, void* tail,
                               void* has_start, long long n, int exclusive, int reverse,
                               void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const long long n_win = (n + kWin - 1) / kWin;
  const unsigned blocks = (unsigned)((n_win + kWarps - 1) / kWarps);
  segment_scan_tail<<<blocks, kThreads, 0, s>>>(
      (const float*)x, (const unsigned char*)is_first, (double*)tail,
      (unsigned char*)has_start, n, reverse, n_win);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  segment_scan_kernel<<<blocks, kThreads, 0, s>>>(
      (const float*)x, (const unsigned char*)is_first, (const double*)tail,
      (const unsigned char*)has_start, (float*)out, n, exclusive, reverse, n_win);
  return (int)cudaGetLastError();
}
