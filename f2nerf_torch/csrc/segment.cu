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
// into tiles of kTileRows = 2,048 rows in scan order, a block each (8
// warps of 256 rows), in one launch (an earlier design took two: the
// windows' tails, then each window's scan again from its carry; its carry
// loop read back one 256-row window a lane until a window held a start,
// ~15 dependent rounds through the B buffer's padding):
//   1. a block takes its tile from an atomic ticket, so it waits only on
//      tiles that are already running; its warps scan their rows from a
//      zero carry (chunks of 32 rows through a warp scan of (value, start)
//      pairs, shfl_up, 5 steps; the running sum carried chunk to chunk)
//      and keep the values in registers;
//   2. the warps' (tail, has_start) pairs combine in order into the tile's
//      aggregate, published with a flag;
//   3. the tile's carry is the sum of the aggregates from the nearest
//      earlier tile that holds a start up to the tile before it, lane l
//      taking tiles tile - 1 - l - 32 j, each waited for until published,
//      then the xor tree (decoupled look-back over aggregates only: an
//      earlier tile's inclusive prefix is never read, since whether it is
//      ready would depend on timing, and with it the order of the adds);
//      at the slice's 262,144 rows (128 tiles), at most four rounds;
//   4. each warp's carry follows from the tile's and the warps before it,
//      and each row without a start before it in its warp adds it;
//   5. the last block to finish puts the ticket, its own counter and the
//      flags back to zero, so a call needs no reset on the stream and no
//      host sync (the state persists between calls: ops/segment.py
//      keeps one zeroed buffer a device and stream).
// Every order depends only on the positions and the flags, never on
// timing, so every launch repeats bit for bit.
//
// Bound: bytes. K10 reads the valid rows once and writes [R, C]; K11 reads
// x and the flags once and writes the output. At the slice's B buffer
// (cap2 262,144) each is ~1-2 MB: under a microsecond at 3.35 TB/s. Both
// are latency-bound: K10's search and strided loop, K11's loads, scans and
// look-back rounds in one block's life.
//
// Measured (chip_smoke.py; NVIDIA H100 80GB HBM3, 700 W): K10 0.0078 /
// 0.0088 ms at 2,048 uniform rays of 192 rows, C = 1 / 6 (12% / 38% of
// the bound), 0.0074-0.0082 ms a call at the slice step (C = 16: 0.031).
// K11: ~0.012 ms a call at the step's 262,144 rows and at the uniform
// 393,216, against ~0.020 and ~0.015 for the two-launch design in the same
// call; a one-element torch add takes ~0.005 ms timed the same way, and
// the look-back ~0.0015 ms of K11's (scripts/sweep_k8_k11.py).

// No fast math and no contraction: the adds are __fadd_rn / __dadd_rn.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 8;                  // K10: channels a block sums
constexpr int kChunks = 8;                // K11: chunks of 32 rows a warp
constexpr int kWarpRows = kChunks * 32;   // K11: rows a warp
constexpr int kTileRows = kWarps * kWarpRows;   // K11: rows a block (a tile)
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

// Publication between blocks: a release store of the flag after the tail,
// an acquire load of it before the tail is read (gpu scope)
__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
// the done counter: the block's reads before it, the last block's resets
// after it
__device__ __forceinline__ unsigned add_acq_rel(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

// A tile's published aggregate: its tail (the sum from its last segment
// start to its end, or its whole sum) and a flag, 0 until published, then
// 1 + whether a segment starts in the tile.
struct TileAgg {
  double tail;
  int flag;
  int pad;
};

__global__ void __launch_bounds__(kThreads)
segment_scan_kernel(const float* __restrict__ x, const unsigned char* __restrict__ first,
                    float* __restrict__ out, long long n, int exclusive, int reverse,
                    unsigned n_tiles, unsigned* __restrict__ counters,
                    TileAgg* __restrict__ agg) {
  __shared__ unsigned s_tile;
  __shared__ bool s_last;
  __shared__ double s_tail[kWarps], s_carry[kWarps];
  __shared__ bool s_has[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // the tile from a ticket: a block waits only on tiles taken before it,
  // which are running or done
  if (threadIdx.x == 0) s_tile = atomicAdd(counters, 1u);
  __syncthreads();
  const unsigned tile = s_tile;

  // 1. each warp's rows from a zero carry: inc, each row's inclusive value
  // since the warp's first row or its latest start; seen, a start at or
  // before the row (bit k of the masks is chunk k)
  const long long w0 = (long long)tile * kTileRows + (long long)warp * kWarpRows;
  double v[kChunks];
  bool st[kChunks];
  long long row[kChunks];
#pragma unroll
  for (int k = 0; k < kChunks; ++k)                        // every load in flight at once
    scan_row(x, first, n, reverse, w0 + k * 32 + lane, v[k], st[k], row[k]);
  double carry = 0.0;
  bool seen_before = false;                                // a start in earlier chunks
  unsigned seen = 0;
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
    if (!f && k > 0) inc = __dadd_rn(carry, inc);          // no start up to here: carry in
    v[k] = inc;
    if (f || seen_before) seen |= 1u << k;
    carry = __shfl_sync(kFull, inc, 31);
    seen_before = seen_before || __any_sync(kFull, st[k]);
  }
  if (lane == 0) {
    s_tail[warp] = carry;
    s_has[warp] = seen_before;
  }
  __syncthreads();

  // 2. the tile's aggregate, the warps combined in order, published
  if (threadIdx.x == 0) {
    double a = 0.0;
    bool h = false;
    for (int w = 0; w < kWarps; ++w) {
      a = s_has[w] ? s_tail[w] : __dadd_rn(a, s_tail[w]);
      h = h || s_has[w];
    }
    agg[tile].tail = a;
    store_release(&agg[tile].flag, 1 + (h ? 1 : 0));
  }

  // 3. the tile's carry: the aggregates of tiles tile - 1, tile - 2, ...
  // down to the nearest one that holds a start (its tail begins at that
  // start), lane l taking tiles tile - 1 - l - 32 j, each waited for until
  // published; then the xor tree. Only aggregates are read, never an
  // earlier tile's inclusive prefix, so the order of every add is fixed by
  // the positions and the flags alone.
  if (warp == 0) {
    double acc = 0.0;
    for (long long b = (long long)tile - 1; b >= 0; b -= 32) {
      const long long q = b - lane;
      int flag = 0;
      double t = 0.0;
      if (q >= 0) {
        while ((flag = load_acquire(&agg[q].flag)) == 0) {
        }
        t = *(const volatile double*)&agg[q].tail;
      }
      const unsigned m = __ballot_sync(kFull, flag == 2);
      const int stop = m ? __ffs(m) - 1 : 31;
      if (q >= 0 && lane <= stop) acc = __dadd_rn(acc, t);
      if (m) break;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc = __dadd_rn(acc, __shfl_xor_sync(kFull, acc, off));
    // each warp's carry: the tile's, then the warps before it in order
    if (lane == 0) {
      double c = acc;
      for (int w = 0; w < kWarps; ++w) {
        s_carry[w] = c;
        c = s_has[w] ? s_tail[w] : __dadd_rn(c, s_tail[w]);
      }
    }
  }
  __syncthreads();

  // 4. the rows: a row with no start at or before it in its warp's rows
  // takes the warp's carry; exclusive values are the previous row's
  // inclusive one (0 at a start)
  const double wc = s_carry[warp];
  double prev = wc;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const double inc = (seen >> k) & 1u ? v[k] : __dadd_rn(wc, v[k]);
    const double before = __shfl_up_sync(kFull, inc, 1);
    if (row[k] >= 0) {
      const double exc = st[k] ? 0.0 : (lane == 0 ? prev : before);
      out[row[k]] = (float)(exclusive ? exc : inc);
    }
    prev = __shfl_sync(kFull, inc, 31);
  }

  // 5. the last block to finish puts the counters and flags back to zero
  // for the next call (every other block has done all its reads)
  __syncthreads();
  if (threadIdx.x == 0) s_last = add_acq_rel(counters + 1, 1u) == n_tiles - 1;
  __syncthreads();
  if (s_last) {
    for (unsigned i = threadIdx.x; i < n_tiles; i += kThreads) agg[i].flag = 0;
    if (threadIdx.x == 0) {
      counters[0] = 0;
      counters[1] = 0;
    }
  }
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

// state: the ticket and done counters (zero between calls), 8 bytes of
// padding, then a 16-byte aggregate a tile (flags zero between calls):
// 16 * (1 + ceil(n / 2048)) bytes at least, zeroed once when allocated.
extern "C" int f2_segment_scan(const void* x, const void* is_first, void* out, void* state,
                               long long n, int exclusive, int reverse, void* stream) {
  if (n <= 0) return 0;
  const long long n_tiles = (n + kTileRows - 1) / kTileRows;
  if (n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  segment_scan_kernel<<<(unsigned)n_tiles, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const unsigned char*)is_first, (float*)out, n, exclusive, reverse,
      (unsigned)n_tiles, (unsigned*)state, (TileAgg*)((char*)state + 16));
  return (int)cudaGetLastError();
}
