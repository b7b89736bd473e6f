// K10 and K11: the per-ray segment ops of the composite chain, each sum
// taken in a fixed order (no atomics), so a step gives the same bits on
// every run; and the offsets launch that both K10 and the renderer read.
//
// ray_offsets: for a ray-sorted buffer ray_id [n] (padding rows carry
// ray_id == n_rays), offsets [n_rays + 1] int32 (each ray's first row;
// offsets[n_rays] the first padding row, n if none), counts [n_rays] f32
// (end - start, exact), local_index [n] int32 (each row's index in its
// ray: the exclusive segmented scan of ones of f2nerf_tpu/ops/segment.py:65,
// padding rows continuing the last segment's count, a buffer with no valid
// row one segment from row 0) and first [n] bool (a row whose ray id
// differs from the previous row's and is below n_rays:
// first_flags_from_ray_id). Replaces the step's K10 launch over ones and
// its K11 launch over ones: all outputs are integers, so they equal those
// launches' values bit for bit. Two forms:
//   - computed: one cooperative launch (every block resident), a thread a
//     row over a grid-stride loop:
//     1. where ray_id changes at row i (row 0 after a virtual -1, row n
//        before a virtual n_rays), the thread writes offsets[q] = i for
//        every ray q in (previous, current], so an empty ray gets
//        start == end;
//     2. a grid-wide barrier;
//     3. the rest from the offsets (``segments_at``);
//   - given (the buffer's offsets from the kernel that made it: K12 writes
//     buffer A's, which the single-pass step's B is): step 3 alone, one
//     ordinary launch, a thread a row or ray.
// Step 3: counts[r] = offsets[r + 1] - offsets[r]; a valid row's local
// index is i - offsets[ray_id[i]], a padding row's i - offsets of the last
// ray that has rows (i when no ray has one); first[i] from ray_id[i - 1].
// K13 (csrc/compact.cu) writes the same four for the B buffer it makes.
// Bound: bytes, ray_id read once and the outputs written once; at the
// slice's B buffer (262,144 rows) ~2.4 MB, ~0.7 us at 3.35 TB/s.
//
// K10, segment_reduce: out[r, c] = sum of x[i, c] over the rows of ray r,
// [offsets[r], offsets[r + 1]), for a ray-sorted flat buffer x [n, C] f32.
// Replaces jax.ops.segment_sum with indices_are_sorted=True
// (f2nerf_tpu/ops/segment.py:23). One warp a ray, all C channels in one
// pass; each ray's run comes from two loads of offsets (an earlier design
// searched ray_id in every call and in every tile of 8 channels). Two
// paths:
//   - vector, where C = 4Q with Q dividing 32 (C = 4, 8, 16, ...) and the
//     rows are 16-byte aligned: Q lanes a row, each lane a float4 quad of it, the
//     warp's 32 / Q row groups striding the rows (lane l sums quad l % Q of
//     rows start + l / Q, start + l / Q + 32 / Q, ... in that order), then a
//     fixed __shfl_xor_sync tree over the lanes that hold one quad;
//   - scalar, any other C (1, 2, 6 on the step): lane l sums rows start + l,
//     start + l + 32, ... in that order, up to 8 channels at a time (a loop
//     over tiles of 8 channels when C > 8), then the xor tree over all 32
//     lanes.
// The vector path issues kUnrollVec row steps' loads at a time, then adds
// them in row order; the scalar path loads and adds a row a step (unrolling
// it was no faster). The rows may be a column slice of a wider buffer (x's
// row stride ld): the C = 16 backward's gradient is one, which a copy to
// contiguous rows cost ~0.015 ms. A ray's rows are held to x's n rows, so
// offsets of another buffer cannot send a warp past x's end.
// Every order depends only on the positions and C, never on timing, so
// every launch repeats bit for bit; a channel's bits may differ with C
// (the two paths stride the rows differently).
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
// Bound: bytes. K10 reads the valid rows and the offsets once and writes
// [R, C]; K11 reads x and the flags once and writes the output. At the slice's B buffer
// (cap2 262,144) each is ~1-2 MB, K10's C = 16 backward ~10 MB: a few
// microseconds at most at 3.35 TB/s.
//
// Measured (chip_smoke.py --baseline, the earlier K10 in turns on the same
// inputs; NVIDIA H100 80GB HBM3, 700 W): at the slice step K10 0.0063-0.0070
// ms a call (the earlier, searching K10 0.0075-0.0082; the C = 16 backward,
// 16 columns of a 32-wide gradient read in place, 0.0070 against 0.0307
// with its copy), the offsets launch 0.0091; a launch that reads the
// offsets and no row takes 0.0050, as a one-element torch add does
// (scripts/sweep_kernels.py). K11: ~0.012 ms a call at the step's 262,144
// rows and at the uniform 393,216, against ~0.020 and ~0.015 for the
// two-launch design in the same call; the look-back ~0.0015 ms of K11's
// (scripts/sweep_kernels.py).

// No fast math and no contraction: the adds are __fadd_rn / __dadd_rn.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 8;                  // K10's scalar path: channels a pass
constexpr int kUnrollVec = 4;             // K10's vector path: row steps loaded
                                          // before their adds (scripts/sweep_kernels.py)
constexpr int kChunks = 8;                // K11: chunks of 32 rows a warp
constexpr int kWarpRows = kChunks * 32;   // K11: rows a warp
constexpr int kTileRows = kWarps * kWarpRows;   // K11: rows a block (a tile)
constexpr unsigned kFull = 0xffffffffu;

// ray_offsets' step 3 at index i (see the header): a ray's count, a row's
// local index and first flag. last_start: the first row of the last ray
// that has rows (0 if none).
__device__ __forceinline__ void segments_at(const int* __restrict__ ray_id, const int* offsets,
                                            float* __restrict__ counts, int* __restrict__ local,
                                            unsigned char* __restrict__ first, long long n,
                                            int n_rays, long long i, int last_start) {
  if (i < n_rays) counts[i] = (float)(offsets[i + 1] - offsets[i]);
  if (i < n) {
    const int r = __ldg(ray_id + i);
    local[i] = (int)(i - (r < n_rays ? offsets[r] : last_start));
    first[i] = r < n_rays && (i == 0 || __ldg(ray_id + i - 1) != r);
  }
}

__device__ __forceinline__ int last_ray_start(const int* __restrict__ ray_id, const int* offsets,
                                              int n_rays) {
  const int first_pad = offsets[n_rays];
  return first_pad > 0 ? offsets[min(ray_id[first_pad - 1], n_rays - 1)] : 0;
}

// ray_offsets, the computed form. A cooperative launch: the grid is at
// most what the card holds at once, so the barrier is reached by every
// block.
__global__ void __launch_bounds__(kThreads)
ray_offsets_kernel(const int* __restrict__ ray_id, int* offsets, float* __restrict__ counts,
                   int* __restrict__ local, unsigned char* __restrict__ first, long long n,
                   int n_rays) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long i0 = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (long long i = i0; i <= n; i += stride) {
    const int prev = i == 0 ? -1 : min(__ldg(ray_id + i - 1), n_rays);
    const int cur = i == n ? n_rays : min(__ldg(ray_id + i), n_rays);
    for (int q = prev + 1; q <= cur; ++q) offsets[q] = (int)i;
  }
  cooperative_groups::this_grid().sync();
  const int last_start = last_ray_start(ray_id, offsets, n_rays);
  for (long long i = i0; i < n || i < n_rays; i += stride)
    segments_at(ray_id, offsets, counts, local, first, n, n_rays, i, last_start);
}

// ray_offsets, the given form: step 3 alone, a thread a row or ray.
__global__ void __launch_bounds__(kThreads)
ray_segments_kernel(const int* __restrict__ ray_id, const int* __restrict__ offsets,
                    float* __restrict__ counts, int* __restrict__ local,
                    unsigned char* __restrict__ first, long long n, int n_rays) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  segments_at(ray_id, offsets, counts, local, first, n, n_rays, i,
              last_ray_start(ray_id, offsets, n_rays));
}

// Ray r's rows [s, e) from the offsets, held to x's rows [0, n).
__device__ __forceinline__ void ray_rows(const int* __restrict__ offsets, int r, long long n,
                                         long long& s, long long& e) {
  e = min((long long)__ldg(offsets + r + 1), n);
  s = max(0LL, min((long long)__ldg(offsets + r), e));
}

// K10's vector path: Q lanes a row (C = 4Q, Q dividing 32), each lane one
// float4 quad; the 32 / Q row groups stride the rows.
__global__ void __launch_bounds__(kThreads)
segment_reduce_vec_kernel(const float4* __restrict__ x, long long ld4, long long n,
                          const int* __restrict__ offsets, float4* __restrict__ out, int n_rays,
                          int Q) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= n_rays) return;                                // the whole warp
  const int G = 32 / Q;                                   // rows a step
  const int q = lane % Q;
  long long s, e;
  ray_rows(offsets, r, n, s, e);
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (long long i = s + lane / Q; i < e; i += (long long)G * kUnrollVec) {
    float4 v[kUnrollVec];
#pragma unroll
    for (int u = 0; u < kUnrollVec; ++u)
      if (i + u * G < e) v[u] = __ldg(x + (i + u * G) * ld4 + q);
#pragma unroll
    for (int u = 0; u < kUnrollVec; ++u) {
      if (i + u * G < e) {
        acc.x = __fadd_rn(acc.x, v[u].x);
        acc.y = __fadd_rn(acc.y, v[u].y);
        acc.z = __fadd_rn(acc.z, v[u].z);
        acc.w = __fadd_rn(acc.w, v[u].w);
      }
    }
  }
  for (int off = 16; off >= Q; off >>= 1) {               // Q is the warp's
    acc.x = __fadd_rn(acc.x, __shfl_xor_sync(kFull, acc.x, off));
    acc.y = __fadd_rn(acc.y, __shfl_xor_sync(kFull, acc.y, off));
    acc.z = __fadd_rn(acc.z, __shfl_xor_sync(kFull, acc.z, off));
    acc.w = __fadd_rn(acc.w, __shfl_xor_sync(kFull, acc.w, off));
  }
  if (lane < Q) out[(long long)r * Q + lane] = acc;
}

// K10's scalar path: a lane a row, up to kTile channels at a time.
__global__ void __launch_bounds__(kThreads)
segment_reduce_kernel(const float* __restrict__ x, long long ld, long long n,
                      const int* __restrict__ offsets, float* __restrict__ out, int n_rays,
                      int C) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= n_rays) return;                                // the whole warp
  long long s, e;
  ray_rows(offsets, r, n, s, e);
  for (int c0 = 0; c0 < C; c0 += kTile) {
    const int cn = min(kTile, C - c0);
    float acc[kTile];
#pragma unroll
    for (int c = 0; c < kTile; ++c) acc[c] = 0.0f;
    for (long long i = s + lane; i < e; i += 32) {
      const float* row = x + i * ld + c0;
#pragma unroll
      for (int c = 0; c < kTile; ++c)
        if (c < cn) acc[c] = __fadd_rn(acc[c], __ldg(row + c));
    }
#pragma unroll
    for (int c = 0; c < kTile; ++c) {
      if (c < cn) {                                        // cn is the warp's
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

// offsets [n_rays + 1] int32, counts [n_rays] f32, local [n] int32, first
// [n] bool, n >= 1 (the caller fills an empty buffer's offsets). given = 0:
// the kernel writes the offsets (a grid of at most what the card holds at
// once, read once a device and process, at most a thread a row); given =
// 1: offsets are the buffer's, read only.
extern "C" int f2_ray_offsets(const void* ray_id, void* offsets, void* counts, void* local,
                              void* first, long long n, int n_rays, int given, void* stream) {
  if (n <= 0 || n_rays < 0) return (int)cudaErrorInvalidValue;
  const int* rid = (const int*)ray_id;
  int* off = (int*)offsets;
  float* cnt = (float*)counts;
  int* loc = (int*)local;
  unsigned char* fst = (unsigned char*)first;
  const long long span = n + 1 > n_rays ? n + 1 : (long long)n_rays;   // threads of work
  const long long want = (span + kThreads - 1) / kThreads;
  if (given) {
    ray_segments_kernel<<<(unsigned)want, kThreads, 0, (cudaStream_t)stream>>>(
        rid, off, cnt, loc, fst, n, n_rays);
    return (int)cudaGetLastError();
  }
  static int resident[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ray_offsets_kernel, kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    if (sms * per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
    resident[dev] = sms * per_sm;
  }
  const unsigned grid = (unsigned)(want < resident[dev] ? want : resident[dev]);
  void* args[] = {&rid, &off, &cnt, &loc, &fst, &n, &n_rays};
  e = cudaLaunchCooperativeKernel((const void*)ray_offsets_kernel, dim3(grid), dim3(kThreads),
                                  args, 0, (cudaStream_t)stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// x: n rows of c floats, ld floats apart (ld >= c; a column slice of a
// wider buffer is read in place); out [n_rays, c] contiguous. offsets:
// ray_offsets' [n_rays + 1] (each ray's rows, in order; rows at or past n
// are not read). The vector path where c = 4Q with Q dividing 32, ld a
// multiple of 4 and x and out 16-byte aligned.
extern "C" int f2_segment_reduce(const void* x, long long ld, long long n, const void* offsets,
                                 void* out, int n_rays, int c, void* stream) {
  if (n_rays <= 0 || c <= 0) return 0;
  if (ld < c || n < 0) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((n_rays + kWarps - 1) / kWarps);
  const int q = c / 4;
  if (c % 4 == 0 && q <= 32 && 32 % q == 0 && ld % 4 == 0 && ((uintptr_t)x & 15) == 0 &&
      ((uintptr_t)out & 15) == 0) {
    segment_reduce_vec_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float4*)x, ld / 4, n, (const int*)offsets, (float4*)out, n_rays, q);
  } else {
    segment_reduce_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)x, ld, n, (const int*)offsets, (float*)out, n_rays, c);
  }
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
