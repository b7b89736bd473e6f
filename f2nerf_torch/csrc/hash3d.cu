// K5 / K6: the Hash3DAnchored encode and its pool-gradient scatter.
//
// Replace the XLA lowerings of f2nerf_tpu/fields/hash_encoding.py:
//   K5 hash3d_fwd  <- hash_encode's forward (:135-151)
//   K6 hash3d_bwd  <- _hash_encode_bwd      (:161-171)
//
// Index math (both kernels), exactly as hash_encoding.py:102-131:
//   x = p*scale + bias (per axis), f = floor(x), a = x - f,
//   h0 = uint32(int(f)) * prime, h1 = h0 + prime (the corner one cell up),
//   idx = ((hx ^ hy ^ hz) mod local_size) + level * local_size,
//   w = (wx * wy) * wz with w_axis = a or 1 - a, corners c = 0..7 (bit 2
//   x, bit 1 y, bit 0 z), summed in that order from 0.
// It uses __fmul_rn/__fadd_rn/__fsub_rn: nvcc contracts a*b + c into an
// FMA by default, and one ulp of x moves a sample across a cell, which
// changes all eight corners. So K5 is bit for bit its plain version.
// The pool is [pool, 2] f32, a corner's two channels one 8-byte float2;
// a level's slice is local_size entries (4 MB at log2_table_size 19, the
// whole pool 67 MB, past the 50 MB L2).
//
// K5's layout of the work, as csrc/hash_block.cu's K2. A block takes a
// tile of 32 consecutive samples and a group of G consecutive levels;
// warp w works level G*group + w over the tile, one sample a lane, so a
// warp's lanes are neighbours along a ray at one level. The grid runs the
// level groups one after another (block = group * tiles + tile), so only G
// levels' slices (4G MB at 2^19) are in flight and stay in L2. Only speed
// depends on blocks being scheduled roughly in that order. G was chosen on
// the card from 1, 2, 4 and 8 (chip_smoke.py --phases
// device,build,kernels,variants, NVIDIA H100 80GB HBM3, 700 W; ms at the
// uniform shape / the reference-semantics step's A / B + edges):
// G 1 0.594 / 0.336 / 0.287, G 2 0.516 / 0.208 / 0.206, G 4 0.490 /
// 0.163 / 0.184, G 8 0.635 / 0.189 / 0.212: G = 4 (also a sample's 4
// levels are 8 floats, one 32-byte sector of its output row, written
// whole). G = 1 blocks are one warp, and the SM's 32-block limit halves
// their occupancy; G = 8 puts 33 MB in flight. All 16 levels in one block
// (G = 16) took 1.017 / 0.274 / 0.294, as much as one thread a (sample,
// level): the level groups are the gain.
//
// K5. Bound: the bytes it must move, points and volumes (16 B a sample),
// the distinct pool entries it touches (8 B each) read once, the output
// (128 B a sample) written once. Each lane issues its eight float2 corner
// loads with no dependence between them and sums them c = 0..7 from 0;
// the tile's [32, 2G] output is staged in shared memory and written 16
// bytes a thread (8 when G = 1). One thread a (sample, level) with all 16
// levels in flight took 1.02 ms at chip_smoke's uniform shape (3.5% of
// its bound). What is left is most likely L2's rate for random sectors
// (not measured): every corner is a random 8-byte load, one 32-byte
// sector (50M sectors at the uniform shape).
//
// K6. The dense [pool, 2] gradient, each entry stored exactly once (an
// entry no active sample touches as +0.0: the caller does not zero-fill
// it), its sums taken in an order that the inputs alone fix, so every run
// gives the same bits. No float atomic: the only atomics are integer
// counts in shared memory, and a count does not depend on the order of
// its additions.
//
// The order. A (sample, level) pair is active where its two gradient
// values are not both zero (the grad pass's padding rows drop out; NaN is
// active). Per level, the samples are taken in groups of 32 consecutive
// ones (0-31, 32-63, ...); in a group, a run is a maximal stretch of
// active samples in one cell (volume and floors), whose 8 corners are one
// set of entries: neighbours along a ray share the coarse levels' cells.
// A sample's corner value is (g_0 * w_c, g_1 * w_c); within a group the
// values are scanned over their runs in doubling steps, v_i = v_(i-o) +
// v_i for o = 1, 2, 4, 8, 16 where sample i - o is in i's run (each step
// from the one before), and a run's last sample holds the run's value.
// The records are listed by group, within a group corner by corner (c =
// 0..7), within a corner the runs in order: record value the run's, entry
// e = hash mod local_size. The entries of a level are cut into 2^hi
// buckets of 2^lo consecutive entries (lo = log2(local_size) - hi, hi =
// min(10, log2(local_size))), and each bucket's records, in list order,
// into chunks of kChunk = 2,048 positions. Entry e is ((+0 + T_0) + T_1)
// + ... over the chunks of its bucket in order, where T_k adds e's
// records inside chunk k to +0 one at a time in list order (a chunk
// without them adds +0, which changes nothing: no such sum is ever -0.0).
// An entry no record reaches is +0.0. Where a run ends or a chunk cuts a
// bucket depends on the inputs alone; nothing depends on the grid or the
// scheduling. hash_encode_bwd_plain (fields/hash_encoding.py) sums in this
// order: K6 is bit for bit its plain version on the card, NaN and inf
// included.
//
// The launches, queued by one C call (every size from n and local_size;
// no count is read back, so the call can be captured in a CUDA graph):
//  1. hist: a block a (level, tile of 8,192 samples), a warp 1,024 of them,
//     a lane a sample 32 at a time: each active pair located (the
//     rounding above), the group's runs found (shuffles of the cells, one
//     ballot of the runs' starts) and each run's 8 records counted by
//     bucket;
//  2. scan: a warp a (level, bucket): its counts over the tiles,
//     exclusive, in place, and its total;
//  3. scatter, a stable counting sort of each level's records by bucket:
//     block (level, tile), 16 warps, takes the tile in rounds of 1,024
//     samples (a round with no active pair is skipped), a warp two groups
//     of 32, a lane one sample of each, the runs found as the hist did;
//     in 16 steps (a group's corners in turn) it ranks
//     each record among the warp's earlier ones of its bucket (peers from
//     hi + 1 ballots); the 16 warps' counts are scanned per bucket, the
//     round's records are computed again (a run's value: 5 doubling
//     steps of shuffles), staged in shared memory in
//     bucket order and written out so, a bucket's to consecutive
//     positions, one 16-byte store a record (its value, 8 bytes, and its
//     entry's low lo bits: 2-byte stores of the bits alone took 0.22 of
//     0.73 ms at the reference step's inputs; the rounds' 8,192 records
//     put ~8 in a bucket where 4,096 put ~4);
//     block (level, 0) writes the level's bucket starts;
//  4. reduce: a block a (level, bucket) walks the bucket's chunks in
//     order: a stable counting sort of the chunk by entry in shared memory
//     (the same ballots, lo + 1 of them, and per-warp counts over the
//     bucket's 2^lo entries: their zeroing and scan cost the chunk, so
//     buckets stay at 2^lo <= 1,024 entries), then thread t sums the runs
//     of entries t, t + 256, ... into their accumulators (registers), and
//     at the end stores the bucket's 2^lo entries, every one of them.
// Bound: g (128 B a sample), points and volumes (16 B) read once and the
// dense gradient (67 MB at 2^19) written once. The records add 16 B
// written and read once each (PERF.md §6 has the times). Scratch: 16 B x
// 8 records x 16 levels a sample, and the tiles' counts.
// The atomic K6 this replaced (lanes of a warp merged on a shared cell
// with __match_any_sync, then float2 atomicAdd into a zero-filled
// gradient; level groups of 2) took 0.2812-0.3170 ms at the
// reference-semantics step's inputs and 0.7565-0.7572 ms at the uniform
// shape (NVIDIA H100 80GB HBM3, 700 W).
//
// 64-bit offsets throughout; each entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLevels = 16;
constexpr int kTile = 32;        // K5: samples a block, one a lane

// A block's share of the levels: G consecutive levels, one warp each.
template <int G>
struct LevelGroup {
  static constexpr int kCount = kLevels / G;
  static constexpr int kThreads = 32 * G;
  static constexpr int kFloats = 2 * G;           // a sample's G levels x 2
  static constexpr int kRowStride = kFloats + 4;  // staged rows, padded:
                                                  // 16-B aligned for G >= 2
  static_assert(kLevels % G == 0, "G levels: 1, 2, 4, 8 or 16");
};
// K5's level group width (see the notes at the top).
constexpr int kFwdGroup = 4;

struct Cell {
  uint32_t h0[3], h1[3];
  float a[3];
};

// The index math on loaded values: p the point, pr and bi the level's
// primes and bias of its volume.
__device__ __forceinline__ void locate_at(const float* p, const int* pr,
                                          const float* bi, float scale, Cell* c) {
  for (int ax = 0; ax < 3; ++ax) {
    const float x = __fadd_rn(__fmul_rn(p[ax], scale), bi[ax]);
    const float f = floorf(x);
    c->a[ax] = __fsub_rn(x, f);
    c->h0[ax] = (uint32_t)(int)f * (uint32_t)pr[ax];
    c->h1[ax] = c->h0[ax] + (uint32_t)pr[ax];
  }
}

__device__ __forceinline__ void locate(const float* p, int vi,
                                       const int* __restrict__ prim,
                                       const float* __restrict__ bias,
                                       const float* __restrict__ scales, int l,
                                       int nv, Cell* c) {
  const long long pb = ((long long)l * nv + vi) * 3;
  const int pr[3] = {prim[pb], prim[pb + 1], prim[pb + 2]};
  const float bi[3] = {bias[pb], bias[pb + 1], bias[pb + 2]};
  locate_at(p, pr, bi, scales[l], c);
}

// Corner k's entry in its level (hash mod local_size, a power of two: the
// low bits) and weight.
__device__ __forceinline__ void corner_entry(const Cell& c, int k, uint32_t lsz,
                                             uint32_t* e, float* w) {
  const int bx = (k >> 2) & 1, by = (k >> 1) & 1, bz = k & 1;
  const uint32_t h = (bx ? c.h1[0] : c.h0[0]) ^ (by ? c.h1[1] : c.h0[1]) ^
                     (bz ? c.h1[2] : c.h0[2]);
  *e = h & (lsz - 1u);
  const float wx = bx ? c.a[0] : __fsub_rn(1.0f, c.a[0]);
  const float wy = by ? c.a[1] : __fsub_rn(1.0f, c.a[1]);
  const float wz = bz ? c.a[2] : __fsub_rn(1.0f, c.a[2]);
  *w = __fmul_rn(__fmul_rn(wx, wy), wz);
}

// The tile's points and volumes into shared memory.
__device__ __forceinline__ void load_points(const float* __restrict__ pts,
                                            const int* __restrict__ vol,
                                            long long base, int cnt,
                                            float* spts, int* svol) {
  for (int t = threadIdx.x; t < cnt * 3; t += blockDim.x)
    spts[t] = pts[base * 3 + t];
  if (threadIdx.x < cnt) svol[threadIdx.x] = vol[base + threadIdx.x];
}

template <int G>
__global__ void __launch_bounds__(LevelGroup<G>::kThreads)
hash3d_fwd_kernel(const float2* __restrict__ feat, const int* __restrict__ prim,
                  const float* __restrict__ bias, const float* __restrict__ scales,
                  const float* __restrict__ pts, const int* __restrict__ vol,
                  float* __restrict__ out, long long n, long long tiles, int nv,
                  uint32_t lsz) {
  using LG = LevelGroup<G>;
  __shared__ float spts[kTile * 3];
  __shared__ int svol[kTile];
  __shared__ __align__(16) float sout[kTile * LG::kRowStride];
  const int group = (int)(blockIdx.x / tiles);
  const long long base = (blockIdx.x % tiles) * kTile;
  const int cnt = (int)min((long long)kTile, n - base);
  load_points(pts, vol, base, cnt, spts, svol);
  __syncthreads();

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (lane < cnt) {
    const int l = group * G + w;
    Cell c;
    locate(spts + lane * 3, svol[lane], prim, bias, scales, l, nv, &c);
    long long idx[8];
    float wt[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      uint32_t e;
      corner_entry(c, k, lsz, &e, &wt[k]);
      idx[k] = (long long)e + (long long)l * lsz;
    }
    float2 r[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) r[k] = feat[idx[k]];
    float acc0 = 0.0f, acc1 = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      acc0 = __fadd_rn(acc0, __fmul_rn(r[k].x, wt[k]));
      acc1 = __fadd_rn(acc1, __fmul_rn(r[k].y, wt[k]));
    }
    *reinterpret_cast<float2*>(sout + lane * LG::kRowStride + 2 * w) =
        make_float2(acc0, acc1);
  }
  __syncthreads();
  // each sample's G levels, out[s, 2G*group .. 2G*group + 2G)
  float* row = out + base * (2 * kLevels) + group * LG::kFloats;
  if constexpr (LG::kFloats % 4 == 0) {
    constexpr int kQuads = LG::kFloats / 4;
    if (threadIdx.x < cnt * kQuads) {
      const int s = threadIdx.x / kQuads, q = threadIdx.x % kQuads;
      reinterpret_cast<float4*>(row + s * (2 * kLevels))[q] =
          reinterpret_cast<const float4*>(sout + s * LG::kRowStride)[q];
    }
  } else if (threadIdx.x < cnt) {
    *reinterpret_cast<float2*>(row + threadIdx.x * (2 * kLevels)) =
        *reinterpret_cast<const float2*>(sout + threadIdx.x * LG::kRowStride);
  }
}

// ---------------------------------------------------------------- K6

constexpr int kBlock = 256;                    // threads of K6's hist and reduce blocks
constexpr int kWarps = kBlock / 32;
constexpr int kScatterBlock = 512;             // threads of a scatter block
constexpr int kScatterWarps = kScatterBlock / 32;
constexpr int kMaxHi = 10;                     // bucket bits: at most 1,024 buckets
constexpr int kMaxBuckets = 1 << kMaxHi;
constexpr int kMaxLo = 10;                     // entry bits in a bucket: local_size <= 2^20
constexpr int kMaxWidth = 1 << kMaxLo;
constexpr int kBucketsPerThread = kMaxBuckets / kScatterBlock;  // a scatter thread's buckets
constexpr int kWidthPerThread = kMaxWidth / kBlock;  // a reduce thread's entries
constexpr int kTileSamples = 8192;             // samples a hist / scatter block
constexpr int kWarpSamples = kTileSamples / kWarps;  // a hist warp's 1,024
constexpr int kRoundSamples = 64 * kScatterWarps;    // a scatter round: 2 a lane
constexpr int kRoundRecords = 8 * kRoundSamples;     // 8,192
constexpr int kRecSteps = 16;                  // a scatter warp's steps of 32 records
constexpr int kChunk = 2048;                   // records a reduce chunk: the order
constexpr int kChunkSteps = kChunk / kBlock;   // 8 steps of 32 records a warp
constexpr int kScanWarps = 8;                  // (level, bucket) pairs a scan block
static_assert(kBucketsPerThread * kScatterBlock == kMaxBuckets &&
                  kWidthPerThread * kBlock == kMaxWidth,
              "a thread's digits cover the buckets and a bucket's entries");
static_assert(kTileSamples % kRoundSamples == 0 && kWarpSamples % 32 == 0,
              "whole groups of 32 samples");

// K6 scratch, one buffer cut into these pieces.
struct Scratch {
  int* hist;        // [16, 1024, tiles] a tile's records by bucket, then their
                    // offsets (the scan's, in place)
  int* totals;      // [16, 1024] a level's records by bucket
  int* starts;      // [16, 1025] a level's bucket starts and its record count
  uint4* rec;       // [16, 8n] the bucketed records: value (2 floats), the
                    // entry's low lo bits, unused
};

long long up256(long long bytes) { return (bytes + 255) / 256 * 256; }

// The pieces of the scratch buffer at ``base`` (nullptr: only the size);
// returns its size in bytes.
long long scratch_layout(void* base, long long n, Scratch* s) {
  const long long tiles = (n + kTileSamples - 1) / kTileSamples;
  const long long sizes[] = {up256(4 * kLevels * kMaxBuckets * tiles),
                             up256(4 * kLevels * kMaxBuckets),
                             up256(4 * kLevels * (kMaxBuckets + 1)),
                             up256(16 * kLevels * 8 * n)};
  long long at = 0, off[4];
  for (int k = 0; k < 4; ++k) {
    off[k] = at;
    at += sizes[k];
  }
  if (base && s) {
    char* b = static_cast<char*>(base);
    s->hist = reinterpret_cast<int*>(b + off[0]);
    s->totals = reinterpret_cast<int*>(b + off[1]);
    s->starts = reinterpret_cast<int*>(b + off[2]);
    s->rec = reinterpret_cast<uint4*>(b + off[3]);
  }
  return at;
}

// Exclusive scan of v over the 32 * W threads of a block (thread order);
// ``wsum`` is W ints of shared memory. Returns the total too.
template <int W>
__device__ __forceinline__ int block_scan(int v, int* wsum, int* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) wsum[w] = incl;
  __syncthreads();
  int excl = incl - v, all = 0;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    if (k < w) excl += wsum[k];
    all += wsum[k];
  }
  __syncthreads();
  *total = all;
  return excl;
}

// A record's rank among the warp's earlier records of its digit d, plus
// wc[d] (d == none: no record, not counted), its peers from ``bits``
// ballots (bits >= the bits of none); wc[d], the warp's count or next
// position of digit d, is advanced by the digit's first lane. Every lane
// of the warp calls it.
__device__ __forceinline__ int warp_rank(int d, int none, int bits, int* wc) {
  const int lane = threadIdx.x & 31;
  unsigned peers = 0xffffffffu;
  for (int b = 0; b < bits; ++b) {
    const unsigned bal = __ballot_sync(0xffffffffu, (d >> b) & 1);
    peers &= ((d >> b) & 1) ? bal : ~bal;
  }
  const int leader = __ffs(peers) - 1;
  int before = 0;
  if (lane == leader && d < none) {
    before = wc[d];
    wc[d] = before + __popc(peers);
  }
  const int rank = __shfl_sync(0xffffffffu, before, leader) +
                   __popc(peers & ((1u << lane) - 1));
  __syncwarp();
  return rank;
}

// The per-warp digit counts after ranking (wc[k * stride + d], warp k < W,
// digit d < digits), for a block of 32 W threads, thread t digits P*t ..
// P*t + P - 1: each digit's count (``cnt``), its first position in the
// block's order (``first``), and wc[k][d] turned into warp k's first
// position for digit d. Returns the block's record count.
template <int P, int W>
__device__ __forceinline__ int digit_starts(int* wc, int stride, int digits, int* wsum,
                                            int cnt[P], int first[P]) {
  int sum = 0;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int d = P * threadIdx.x + j;
    cnt[j] = 0;
    if (d < digits)
      for (int k = 0; k < W; ++k) cnt[j] += wc[k * stride + d];
    sum += cnt[j];
  }
  int total;
  int at = block_scan<W>(sum, wsum, &total);
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int d = P * threadIdx.x + j;
    first[j] = at;
    if (d < digits) {
      int a = at;
      for (int k = 0; k < W; ++k) {
        const int c = wc[k * stride + d];
        wc[k * stride + d] = a;
        a += c;
      }
    }
    at += cnt[j];
  }
  return total;
}

// Sample s's two gradient values at level l, its volume and, where the
// values are not both zero (and s < s1), its cell: returns whether the
// pair is active.
__device__ __forceinline__ bool load_pair(long long s, long long s1,
                                          const float* __restrict__ g,
                                          const int* __restrict__ prim,
                                          const float* __restrict__ bias, float scale,
                                          const float* __restrict__ pts,
                                          const int* __restrict__ vol, int l, int nv,
                                          float2* gl, int* vi, Cell* c) {
  *gl = make_float2(0.0f, 0.0f);
  *vi = 0;
  *c = Cell{};
  if (s >= s1) return false;
  float p[3];
  *gl = *reinterpret_cast<const float2*>(g + s * (2 * kLevels) + 2 * l);
  *vi = vol[s];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) p[ax] = pts[s * 3 + ax];
  if (gl->x == 0.0f && gl->y == 0.0f) return false;
  const long long pb = ((long long)l * nv + *vi) * 3;
  const int pr[3] = {prim[pb], prim[pb + 1], prim[pb + 2]};
  const float bi[3] = {bias[pb], bias[pb + 1], bias[pb + 2]};
  locate_at(p, pr, bi, scale, c);
  return true;
}

// The runs of a warp's 32 consecutive samples (lane i holds sample base +
// i) at one level: an active lane whose volume and cell (h0, a bijection of
// the floors) equal the lane before it, itself active, continues that
// lane's run. Returns the first lane of this lane's run (-1 where
// inactive); *last: this lane ends a run; *merges: some run holds two
// lanes or more (the same in every lane). Every lane of the warp calls it.
__device__ __forceinline__ int run_of(bool act, int vi, const Cell& c, bool* last,
                                      bool* merges) {
  const int lane = threadIdx.x & 31;
  const bool pact = __shfl_up_sync(0xffffffffu, (int)act, 1) != 0;
  const int pv = __shfl_up_sync(0xffffffffu, vi, 1);
  bool same = act && lane > 0 && pact && pv == vi;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax)
    same = (__shfl_up_sync(0xffffffffu, c.h0[ax], 1) == c.h0[ax]) && same;
  const unsigned starts = __ballot_sync(0xffffffffu, act && !same);
  const bool next_same = __shfl_down_sync(0xffffffffu, (int)same, 1) != 0 && lane < 31;
  *last = act && !next_same;
  *merges = __any_sync(0xffffffffu, same);
  return act ? 31 - __clz(starts & (0xffffffffu >> (31 - lane))) : -1;
}

// A lane's value scanned over its run (``start``, from run_of) in
// doubling steps, v_i = v_(i-o) + v_i for o = 1, 2, 4, 8, 16 where lane i -
// o is in i's run: the run's last lane holds the run's value. Every lane of
// the warp calls it.
__device__ __forceinline__ float2 run_value(float2 v, int start) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float yx = __shfl_up_sync(0xffffffffu, v.x, o);
    const float yy = __shfl_up_sync(0xffffffffu, v.y, o);
    if (start >= 0 && lane - o >= start) {
      v.x = __fadd_rn(yx, v.x);
      v.y = __fadd_rn(yy, v.y);
    }
  }
  return v;
}

// 1. hist: block (level l, tile t) counts the tile's records by bucket;
// warp w takes samples t*kTileSamples + w*kWarpSamples .. + kWarpSamples,
// a lane a sample, 32 at a time.
__global__ void __launch_bounds__(kBlock)
k6_hist_kernel(const float* __restrict__ g, const int* __restrict__ prim,
               const float* __restrict__ bias, const float* __restrict__ scales,
               const float* __restrict__ pts, const int* __restrict__ vol,
               int* __restrict__ hist, long long n, long long tiles, int nv,
               uint32_t lsz, int hi, int lo) {
  __shared__ int h[kMaxBuckets];
  const int l = (int)(blockIdx.x / tiles);
  const long long t = blockIdx.x % tiles;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int buckets = 1 << hi;
  for (int d = threadIdx.x; d < buckets; d += kBlock) h[d] = 0;
  __syncthreads();
  const float scale = scales[l];
  const long long s0 = t * kTileSamples + (long long)w * kWarpSamples;
  const long long s1 = min(n, s0 + kWarpSamples);
  for (long long r = s0; r < s1; r += 32) {
    float2 gl;
    int vi;
    Cell c;
    const bool act = load_pair(r + lane, s1, g, prim, bias, scale, pts, vol, l, nv, &gl,
                               &vi, &c);
    bool last, merges;
    run_of(act, vi, c, &last, &merges);
    if (last) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        uint32_t e;
        float wt;
        corner_entry(c, k, lsz, &e, &wt);
        atomicAdd(h + (e >> lo), 1);
      }
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < buckets; d += kBlock)
    hist[((long long)l * kMaxBuckets + d) * tiles + t] = h[d];
}

// 2. scan: a warp a (level, bucket): the bucket's counts over the tiles,
// exclusive, in place, and its total.
__global__ void __launch_bounds__(32 * kScanWarps)
k6_scan_kernel(int* __restrict__ hist, long long tiles, int buckets,
               int* __restrict__ totals) {
  const int lane = threadIdx.x & 31;
  const long long ld = (long long)blockIdx.x * kScanWarps + (threadIdx.x >> 5);
  if (ld >= kLevels * kMaxBuckets || ld % kMaxBuckets >= buckets) return;
  int* h = hist + ld * tiles;
  int carry = 0;
  for (long long t0 = 0; t0 < tiles; t0 += 32) {
    const long long t = t0 + lane;
    const int v = t < tiles ? h[t] : 0;
    int incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (t < tiles) h[t] = carry + incl - v;
    carry += __shfl_sync(0xffffffffu, incl, 31);
  }
  if (lane == 0) totals[ld] = carry;
}

struct ScatterShared {
  float2 val[kRoundRecords];         // the round, staged in bucket order
  unsigned entry[kRoundRecords];
  int wc[kScatterWarps * kMaxBuckets];  // per warp: counts, then first positions
  int next[kMaxBuckets];             // the bucket's next position in the level
  int base[kMaxBuckets];             // next - its first position in the round
  int wsum[kScatterWarps];
};

// 3. scatter: block (level l, tile t), the tile's records in rounds of
// kRoundSamples samples (warp w: two groups of 32, a lane one sample of
// each, corner by corner; a round with no active pair is skipped), each
// round ranked (a record's rank among the warp's earlier records of its
// bucket), staged in bucket order and written to each bucket's next
// positions, one 16-byte record each: a stable counting sort of the
// level's records by bucket. Block (l, 0) writes the level's bucket
// starts.
__global__ void __launch_bounds__(kScatterBlock)
k6_scatter_kernel(const float* __restrict__ g, const int* __restrict__ prim,
                  const float* __restrict__ bias, const float* __restrict__ scales,
                  const float* __restrict__ pts, const int* __restrict__ vol,
                  const int* __restrict__ hist, const int* __restrict__ totals,
                  int* __restrict__ starts, uint4* __restrict__ rec, long long n,
                  long long tiles, long long cap, int nv, uint32_t lsz, int hi, int lo) {
  extern __shared__ __align__(16) unsigned char smem[];
  ScatterShared& S = *reinterpret_cast<ScatterShared*>(smem);
  const int l = (int)(blockIdx.x / tiles);
  const long long t = blockIdx.x % tiles;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int buckets = 1 << hi, none = buckets;
  const uint32_t low = (1u << lo) - 1u;
  {
    // the level's bucket starts (a scan of the totals) plus the earlier
    // tiles' records of each bucket
    int tot[kBucketsPerThread], sum = 0;
#pragma unroll
    for (int j = 0; j < kBucketsPerThread; ++j) {
      const int d = kBucketsPerThread * threadIdx.x + j;
      tot[j] = d < buckets ? totals[l * kMaxBuckets + d] : 0;
      sum += tot[j];
    }
    int all;
    int at = block_scan<kScatterWarps>(sum, S.wsum, &all);
    int* level = starts + (long long)l * (kMaxBuckets + 1);
#pragma unroll
    for (int j = 0; j < kBucketsPerThread; ++j) {
      const int d = kBucketsPerThread * threadIdx.x + j;
      if (d < buckets) {
        S.next[d] = at + hist[((long long)l * kMaxBuckets + d) * tiles + t];
        if (t == 0) level[d] = at;
      }
      at += tot[j];
    }
    if (t == 0 && threadIdx.x == 0) level[buckets] = all;
  }
  const float scale = scales[l];
  const long long s1 = min(n, (t + 1) * kTileSamples);
  uint4* out = rec + (long long)l * cap;
  int* wc = S.wc + w * kMaxBuckets;
  for (long long r0 = t * kTileSamples; r0 < s1; r0 += kRoundSamples) {
    const long long ws = r0 + 64ll * w + lane;
    float2 gl[2];
    Cell c[2];
    bool act[2], last[2], merges[2];
    int start[2];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      int vi;
      act[m] = load_pair(ws + 32 * m, s1, g, prim, bias, scale, pts, vol, l, nv, &gl[m],
                         &vi, &c[m]);
      start[m] = run_of(act[m], vi, c[m], &last[m], &merges[m]);
    }
    for (int k = threadIdx.x; k < kScatterWarps * kMaxBuckets; k += kScatterBlock) S.wc[k] = 0;
    if (!__syncthreads_or(act[0] || act[1])) continue;   // no record in the round
    // step 8m + k: corner k of the runs of group m, a record at each run's
    // last lane
    int rank[kRecSteps];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        int dig = none;
        if (last[m]) {
          uint32_t e;
          float wt;
          corner_entry(c[m], k, lsz, &e, &wt);
          dig = (int)(e >> lo);
        }
        rank[8 * m + k] = warp_rank(dig, none, hi + 1, wc);
      }
    __syncthreads();
    int cnt[kBucketsPerThread], first[kBucketsPerThread];
    const int total = digit_starts<kBucketsPerThread, kScatterWarps>(
        S.wc, kMaxBuckets, buckets, S.wsum, cnt, first);
#pragma unroll
    for (int j = 0; j < kBucketsPerThread; ++j) {
      const int d = kBucketsPerThread * threadIdx.x + j;
      if (d < buckets) {
        S.base[d] = S.next[d] - first[j];
        S.next[d] += cnt[j];
      }
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        uint32_t e = 0;
        float wt = 0.0f;
        if (act[m]) corner_entry(c[m], k, lsz, &e, &wt);
        float2 v = make_float2(__fmul_rn(gl[m].x, wt), __fmul_rn(gl[m].y, wt));
        if (merges[m]) v = run_value(v, start[m]);
        if (last[m]) {
          const int at = wc[e >> lo] + rank[8 * m + k];
          S.entry[at] = e;
          S.val[at] = v;
        }
      }
    __syncthreads();
    for (int j = threadIdx.x; j < total; j += kScatterBlock) {
      const unsigned e = S.entry[j];
      const float2 v = S.val[j];
      out[S.base[e >> lo] + j] = make_uint4(__float_as_uint(v.x), __float_as_uint(v.y),
                                            e & low, 0u);
    }
    __syncthreads();
  }
}

// The reduce's shared memory: the chunk staged in entry order, the block
// scan's warp sums, each entry's first position (and the chunk's count),
// and the per-warp counts, then first positions, of the bucket's 2^lo
// entries.
long long reduce_smem_bytes(int width) {
  return 8ll * kChunk + 4ll * (kWarps + kMaxWidth + 1) + 4ll * kWarps * width;
}

// 4. reduce: block (level l, bucket b) sums the bucket's records chunk by
// chunk: each chunk sorted by entry (stable: a record's rank among its
// warp's earlier records of its entry, the warps' counts scanned per
// entry) in shared memory, then thread t adds the runs of entries t, t +
// kBlock, ... to their accumulators; at the end it stores the bucket's
// 2^lo entries.
__global__ void __launch_bounds__(kBlock)
k6_reduce_kernel(const int* __restrict__ starts, const uint4* __restrict__ rec,
                 float2* __restrict__ d_feat, long long cap, uint32_t lsz, int hi, int lo) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int width = 1 << lo, none = width;
  float2* sval = reinterpret_cast<float2*>(smem);
  int* wsum = reinterpret_cast<int*>(sval + kChunk);
  int* sfirst = wsum + kWarps;         // [kMaxWidth + 1]
  int* swc = sfirst + kMaxWidth + 1;   // [kWarps, width]
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int l = (int)(blockIdx.x >> hi), b = (int)(blockIdx.x & ((1u << hi) - 1u));
  const int* lstart = starts + (long long)l * (kMaxBuckets + 1);
  const int p0 = lstart[b], p1 = lstart[b + 1];
  const uint4* in = rec + (long long)l * cap;
  int* wc = swc + w * width;
  float2 acc[kWidthPerThread];
#pragma unroll
  for (int j = 0; j < kWidthPerThread; ++j) acc[j] = make_float2(0.0f, 0.0f);
  for (int c0 = p0; c0 < p1; c0 += kChunk) {
    for (int k = threadIdx.x; k < kWarps * width; k += kBlock) swc[k] = 0;
    int dig[kChunkSteps], rank[kChunkSteps];
    float2 val[kChunkSteps];
#pragma unroll
    for (int q = 0; q < kChunkSteps; ++q) {
      const int p = c0 + w * (32 * kChunkSteps) + q * 32 + lane;
      dig[q] = none;
      val[q] = make_float2(0.0f, 0.0f);
      if (p < p1) {
        const uint4 r = in[p];
        dig[q] = (int)r.z;
        val[q] = make_float2(__uint_as_float(r.x), __uint_as_float(r.y));
      }
    }
    __syncthreads();                   // the counts are zero
#pragma unroll
    for (int q = 0; q < kChunkSteps; ++q) rank[q] = warp_rank(dig[q], none, lo + 1, wc);
    __syncthreads();
    int cnt[kWidthPerThread], first[kWidthPerThread];
    const int total = digit_starts<kWidthPerThread, kWarps>(swc, width, width, wsum, cnt,
                                                            first);
#pragma unroll
    for (int j = 0; j < kWidthPerThread; ++j) {
      const int d = kWidthPerThread * threadIdx.x + j;
      if (d < width) sfirst[d] = first[j];
    }
    if (threadIdx.x == 0) sfirst[width] = total;
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kChunkSteps; ++q)
      if (dig[q] < none) sval[wc[dig[q]] + rank[q]] = val[q];
    __syncthreads();
    // entry d's run in the chunk, added to +0 in list order, then to d's
    // accumulator
#pragma unroll
    for (int j = 0; j < kWidthPerThread; ++j) {
      const int d = threadIdx.x + kBlock * j;
      if (d < width) {
        float2 s = make_float2(0.0f, 0.0f);
        const int e = sfirst[d + 1];
        for (int i = sfirst[d]; i < e; ++i) {
          const float2 v = sval[i];
          s.x = __fadd_rn(s.x, v.x);
          s.y = __fadd_rn(s.y, v.y);
        }
        acc[j].x = __fadd_rn(acc[j].x, s.x);
        acc[j].y = __fadd_rn(acc[j].y, s.y);
      }
    }
    __syncthreads();
  }
  float2* dst = d_feat + (long long)l * lsz + (long long)b * width;
#pragma unroll
  for (int j = 0; j < kWidthPerThread; ++j) {
    const int d = threadIdx.x + kBlock * j;
    if (d < width) dst[d] = acc[j];
  }
}

long long tiles_of(long long n) { return (n + kTile - 1) / kTile; }

}  // namespace

extern "C" int f2_hash3d_fwd(const void* feat, const void* prim,
                             const void* bias, const void* scales,
                             const void* pts, const void* vol, void* out,
                             long long n, int nv, int lsz, void* stream) {
  if (n <= 0) return 0;
  if (lsz <= 0 || (lsz & (lsz - 1)) != 0) return (int)cudaErrorInvalidValue;
  const long long tiles = tiles_of(n);
  using LG = LevelGroup<kFwdGroup>;
  hash3d_fwd_kernel<kFwdGroup><<<(unsigned)(tiles * LG::kCount), LG::kThreads,
                                 0, (cudaStream_t)stream>>>(
      (const float2*)feat, (const int*)prim, (const float*)bias,
      (const float*)scales, (const float*)pts, (const int*)vol, (float*)out, n,
      tiles, nv, (uint32_t)lsz);
  return (int)cudaGetLastError();
}

// Bytes of the scratch buffer that f2_hash3d_bwd takes for n samples.
extern "C" long long f2_hash3d_bwd_scratch_bytes(long long n) {
  return scratch_layout(nullptr, n, nullptr);
}

#define K6_LAUNCHED()                           \
  do {                                          \
    const cudaError_t e = cudaGetLastError();   \
    if (e != cudaSuccess) return (int)e;        \
  } while (0)

// The pool gradient d_feat [16 lsz, 2], every entry stored once; lsz a
// power of two <= 2^20, 8n < 2^31; ``scratch`` holds
// f2_hash3d_bwd_scratch_bytes(n).
extern "C" int f2_hash3d_bwd(const void* g, const void* prim, const void* bias,
                             const void* scales, const void* pts,
                             const void* vol, void* d_feat, void* scratch,
                             long long n, int nv, int lsz, void* stream) {
  if (n <= 0) return 0;
  if (lsz <= 0 || (lsz & (lsz - 1)) != 0 || lsz > (1 << (kMaxHi + kMaxLo)) ||
      8 * n >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  int bits = 0;
  while ((1 << bits) < lsz) ++bits;
  const int hi = bits < kMaxHi ? bits : kMaxHi, lo = bits - hi;
  const cudaStream_t st = (cudaStream_t)stream;
  const int* pr = (const int*)prim;
  const float* bi = (const float*)bias;
  const float* sc = (const float*)scales;
  const float* gg = (const float*)g;
  const float* pp = (const float*)pts;
  const int* vv = (const int*)vol;
  Scratch x;
  scratch_layout(scratch, n, &x);
  const long long tiles = (n + kTileSamples - 1) / kTileSamples;
  const unsigned sort_blocks = (unsigned)(kLevels * tiles);
  k6_hist_kernel<<<sort_blocks, kBlock, 0, st>>>(gg, pr, bi, sc, pp, vv, x.hist, n, tiles,
                                                 nv, (uint32_t)lsz, hi, lo);
  K6_LAUNCHED();
  k6_scan_kernel<<<kLevels * kMaxBuckets / kScanWarps, 32 * kScanWarps, 0, st>>>(
      x.hist, tiles, 1 << hi, x.totals);
  K6_LAUNCHED();
  const int scatter_smem = (int)sizeof(ScatterShared);
  cudaError_t a = cudaFuncSetAttribute(
      k6_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, scatter_smem);
  if (a != cudaSuccess) return (int)a;
  k6_scatter_kernel<<<sort_blocks, kScatterBlock, scatter_smem, st>>>(
      gg, pr, bi, sc, pp, vv, x.hist, x.totals, x.starts, x.rec, n, tiles, 8 * n, nv,
      (uint32_t)lsz, hi, lo);
  K6_LAUNCHED();
  a = cudaFuncSetAttribute(k6_reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)reduce_smem_bytes(kMaxWidth));
  if (a != cudaSuccess) return (int)a;
  k6_reduce_kernel<<<(unsigned)(kLevels << hi), kBlock, (size_t)reduce_smem_bytes(1 << lo),
                     st>>>(x.starts, x.rec, (float2*)d_feat, 8 * n, (uint32_t)lsz, hi, lo);
  K6_LAUNCHED();
  return 0;
}
