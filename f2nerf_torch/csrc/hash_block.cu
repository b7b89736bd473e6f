// K2 / K3: HashBlock encode and its table-gradient scatter.
//
// Replace the XLA lowerings of f2nerf_tpu/fields/hash_block.py:
//   K2 hash_block_fwd  <- _encode_fwd_impl (:153-178)
//   K3 hash_block_bwd  <- _hash_block_bwd  (:191-215), the backward of both
//      hash_block_encode and hash_block_gather_cached. On the training step
//      one K3 call scatters both (fields/hash_block.py,
//      hash_block_grad_pass): B's samples and the edge samples are two
//      segments of one call into one gradient.
//
// Index math (both kernels), exactly as hash_block.py:106-121:
//   x = p*scale + bias (per axis), f = floor(x), b = f // 3, c = f - 3b,
//   h = (bx*pa ^ by*pb ^ bz*pc) & (nb-1) in uint32.
// It uses __fmul_rn/__fadd_rn: a contracted FMA can move x by one ulp
// across a cell or block boundary, and block-boundary corner values are
// duplicated per block (not shared), so a changed block changes the
// feature. The trilinear weights follow the JAX tent form
// max(0, 1 - |lane - (c + a)|) per axis, multiplied x*y*z in that order.
// A row holds 4x4x4 corners x 2 channels, lane = lx*32 + ly*8 + lz*2 + ch,
// so a corner's two channels are 8 contiguous bytes and a dz-pair of
// corners 16 bytes, 16-byte aligned when cz is even.
//
// K2. A block takes a tile of 32 consecutive samples and a group of G = 4
// consecutive levels; warp w works level 4*group + w over the tile, one
// sample a lane, so a warp's lanes are neighbours along a ray at one
// level. The grid runs the level groups one after another (block = group *
// tiles + tile), so only 4 levels' rows are in flight: 8.4 MB a level at
// 2^19, where all 16 levels (134 MB) do not fit the 50 MB L2, and a
// sample's 4 levels are 8 floats, one 32-byte sector of its output row,
// written whole. Bound: the bytes it must move, points and volumes (16 B a
// sample) and the touched rows (512 B each) read once, the output (128 B a
// sample) written once: 187 MB at chip_smoke's uniform shape (n 393,216,
// 255,537 rows), 0.056 ms at 3.35 TB/s; 148 MB at the slice's A (cap1
// 327,680, 197,210 rows), 0.044 ms. An earlier kernel (one thread a
// (sample, level), a warp = 2 samples x 16 levels) took 0.476 ms at the
// uniform shape: the table did not fit L2, so rows were fetched from
// memory again and again. Each lane reads a dz-pair as one float4 where aligned (else
// two float2), sums the 8 corners in the order dx, dy, dz (bit for bit the
// plain version), and the tile's [32, 8] output is staged in shared memory
// and written 16 bytes a thread.
//
// K3. The dense [16, nb, 128] gradient, each row stored exactly once (rows
// no sample touches as zeros: the caller does not zero-fill it), its sums
// taken in an order that the inputs alone fix, so every run gives the same
// bits. No float atomic: the only atomics are the histograms' integer
// counts in shared memory, and a count does not depend on the order of its
// additions.
//
// The order. Per level, the active (sample, level) pairs (g != 0 at that
// level: the grad pass's padding rows drop out) are listed by row and,
// within a row, in sample order: segment 0's samples, then segment 1's.
// The list is cut into windows of kWindow = 64 consecutive positions. An
// entry of row r is ((+0 + P_a) + P_a+1) + ... + P_b over the windows a..b
// that r's run of the list meets, in window order, where P_w adds r's
// entries inside window w to +0 one at a time in list order; an entry adds
// g_ch * ((wx * wy) * wz) to each of its 8 corners' channel ch. An entry
// that no active pair touches is +0.0. Where a window cuts a row depends
// on the other rows' counts, which the inputs fix; nothing depends on the
// grid, the tiles or the scheduling. hash_block_bwd_plain
// (fields/hash_block.py) sums in this order: K3 is bit for bit its plain
// version on the card, NaN and inf included.
//
// The launches, queued by one C call after a memset of the rows' states
// (every size from n and nb; no count is read back, so the call can be
// captured in a CUDA graph):
//  1. keys: a block of 16 warps (a level each) over 64 samples locates
//     each pair (the rounding above) and writes its row, or kInactive, to
//     keys [16, n];
//  2. a counting sort of each level's keys by row, stable, in two passes
//     of 8 bits (low, then high: nb <= 65,536), each a histogram launch (a
//     block a (sort tile of 4,096 records, level): its digit counts), a
//     scan launch (a warp a (level, digit): its counts over the tiles, and
//     its total) and a scatter launch (a block a (tile, level): a warp
//     ranks its 512 records in order, each one's peers from 9 ballots, the
//     8 warps' counts are scanned per digit, the level's digits' totals too (the
//     first pass's tile 0 writes the level's active count), the tile is
//     staged in shared memory in digit order and written out so, a
//     digit's records to consecutive positions);
//  3. reduce: a warp a window: each lane locates 2 of its entries (every
//     load issued first) and stages, for each of the 8 lanes an entry
//     meets, the float4 that lane adds (9 float4s an entry: no bank
//     conflict); then the warp walks the window in order, a run at a time
//     (the runs' starts from ballots), lane k adding into the row's floats
//     4k..4k+3 with no branch an entry. A run that the
//     window holds whole is stored to the gradient; a run cut by the
//     window's start (slot 0) or only by its end (slot 1) goes to the
//     window's partial slots, and the row's state, first and last window
//     are noted (plain stores: one window writes each);
//  4. finish: a warp a 32 rows: a row with no pair is stored as zeros, a
//     row cut by windows as its slots summed in window order.
// Bound: g (128 B a sample), points and volumes (16 B) read once and the
// dense gradient (134 MB at 2^19) written once: 191 MB / 0.057 ms at the
// uniform shape; 174 MB / 0.052 ms at the slice's B + edges (278,528
// samples). The keys, the two passes' records and the sorted list add
// ~4 x 4 B written and read a pair (PERF.md §6 has the times).
//
// 64-bit offsets throughout; each entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLevels = 16;
constexpr int kLanes = 128;
constexpr int kTile = 32;        // samples a block, one a lane

// A block's share of the levels: G consecutive levels, one warp each.
template <int G>
struct LevelGroup {
  static constexpr int kCount = kLevels / G;
  static constexpr int kThreads = 32 * G;
  static constexpr int kFloats = 2 * G;         // a sample's G levels x 2
  static constexpr int kQuads = kFloats / 4;    // ... as 16-byte pieces
  static constexpr int kRowStride = kFloats + 4;  // staged rows, padded:
                                                  // 16-B aligned, 2-way bank
                                                  // conflicts at most
  static_assert(kLevels % G == 0, "G levels: 1, 2, 4, 8 or 16");
};
// K2's level group width (see the notes at the top).
constexpr int kFwdGroup = 4;

struct Corner {
  long long row;  // offset of the level's row in floats
  int cx, cy, cz;
  float wx[2], wy[2], wz[2];
};

__device__ __forceinline__ int floor_div3(int v) {
  int q = v / 3;
  if ((v % 3 != 0) && (v < 0)) q -= 1;
  return q;
}

__device__ __forceinline__ float tent(float lane, float t) {
  return fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(lane, t))));
}

// The index math on loaded values: p the point, pr and bi the level's
// primes and bias of its volume.
__device__ __forceinline__ void locate_at(const float* p, const int* pr,
                                          const float* bi, float scale, int l,
                                          int nb, Corner* c) {
  uint32_t h = 0;
  int cs[3];
  float ts[3];
  for (int ax = 0; ax < 3; ++ax) {
    const float x = __fadd_rn(__fmul_rn(p[ax], scale), bi[ax]);
    const float f = floorf(x);
    const int fi = (int)f;
    const int b = floor_div3(fi);
    cs[ax] = fi - 3 * b;
    ts[ax] = __fadd_rn((float)cs[ax], __fsub_rn(x, f));
    h ^= (uint32_t)b * (uint32_t)pr[ax];
  }
  c->row = ((long long)l * nb + (long long)(h & (uint32_t)(nb - 1))) * kLanes;
  c->cx = cs[0];
  c->cy = cs[1];
  c->cz = cs[2];
  for (int d = 0; d < 2; ++d) {
    c->wx[d] = tent((float)(cs[0] + d), ts[0]);
    c->wy[d] = tent((float)(cs[1] + d), ts[1]);
    c->wz[d] = tent((float)(cs[2] + d), ts[2]);
  }
}

__device__ __forceinline__ void locate(const float* p, int vi,
                                       const int* __restrict__ prim,
                                       const float* __restrict__ bias,
                                       const float* __restrict__ scales, int l,
                                       int nv, int nb, Corner* c) {
  const long long pb = ((long long)l * nv + vi) * 3;
  const int pr[3] = {prim[pb], prim[pb + 1], prim[pb + 2]};
  const float bi[3] = {bias[pb], bias[pb + 1], bias[pb + 2]};
  locate_at(p, pr, bi, scales[l], l, nb, c);
}

// Offset in the row of the dz-pair (dx, dy): 4 floats, corner dz=0's two
// channels then dz=1's.
__device__ __forceinline__ int pair_lane(const Corner& c, int dx, int dy) {
  return (c.cx + dx) * 32 + (c.cy + dy) * 8 + c.cz * 2;
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
hash_block_fwd_kernel(const float* __restrict__ feat,
                      const int* __restrict__ prim,
                      const float* __restrict__ bias,
                      const float* __restrict__ scales,
                      const float* __restrict__ pts,
                      const int* __restrict__ vol, float* __restrict__ out,
                      long long n, long long tiles, int nv, int nb) {
  using LG = LevelGroup<G>;
  static_assert(LG::kQuads >= 1, "K2 writes 16-byte pieces: G >= 2");
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
    Corner c;
    locate(spts + lane * 3, svol[lane], prim, bias, scales, group * G + w, nv,
           nb, &c);
    const float* row = feat + c.row;
    float acc0 = 0.0f, acc1 = 0.0f;
    for (int dx = 0; dx < 2; ++dx)
      for (int dy = 0; dy < 2; ++dy) {
        const float wxy = __fmul_rn(c.wx[dx], c.wy[dy]);
        const float w0 = __fmul_rn(wxy, c.wz[0]), w1 = __fmul_rn(wxy, c.wz[1]);
        const float* p = row + pair_lane(c, dx, dy);
        float4 r;
        if ((c.cz & 1) == 0) {
          r = *reinterpret_cast<const float4*>(p);
        } else {
          const float2 a = *reinterpret_cast<const float2*>(p);
          const float2 b = *reinterpret_cast<const float2*>(p + 2);
          r = make_float4(a.x, a.y, b.x, b.y);
        }
        acc0 = __fadd_rn(acc0, __fmul_rn(r.x, w0));
        acc1 = __fadd_rn(acc1, __fmul_rn(r.y, w0));
        acc0 = __fadd_rn(acc0, __fmul_rn(r.z, w1));
        acc1 = __fadd_rn(acc1, __fmul_rn(r.w, w1));
      }
    *reinterpret_cast<float2*>(sout + lane * LG::kRowStride + 2 * w) =
        make_float2(acc0, acc1);
  }
  __syncthreads();
  // each sample's G levels: 16-byte stores
  if (threadIdx.x < cnt * LG::kQuads) {
    const int s = threadIdx.x / LG::kQuads, q = threadIdx.x % LG::kQuads;
    reinterpret_cast<float4*>(out + (base + s) * (2 * kLevels) +
                              group * LG::kFloats)[q] =
        reinterpret_cast<const float4*>(sout + s * LG::kRowStride)[q];
  }
}

// ---------------------------------------------------------------- K3

// The samples of one K3 call: segment 0 then segment 1 (the grad pass's B,
// then its edge samples), indexed 0 .. n-1 in that order.
struct Samples {
  const float* g0;    // [n0, 32]
  const float* pts0;  // [n0, 3]
  const int* vol0;    // [n0]
  const float* g1;
  const float* pts1;
  const int* vol1;
  long long n0, n;
};

// Sample i's rows of g, pts and vol.
__device__ __forceinline__ void sample_at(const Samples& s, long long i,
                                          const float** g, const float** p,
                                          int* vol) {
  if (i < s.n0) {
    *g = s.g0 + i * (2 * kLevels);
    *p = s.pts0 + i * 3;
    *vol = s.vol0[i];
  } else {
    i -= s.n0;
    *g = s.g1 + i * (2 * kLevels);
    *p = s.pts1 + i * 3;
    *vol = s.vol1[i];
  }
}

constexpr unsigned kInactive = 0xffffffffu;  // a pair with g = 0: no key
constexpr int kDigitBits = 8;                // two passes: rows < 2^16
constexpr int kDigits = 1 << kDigitBits;
constexpr int kSortTile = 4096;              // records a scatter block
constexpr int kScatterWarps = 8;             // 512 records a warp
constexpr int kRounds = kSortTile / (32 * kScatterWarps);
constexpr int kKeySamples = 64;              // samples a keys block
constexpr int kScanWarps = 8;                // (level, digit) pairs a scan block
constexpr int kWindow = 64;                  // positions a window: the order
constexpr int kReduceWarps = 4;              // windows a reduce block
constexpr int kFinishWarps = 8;              // 32 rows a warp
static_assert(kDigits == kScatterWarps * 32, "a scatter thread a digit");
static_assert(kWindow % 32 == 0, "whole rounds of 32 lanes");
constexpr int kPerLane = kWindow / 32;       // a reduce lane's entries

// K3 scratch, one buffer cut into these pieces (entries of 4 bytes).
struct Scratch {
  int* state;       // [16, nb] 0: no pair, 1: stored whole, 2: cut by windows
                    // (zeroed by the call)
  int* first;       // [16, nb] a cut row's first window
  int* last;        // [16, nb] a cut row's last window
  int* hist1;       // [16, 256, tiles] pass 1's histogram
  int* hist2;       // [16, 256, tiles] pass 2's histogram
  int* totals;      // [16, 256] a pass's records of each digit
  unsigned* keys;   // [16, n] rows of pass 1's input, then pass 2's output
  unsigned* k1;     // [16, n] pass 1's output
  int* i1;          // [16, n] its sample indices
  int* idx;         // [16, n] the sorted list's sample indices
  int* active;      // [16] entries a level
  float* part;      // [16, windows, 2, 128] partial runs
};

// entries of 4 bytes, rounded up to whole 256-byte pieces
long long up256(long long entries) { return (entries + 63) / 64 * 64; }

// The pieces of the scratch buffer at ``base`` (nullptr: only the size);
// returns its size in bytes. The zeroed piece (state) comes first.
long long scratch_layout(void* base, long long n, int nb, Scratch* s) {
  const long long tiles = (n + kSortTile - 1) / kSortTile;
  const long long windows = (n + kWindow - 1) / kWindow;
  const long long rows = kLevels * (long long)nb;
  const long long sizes[] = {up256(rows), up256(rows), up256(rows),
                             up256(kLevels * kDigits * tiles),
                             up256(kLevels * kDigits * tiles), up256(kLevels * kDigits),
                             up256(kLevels * n), up256(kLevels * n),
                             up256(kLevels * n), up256(kLevels * n), up256(kLevels),
                             up256(kLevels * windows * 2 * kLanes)};
  long long at = 0, off[12];
  for (int k = 0; k < 12; ++k) {
    off[k] = at;
    at += sizes[k];
  }
  if (base && s) {
    int* b = static_cast<int*>(base);
    s->state = b + off[0];
    s->first = b + off[1];
    s->last = b + off[2];
    s->hist1 = b + off[3];
    s->hist2 = b + off[4];
    s->totals = b + off[5];
    s->keys = reinterpret_cast<unsigned*>(b + off[6]);
    s->k1 = reinterpret_cast<unsigned*>(b + off[7]);
    s->i1 = b + off[8];
    s->idx = b + off[9];
    s->active = b + off[10];
    s->part = reinterpret_cast<float*>(b + off[11]);
  }
  return at * 4;
}

// 1. keys: warp w is level w, a lane a sample, 2 samples a lane, every
// load issued before the arithmetic.
__global__ void __launch_bounds__(32 * kLevels)
k3_keys_kernel(Samples s, const int* __restrict__ prim,
               const float* __restrict__ bias, const float* __restrict__ scales,
               unsigned* __restrict__ keys, int nv, int nb) {
  constexpr int kPer = kKeySamples / 32;
  const int lane = threadIdx.x & 31, l = threadIdx.x >> 5;
  const long long base = (long long)blockIdx.x * kKeySamples;
  float2 gl[kPer];
  float pt[kPer][3], bi[kPer][3];
  int pr[kPer][3];
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const long long i = base + r * 32 + lane;
    if (i < s.n) {
      const float* g;
      const float* p;
      int vi;
      sample_at(s, i, &g, &p, &vi);
      gl[r] = *reinterpret_cast<const float2*>(g + 2 * l);
      const long long pb = ((long long)l * nv + vi) * 3;
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        pt[r][ax] = p[ax];
        pr[r][ax] = prim[pb + ax];
        bi[r][ax] = bias[pb + ax];
      }
    }
  }
  const float scale = scales[l];
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const long long i = base + r * 32 + lane;
    if (i < s.n) {
      unsigned key = kInactive;
      if (gl[r].x != 0.0f || gl[r].y != 0.0f) {
        Corner c;
        locate_at(pt[r], pr[r], bi[r], scale, l, nb, &c);
        key = (unsigned)(c.row / kLanes - (long long)l * nb);
      }
      keys[(long long)l * s.n + i] = key;
    }
  }
}

// 2. scan: a warp a (level, digit): the digit's counts over the tiles,
// exclusive, in place, and its total.
__global__ void __launch_bounds__(32 * kScanWarps)
k3_scan_kernel(int* __restrict__ hist, long long tiles, int* __restrict__ totals) {
  const int lane = threadIdx.x & 31;
  const long long ld = (long long)blockIdx.x * kScanWarps + (threadIdx.x >> 5);
  if (ld >= kLevels * kDigits) return;
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

// Exclusive scan of v over the 256 threads of a block (thread order);
// ``wsum`` is kScatterWarps ints of shared memory. Returns the total too.
__device__ __forceinline__ int block_scan256(int v, int* wsum, int* total) {
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
  for (int k = 0; k < kScatterWarps; ++k) {
    if (k < w) excl += wsum[k];
    all += wsum[k];
  }
  __syncthreads();
  *total = all;
  return excl;
}

// 3. scatter: one stable counting sort pass over sort tile t of level l.
// Records are kin[l][p] for p < end (end: n, or the level's active count),
// with sample index iin[l][p] (or p itself when iin is null); the digit is
// (key >> shift) & 255; ``offs`` holds each (digit, tile)'s records in the
// earlier tiles, ``totals`` each digit's in the level (the scan's). Warp w
// ranks records w*512 .. +512 of the tile in order (a record's peers from
// 9 ballots: __match_any_sync slows with the number of distinct digits);
// the tile is staged in
// shared memory in digit order and written out in that order, a digit's
// records to consecutive positions. With ``active_out``, block (l, 0)
// writes the level's record count.
__global__ void __launch_bounds__(32 * kScatterWarps)
k3_scatter_kernel(const unsigned* __restrict__ kin, const int* __restrict__ iin,
                  const int* __restrict__ active, long long n, long long tiles,
                  int shift, const int* __restrict__ offs,
                  const int* __restrict__ totals, unsigned* __restrict__ kout,
                  int* __restrict__ iout, int* __restrict__ active_out) {
  __shared__ int wcnt[kScatterWarps][kDigits];
  __shared__ int gbase[kDigits];
  __shared__ int wsum[kScatterWarps];
  __shared__ unsigned skey[kSortTile];
  __shared__ int sidx[kSortTile];
  const int l = (int)(blockIdx.x / tiles);
  const long long t = blockIdx.x % tiles;
  const long long end = active ? active[l] : n;
  const long long t0 = t * kSortTile;
  if (t0 >= end) return;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int k = threadIdx.x; k < kScatterWarps * kDigits; k += blockDim.x)
    (&wcnt[0][0])[k] = 0;
  const long long lb = (long long)l * n;
  const long long wbase = t0 + (long long)w * 32 * kRounds;
  unsigned key[kRounds];
  int rank[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const long long p = wbase + r * 32 + lane;
    key[r] = p < end ? kin[lb + p] : kInactive;
  }
  __syncthreads();
  // each record's rank among the warp's earlier records of its digit
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int d = key[r] == kInactive ? kDigits : (int)((key[r] >> shift) & (kDigits - 1));
    // the lanes of the same digit (kDigits: inactive), from one ballot a bit
    unsigned peers = 0xffffffffu;
#pragma unroll
    for (int b = 0; b <= kDigitBits; ++b) {
      const unsigned bal = __ballot_sync(0xffffffffu, (d >> b) & 1);
      peers &= ((d >> b) & 1) ? bal : ~bal;
    }
    const int leader = __ffs(peers) - 1;
    int before = 0;
    if (lane == leader && d < kDigits) {
      before = wcnt[w][d];
      wcnt[w][d] = before + __popc(peers);
    }
    rank[r] = __shfl_sync(0xffffffffu, before, leader) + __popc(peers & ((1u << lane) - 1));
    __syncwarp();
  }
  __syncthreads();
  // thread d: its digit's first record in the tile (the tile's digits
  // before it) and in the level (the level's digits before it plus the
  // earlier tiles'), then each warp's first
  const int d = threadIdx.x;
  int count = 0;
#pragma unroll
  for (int k = 0; k < kScatterWarps; ++k) count += wcnt[k][d];
  const int all_d = totals[(long long)l * kDigits + d];
  int total, level_total;
  int start = block_scan256(count, wsum, &total);
  const int level_start = block_scan256(all_d, wsum, &level_total);
  gbase[d] = level_start + offs[((long long)l * kDigits + d) * tiles + t] - start;
  if (active_out && t == 0 && d == 0) active_out[l] = level_total;
  for (int k = 0; k < kScatterWarps; ++k) {
    const int c = wcnt[k][d];
    wcnt[k][d] = start;
    start += c;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRounds; ++r)
    if (key[r] != kInactive) {
      const long long p = wbase + r * 32 + lane;
      const int at = wcnt[w][(key[r] >> shift) & (kDigits - 1)] + rank[r];
      skey[at] = key[r];
      sidx[at] = iin ? iin[lb + p] : (int)p;
    }
  __syncthreads();
  for (int j = threadIdx.x; j < total; j += blockDim.x) {
    const unsigned k = skey[j];
    const long long pos = gbase[(k >> shift) & (kDigits - 1)] + j;
    kout[lb + pos] = k;
    iout[lb + pos] = sidx[j];
  }
}

// A pass's histogram: tile t of level l's records (p < end: n, or the
// level's active count), by digit; inactive keys are not counted. A
// thread loads its 16 keys before it counts them.
__global__ void __launch_bounds__(kDigits)
k3_hist_kernel(const unsigned* __restrict__ kin, const int* __restrict__ active,
               long long n, long long tiles, int shift, int* __restrict__ hist) {
  constexpr int kPer = kSortTile / kDigits;
  __shared__ int h[kDigits];
  const int l = (int)(blockIdx.x / tiles);
  const long long t = blockIdx.x % tiles;
  const long long end = min(active ? (long long)active[l] : n, (t + 1) * kSortTile);
  h[threadIdx.x] = 0;
  unsigned key[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const long long p = t * kSortTile + r * kDigits + threadIdx.x;
    key[r] = p < end ? kin[(long long)l * n + p] : kInactive;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kPer; ++r)
    if (key[r] != kInactive) atomicAdd(h + ((key[r] >> shift) & (kDigits - 1)), 1);
  __syncthreads();
  hist[((long long)l * kDigits + threadIdx.x) * tiles + t] = h[threadIdx.x];
}

__device__ __forceinline__ void add4(float4& acc, float a, float b, float c, float d) {
  acc.x = __fadd_rn(acc.x, a);
  acc.y = __fadd_rn(acc.y, b);
  acc.z = __fadd_rn(acc.z, c);
  acc.w = __fadd_rn(acc.w, d);
}

// 4. reduce: warp w takes window win of level l (positions
// win*kWindow .. +kWindow of the level's list). Lane k of the warp holds
// the row's floats 4k .. 4k+3: corner (lx, ly) = (k >> 3, (k >> 1) & 3),
// lz 2m and 2m+1 (m = k & 1), two channels each. An entry at corner
// (cx, cy, cz) meets lanes (cx + dx, cy + dy, m) for dx, dy, m in {0, 1};
// step 1 stages, for each of those 8 lanes, the float4 it adds (+0.0 in
// the floats it does not meet: adding +0.0 changes no sum, which starts
// at +0.0 and so is never -0.0), so that step 2 branches on no corner.
__global__ void __launch_bounds__(32 * kReduceWarps)
k3_reduce_kernel(Samples s, const int* __restrict__ prim,
                 const float* __restrict__ bias, const float* __restrict__ scales,
                 const unsigned* __restrict__ krow, const int* __restrict__ sidx,
                 const int* __restrict__ active, float* __restrict__ d_feat,
                 float* __restrict__ part, int* __restrict__ state,
                 int* __restrict__ first, int* __restrict__ last, long long windows,
                 int nv, int nb) {
  // 9 float4s an entry: 8 used, the pad puts lanes k and k + 1 on other
  // banks when each stages its own entry
  __shared__ __align__(16) float4 sval[kReduceWarps][kWindow][9];
  __shared__ __align__(16) unsigned srow[kReduceWarps][kWindow];
  __shared__ __align__(16) int sbase[kReduceWarps][kWindow];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long gw = (long long)blockIdx.x * kReduceWarps + w;
  const int l = (int)(gw / windows);
  const long long win = gw % windows;
  if (l >= kLevels) return;
  const long long count = active[l], p0 = win * kWindow;
  if (p0 >= count) return;
  const int cnt = (int)min((long long)kWindow, count - p0);
  const unsigned* kr = krow + (long long)l * s.n + p0;
  const int* si = sidx + (long long)l * s.n + p0;
  // step 1: the lane's entries lane, lane + 32, ...; every load issued
  // before the arithmetic
  int idx[kPerLane], vi[kPerLane];
  const float* gp[kPerLane];
  const float* pp[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int k = lane + 32 * j;
    idx[j] = k < cnt ? si[k] : -1;
    if (k < cnt) srow[w][k] = kr[k];
  }
#pragma unroll
  for (int j = 0; j < kPerLane; ++j)
    if (idx[j] >= 0) sample_at(s, idx[j], &gp[j], &pp[j], &vi[j]);
  float pt[kPerLane][3], bi[kPerLane][3];
  int pr[kPerLane][3];
  float2 gl[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j)
    if (idx[j] >= 0) {
      const long long pb = ((long long)l * nv + vi[j]) * 3;
      gl[j] = *reinterpret_cast<const float2*>(gp[j] + 2 * l);
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        pt[j][ax] = pp[j][ax];
        pr[j][ax] = prim[pb + ax];
        bi[j][ax] = bias[pb + ax];
      }
    }
  const float scale = scales[l];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j)
    if (idx[j] >= 0) {
      const int k = lane + 32 * j;
      Corner c;
      locate_at(pt[j], pr[j], bi[j], scale, l, nb, &c);
#pragma unroll
      for (int dx = 0; dx < 2; ++dx)
#pragma unroll
        for (int dy = 0; dy < 2; ++dy) {
          const float wxy = __fmul_rn(c.wx[dx], c.wy[dy]);
          const float w0 = __fmul_rn(wxy, c.wz[0]), w1 = __fmul_rn(wxy, c.wz[1]);
          // the pair (dx, dy): dz 0's two channels at lz cz, dz 1's at cz + 1
          const float4 q = make_float4(__fmul_rn(gl[j].x, w0), __fmul_rn(gl[j].y, w0),
                                       __fmul_rn(gl[j].x, w1), __fmul_rn(gl[j].y, w1));
          const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          float4 a, b;  // what lanes m = 0 (lz 0, 1) and m = 1 (lz 2, 3) add
          if (c.cz == 0) {
            a = q;
            b = z;
          } else if (c.cz == 2) {
            a = z;
            b = q;
          } else {
            a = make_float4(0.0f, 0.0f, q.x, q.y);
            b = make_float4(q.z, q.w, 0.0f, 0.0f);
          }
          sval[w][k][4 * dx + 2 * dy] = a;
          sval[w][k][4 * dx + 2 * dy + 1] = b;
        }
      sbase[w][k] = c.cx * 8 + c.cy * 2;  // the lane of (cx, cy, m = 0)
    }
  const unsigned prev = p0 > 0 ? kr[-1] : kInactive;
  const unsigned next = p0 + cnt < count ? kr[cnt] : kInactive;
  __syncwarp();
  // the runs: an entry starts one where its row differs from the entry
  // before it (one ballot a 32 entries)
  unsigned starts[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int k = lane + 32 * j;
    starts[j] = __ballot_sync(0xffffffffu,
                              k < cnt && (k == 0 || srow[w][k] != srow[w][k - 1]));
  }
  // step 2: the runs in order, each walked with no branch an entry
  float* dst = d_feat + (long long)l * nb * kLanes + 4 * lane;
  float* pw = part + ((long long)l * windows + win) * 2 * kLanes + 4 * lane;
  const long long rb = (long long)l * nb;
  for (int k = 0; k < cnt;) {
    int e = cnt;  // the next run's first entry
#pragma unroll
    for (int j = kPerLane - 1; j >= 0; --j) {
      const int from = k + 1 - 32 * j;
      const unsigned later = from <= 0 ? starts[j] : from >= 32 ? 0u : starts[j] & (~0u << from);
      if (later) e = 32 * j + __ffs(later) - 1;
    }
    const unsigned row = srow[w][k];
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
    for (int kk = k; kk < e; ++kk) {
      // this lane relative to the entry: 8 dx + 2 dy + m for a lane it meets
      const int rel = lane - sbase[w][kk];
      if ((unsigned)rel < 12u && (rel & 4) == 0) {
        const float4 a = sval[w][kk][(rel & 3) | ((rel >> 1) & 4)];
        add4(acc, a.x, a.y, a.z, a.w);
      }
    }
    // the run k .. e-1: whole (stored; state 1), cut by the window's start
    // (slot 0; the row's last window unless cut by its end too) or only by
    // its end (slot 1; the row's first window; state 2)
    const bool cut_start = k == 0 && row == prev, cut_end = e == cnt && row == next;
    float* out = !cut_start && !cut_end ? dst + (long long)row * kLanes
                                        : pw + (cut_start ? 0 : kLanes);
    *reinterpret_cast<float4*>(out) = acc;
    if (lane == 0) {
      if (!cut_start) state[rb + row] = cut_end ? 2 : 1;
      if (!cut_start && cut_end) first[rb + row] = (int)win;
      if (cut_start && !cut_end) last[rb + row] = (int)win;
    }
    k = e;
  }
}

// 5. finish: a warp takes 32 rows (of all levels, row-major). A row with
// no pair (state 0) is stored as zeros; a row cut by windows (state 2) is
// the sum, from +0 in window order, of its first window's slot 1, the
// middle windows' slot 0 and its last window's slot 0 (16 loads in
// flight).
__global__ void __launch_bounds__(32 * kFinishWarps)
k3_finish_kernel(const int* __restrict__ state, const int* __restrict__ first,
                 const int* __restrict__ last, const float* __restrict__ part,
                 float* __restrict__ d_feat, long long rows, long long windows, int nb) {
  constexpr int kInFlight = 16;
  const int lane = threadIdx.x & 31;
  const long long r0 = ((long long)blockIdx.x * kFinishWarps + (threadIdx.x >> 5)) * 32;
  if (r0 >= rows) return;
  const int my_state = state[r0 + lane];
  const int my_first = my_state == 2 ? first[r0 + lane] : 0;
  const int my_last = my_state == 2 ? last[r0 + lane] : 0;
  for (int j = 0; j < 32; ++j) {
    const int st = __shfl_sync(0xffffffffu, my_state, j);
    const long long w0 = __shfl_sync(0xffffffffu, my_first, j);
    const long long w1 = __shfl_sync(0xffffffffu, my_last, j);
    float4* dst = reinterpret_cast<float4*>(d_feat + (r0 + j) * kLanes) + lane;
    if (st == 0) {
      *dst = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      continue;
    }
    if (st == 1) continue;  // the reduce stored it
    const long long l = (r0 + j) / nb;
    // window wi's slot: its float4 for this lane
    const float4* pw = reinterpret_cast<const float4*>(part + l * windows * 2 * kLanes) + lane;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (long long wi = w0; wi <= w1; wi += kInFlight) {
      float4 a[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        if (wi + u <= w1) a[u] = pw[((wi + u) * 2 + (wi + u == w0 ? 1 : 0)) * (kLanes / 4)];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        if (wi + u <= w1) add4(acc, a[u].x, a[u].y, a[u].z, a[u].w);
    }
    *dst = acc;
  }
}

long long tiles_of(long long n) { return (n + kTile - 1) / kTile; }

}  // namespace

extern "C" int f2_hash_block_fwd(const void* feat, const void* prim,
                                 const void* bias, const void* scales,
                                 const void* pts, const void* vol, void* out,
                                 int n, int nv, int nb, void* stream) {
  if (n <= 0) return 0;
  const long long tiles = tiles_of(n);
  using LG = LevelGroup<kFwdGroup>;
  hash_block_fwd_kernel<kFwdGroup><<<(unsigned)(tiles * LG::kCount),
                                     LG::kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)feat, (const int*)prim, (const float*)bias,
      (const float*)scales, (const float*)pts, (const int*)vol, (float*)out, n,
      tiles, nv, nb);
  return (int)cudaGetLastError();
}

// Bytes of the scratch buffer that f2_hash_block_bwd takes for n samples.
extern "C" long long f2_hash_block_bwd_scratch_bytes(long long n, int nb) {
  return scratch_layout(nullptr, n, nb, nullptr);
}

#define K3_LAUNCHED()                           \
  do {                                          \
    const cudaError_t e = cudaGetLastError();   \
    if (e != cudaSuccess) return (int)e;        \
  } while (0)

// Two segments of samples (n1 may be 0) into one gradient d_feat, every
// row of it stored once; ``scratch`` holds f2_hash_block_bwd_scratch_bytes.
extern "C" int f2_hash_block_bwd(const void* g0, const void* pts0,
                                 const void* vol0, int n0, const void* g1,
                                 const void* pts1, const void* vol1, int n1,
                                 const void* prim, const void* bias,
                                 const void* scales, void* d_feat,
                                 void* scratch, int nv, int nb, void* stream) {
  const long long m0 = n0 > 0 ? n0 : 0, n = m0 + (n1 > 0 ? n1 : 0);
  if (n == 0) return 0;
  if (nb > (1 << (2 * kDigitBits))) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const Samples s{(const float*)g0, (const float*)pts0, (const int*)vol0,
                  (const float*)g1, (const float*)pts1, (const int*)vol1,
                  m0, n};
  const int* pr = (const int*)prim;
  const float* bi = (const float*)bias;
  const float* sc = (const float*)scales;
  float* d = (float*)d_feat;
  Scratch x;
  scratch_layout(scratch, n, nb, &x);
  const long long tiles = (n + kSortTile - 1) / kSortTile;
  const long long windows = (n + kWindow - 1) / kWindow;
  const long long rows = kLevels * (long long)nb;
  const cudaError_t z = cudaMemsetAsync(x.state, 0, 4 * rows, st);
  if (z != cudaSuccess) return (int)z;
  const unsigned sort_blocks = (unsigned)(tiles * kLevels);
  k3_keys_kernel<<<(unsigned)((n + kKeySamples - 1) / kKeySamples), 32 * kLevels, 0, st>>>(
      s, pr, bi, sc, x.keys, nv, nb);
  K3_LAUNCHED();
  // keyed: sort each level's pairs by row, low digit then high digit
  const unsigned scan_blocks = kLevels * kDigits / kScanWarps;
  k3_hist_kernel<<<sort_blocks, kDigits, 0, st>>>(x.keys, nullptr, n, tiles, 0, x.hist1);
  K3_LAUNCHED();
  k3_scan_kernel<<<scan_blocks, 32 * kScanWarps, 0, st>>>(x.hist1, tiles, x.totals);
  K3_LAUNCHED();
  k3_scatter_kernel<<<sort_blocks, 32 * kScatterWarps, 0, st>>>(
      x.keys, nullptr, nullptr, n, tiles, 0, x.hist1, x.totals, x.k1, x.i1, x.active);
  K3_LAUNCHED();
  k3_hist_kernel<<<sort_blocks, kDigits, 0, st>>>(x.k1, x.active, n, tiles, kDigitBits,
                                                  x.hist2);
  K3_LAUNCHED();
  k3_scan_kernel<<<scan_blocks, 32 * kScanWarps, 0, st>>>(x.hist2, tiles, x.totals);
  K3_LAUNCHED();
  k3_scatter_kernel<<<sort_blocks, 32 * kScatterWarps, 0, st>>>(
      x.k1, x.i1, x.active, n, tiles, kDigitBits, x.hist2, x.totals, x.keys, x.idx,
      nullptr);
  K3_LAUNCHED();
  // bucketed: the windows, then the rows
  k3_reduce_kernel<<<(unsigned)((kLevels * windows + kReduceWarps - 1) / kReduceWarps),
                     32 * kReduceWarps, 0, st>>>(s, pr, bi, sc, x.keys, x.idx, x.active, d,
                                                 x.part, x.state, x.first, x.last, windows,
                                                 nv, nb);
  K3_LAUNCHED();
  k3_finish_kernel<<<(unsigned)((rows / 32 + kFinishWarps - 1) / kFinishWarps),
                     32 * kFinishWarps, 0, st>>>(x.state, x.first, x.last, x.part, d, rows,
                                                 windows, nb);
  K3_LAUNCHED();
  return 0;
}
