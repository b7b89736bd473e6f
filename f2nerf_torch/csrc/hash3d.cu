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
// Layout of the work (both kernels), as csrc/hash_block.cu's K2/K3. A
// block takes a tile of 32 consecutive samples and a group of G
// consecutive levels; warp w works level G*group + w over the tile, one
// sample a lane, so a warp's lanes are neighbours along a ray at one
// level. The grid runs the level groups one after another (block = group
// * tiles + tile), so only G levels' slices (4G MB at 2^19) are in flight
// and stay in L2. Only speed depends on blocks being scheduled roughly in
// that order. G was chosen on the card from 1, 2, 4 and 8 (chip_smoke.py
// --phases device,build,kernels,variants, NVIDIA H100 80GB HBM3, 700 W;
// ms at the uniform shape / the reference-semantics step's inputs):
//   K5, uniform / A / B + edges: G 1 0.594 / 0.336 / 0.287,
//       G 2 0.516 / 0.208 / 0.206, G 4 0.490 / 0.163 / 0.184,
//       G 8 0.635 / 0.189 / 0.212: G = 4 (also a sample's 4 levels are 8
//       floats, one 32-byte sector of its output row, written whole);
//   K6, uniform / B + edges: G 1 0.725 / 0.319, G 2 0.757 / 0.282,
//       G 4 0.777 / 0.279, G 8 0.845 / 0.358: G = 2, within 1.2% of
//       G = 4 at the step and 2.6% faster at the uniform shape, which
//       later steps (larger batches) come closer to.
// G = 1 blocks are one warp, and the SM's 32-block limit halves their
// occupancy; G = 8 puts 33 MB in flight. All 16 levels in one block
// (G = 16) took 1.017 / 0.274 / 0.294 (K5) and 2.161 / 0.561 (K6), as
// much as one thread a (sample, level): the level groups are the gain.
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
// K6. Bound: g (128 B a sample), points and volumes read once, and the
// dense [pool, 2] gradient (67 MB at 2^19, zero-filled by the wrapper)
// written once. A lane whose two gradient values are both zero (the grad
// pass's padding rows) drops out before any matching. The other lanes are
// keyed by the cell that fixes all eight corners at the warp's level,
// (volume, floor x, floor y, floor z) packed as 21 + 3 x 14 bits (bit 63
// clear), and grouped with __match_any_sync; the bias and primes are per
// (level, volume), so the volume is in the key. A lane whose volume or
// floors do not fit (a floor outside [0, 16384), NaN, a volume past 2^21;
// points01 in [0, 1] gives floors in [100, 2124]) takes the key
// (1 << 63) | lane, which no other lane shares: it is never merged. A
// group of m > 1 lanes stages its 8 corners x 2 channels in shared memory;
// corner k is summed over the group's lanes, in lane order, by the lane of
// rank k mod m, which then issues that corner's one float2 atomicAdd
// (max(m, 8) float2 steps a lane). A lane alone issues its own 8 (sm_90
// has vector atomics on global memory); a zero value is not issued. A
// hashed pool has no adjacent corners, so there is no float4 case.
// Atomics sum in no fixed order, so K6 agrees with its plain version to
// rounding (chip_smoke.py holds it to 1e-5 of the largest entry). Eight
// unmerged atomics a (sample, level) with all levels in flight took
// 2.16 ms at the uniform shape and 0.577 ms at the step's B + edges;
// merging takes this layout from 0.296 to 0.282 ms at the step (no lane
// shares a cell at the uniform shape, where both take 0.757).
//
// 64-bit offsets throughout; each entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLevels = 16;
constexpr int kTile = 32;        // samples a block, one a lane
constexpr int kValStride = 20;   // a lane's 16 staged values, padded: float4
                                 // stores of 8 lanes hit distinct banks

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
// Level group widths (see the notes at the top).
constexpr int kFwdGroup = 4;
constexpr int kBwdGroup = 2;

struct Cell {
  uint32_t h0[3], h1[3];
  float a[3], f[3];
};

__device__ __forceinline__ void locate(const float* p, int vi,
                                       const int* __restrict__ prim,
                                       const float* __restrict__ bias,
                                       const float* __restrict__ scales, int l,
                                       int nv, Cell* c) {
  const float scale = scales[l];
  const long long pb = ((long long)l * nv + vi) * 3;
  for (int ax = 0; ax < 3; ++ax) {
    const float x = __fadd_rn(__fmul_rn(p[ax], scale), bias[pb + ax]);
    const float f = floorf(x);
    const uint32_t pr = (uint32_t)prim[pb + ax];
    c->f[ax] = f;
    c->a[ax] = __fsub_rn(x, f);
    c->h0[ax] = (uint32_t)(int)f * pr;
    c->h1[ax] = c->h0[ax] + pr;
  }
}

// Corner k's pool entry and weight.
__device__ __forceinline__ void corner(const Cell& c, int k, int l,
                                       uint32_t lsz, long long* idx, float* w) {
  const int bx = (k >> 2) & 1, by = (k >> 1) & 1, bz = k & 1;
  const uint32_t h = (bx ? c.h1[0] : c.h0[0]) ^ (by ? c.h1[1] : c.h0[1]) ^
                     (bz ? c.h1[2] : c.h0[2]);
  *idx = (long long)(h % lsz) + (long long)l * lsz;
  const float wx = bx ? c.a[0] : __fsub_rn(1.0f, c.a[0]);
  const float wy = by ? c.a[1] : __fsub_rn(1.0f, c.a[1]);
  const float wz = bz ? c.a[2] : __fsub_rn(1.0f, c.a[2]);
  *w = __fmul_rn(__fmul_rn(wx, wy), wz);
}

// The merge key of a located lane: (volume, floor x, y, z) in 21 + 3 x 14
// bits where each fits, else a key of the lane's own (bit 63 set).
__device__ __forceinline__ unsigned long long cell_key(const Cell& c, int vi,
                                                       int lane) {
  bool fits = vi >= 0 && vi < (1 << 21);
  unsigned long long key = (unsigned long long)vi;
  for (int ax = 0; ax < 3; ++ax) {
    fits = fits && c.f[ax] >= 0.0f && c.f[ax] < 16384.0f;
    key = (key << 14) | (unsigned long long)((int)c.f[ax] & 0x3fff);
  }
  return fits ? key : (1ull << 63) | (unsigned long long)lane;
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
    for (int k = 0; k < 8; ++k) corner(c, k, l, lsz, &idx[k], &wt[k]);
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

template <int G>
__global__ void __launch_bounds__(LevelGroup<G>::kThreads)
hash3d_bwd_kernel(const float* __restrict__ g, const int* __restrict__ prim,
                  const float* __restrict__ bias, const float* __restrict__ scales,
                  const float* __restrict__ pts, const int* __restrict__ vol,
                  float2* __restrict__ d_feat, long long n, long long tiles,
                  int nv, uint32_t lsz) {
  using LG = LevelGroup<G>;
  __shared__ float spts[kTile * 3];
  __shared__ int svol[kTile];
  __shared__ __align__(16) float sg[kTile * LG::kRowStride];
  __shared__ __align__(16) float sval[G][32][kValStride];
  const int group = (int)(blockIdx.x / tiles);
  const long long base = (blockIdx.x % tiles) * kTile;
  const int cnt = (int)min((long long)kTile, n - base);
  load_points(pts, vol, base, cnt, spts, svol);
  // each sample's gradient floats of this level group, a level's two a
  // thread
  if (threadIdx.x < cnt * G) {
    const int i = threadIdx.x / G, j = threadIdx.x % G;
    reinterpret_cast<float2*>(sg + i * LG::kRowStride)[j] =
        reinterpret_cast<const float2*>(g + (base + i) * (2 * kLevels) +
                                        group * LG::kFloats)[j];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int l = group * G + w;
  // a lane with g = 0 (the grad pass's padding rows) adds nothing
  bool active = false;
  float2 gl = make_float2(0.0f, 0.0f);
  if (lane < cnt) {
    gl = *reinterpret_cast<const float2*>(sg + lane * LG::kRowStride + 2 * w);
    active = gl.x != 0.0f || gl.y != 0.0f;
  }
  Cell c;
  unsigned long long key = ~0ull;  // never a located lane's key
  if (active) {
    locate(spts + lane * 3, svol[lane], prim, bias, scales, l, nv, &c);
    key = cell_key(c, svol[lane], lane);
  }
  // every lane of the warp takes part, the tail's and the inactive ones
  const unsigned grp = __match_any_sync(0xffffffffu, key);
  const int m = __popc(grp);
  const bool merge = active && m > 1;
  float* mine = sval[w][lane];
  if (merge) {
    float v[16];  // corner k's two channels: v[2k], v[2k + 1]
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      long long idx;
      float wt;
      corner(c, k, l, lsz, &idx, &wt);
      v[2 * k] = __fmul_rn(gl.x, wt);
      v[2 * k + 1] = __fmul_rn(gl.y, wt);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      reinterpret_cast<float4*>(mine)[q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }
  __syncwarp();
  if (!active) return;
  if (!merge) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      long long idx;
      float wt;
      corner(c, k, l, lsz, &idx, &wt);
      const float2 a = make_float2(__fmul_rn(gl.x, wt), __fmul_rn(gl.y, wt));
      if (a.x != 0.0f || a.y != 0.0f) atomicAdd(d_feat + idx, a);
    }
    return;
  }
  // corner k of the group (its lanes share all eight corners): summed over
  // the group in lane order by the lane of rank k mod m, which issues it
  for (int k = __popc(grp & ((1u << lane) - 1)); k < 8; k += m) {
    float2 s = make_float2(0.0f, 0.0f);
    for (unsigned b = grp; b; b &= b - 1) {
      const float2 a = reinterpret_cast<const float2*>(sval[w][__ffs(b) - 1])[k];
      s.x = __fadd_rn(s.x, a.x);
      s.y = __fadd_rn(s.y, a.y);
    }
    if (s.x != 0.0f || s.y != 0.0f) {
      long long idx;
      float wt;
      corner(c, k, l, lsz, &idx, &wt);
      atomicAdd(d_feat + idx, s);
    }
  }
}

long long tiles_of(long long n) { return (n + kTile - 1) / kTile; }

}  // namespace

extern "C" int f2_hash3d_fwd(const void* feat, const void* prim,
                             const void* bias, const void* scales,
                             const void* pts, const void* vol, void* out,
                             long long n, int nv, int lsz, void* stream) {
  if (n <= 0) return 0;
  const long long tiles = tiles_of(n);
  using LG = LevelGroup<kFwdGroup>;
  hash3d_fwd_kernel<kFwdGroup><<<(unsigned)(tiles * LG::kCount), LG::kThreads,
                                 0, (cudaStream_t)stream>>>(
      (const float2*)feat, (const int*)prim, (const float*)bias,
      (const float*)scales, (const float*)pts, (const int*)vol, (float*)out, n,
      tiles, nv, (uint32_t)lsz);
  return (int)cudaGetLastError();
}

extern "C" int f2_hash3d_bwd(const void* g, const void* prim, const void* bias,
                             const void* scales, const void* pts,
                             const void* vol, void* d_feat, long long n, int nv,
                             int lsz, void* stream) {
  if (n <= 0) return 0;
  const long long tiles = tiles_of(n);
  using LG = LevelGroup<kBwdGroup>;
  hash3d_bwd_kernel<kBwdGroup><<<(unsigned)(tiles * LG::kCount), LG::kThreads,
                                 0, (cudaStream_t)stream>>>(
      (const float*)g, (const int*)prim, (const float*)bias,
      (const float*)scales, (const float*)pts, (const int*)vol,
      (float2*)d_feat, n, tiles, nv, (uint32_t)lsz);
  return (int)cudaGetLastError();
}
