// K2 / K3: HashBlock encode and its table-gradient scatter.
//
// Replace the XLA lowerings of f2nerf_tpu/fields/hash_block.py:
//   K2 hash_block_fwd  <- _encode_fwd_impl (:153-178)
//   K3 hash_block_bwd  <- _hash_block_bwd  (:191-215), the backward of both
//      hash_block_encode and hash_block_gather_cached. On the training step
//      one K3 launch scatters both (fields/hash_block.py,
//      hash_block_grad_pass): B's samples and the edge samples are two
//      segments of one launch into one zero-filled gradient.
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
// Layout of the work (both kernels). A block takes a tile of 32
// consecutive samples and a group of G consecutive levels; warp w works
// level G*group + w over the tile, one sample a lane, so a warp's lanes are
// neighbours along a ray at one level. The grid runs the level groups one
// after another (block = group * tiles + tile), so only G levels' rows are
// in flight: 8.4 MB a level at 2^19, where all 16 levels (134 MB) do not
// fit the 50 MB L2. K2 takes G = 4 (33.5 MB; a sample's 4 levels are 8
// floats, one 32-byte sector of its output row, written whole). K3 takes
// G = 2 (16.8 MB): on the card it was 13% faster than G = 4 and 3-10%
// faster than G = 1 (chip_smoke.py's K3 at the uniform shape, H100 SXM);
// all 16 levels in one block was 1.7x slower than G = 4.
//
// K2. Bound: the bytes it must move, points and volumes (16 B a sample)
// and the touched rows (512 B each) read once, the output (128 B a sample)
// written once: 187 MB at chip_smoke's uniform shape (n 393,216, 255,537
// rows), 0.056 ms at 3.35 TB/s; 148 MB at the slice's A (cap1 327,680,
// 197,210 rows), 0.044 ms. PR 2's kernel (one thread a (sample, level), a
// warp = 2 samples x 16 levels) took 0.476 ms at the uniform shape: the
// table did not fit L2, so rows were fetched from memory again and again.
// Each lane reads a dz-pair as one float4 where aligned (else two float2),
// sums the 8 corners in the order dx, dy, dz (bit for bit the plain
// version), and the tile's [32, 8] output is staged in shared memory and
// written 16 bytes a thread.
//
// K3. Bound: g (128 B a sample), points and volumes (16 B) read once and
// the output, the dense [16, nb, 128] gradient (134 MB at 2^19, zero-filled
// by the wrapper), written once: 191 MB / 0.057 ms at the uniform shape;
// 174 MB / 0.052 ms at the slice's B + edges (278,528 samples). PR 2's kernel took 1.886 ms there and 4.946 ms at the slice (two
// launches plus the add): 16 scalar atomicAdds a (sample, level), piling
// onto a few addresses where samples share a cell. Here:
//  - lanes are keyed by (row, cell) and grouped with __match_any_sync; a
//    group's 16 weighted values are summed through shared memory by its
//    lowest lane, which alone issues the group's atomics (at fine levels
//    groups are single lanes, and the cost is the one match);
//  - a dz-pair of corners is one float4 atomicAdd when 16-byte aligned
//    (cz even), else two float2 (a corner's two channels): 4 to 8 atomic
//    instructions a (sample, level) instead of 16; an all-zero vector
//    (g = 0 on padding rows) is not issued;
//  - the level groups keep the atomics' rows in L2.
// The merge costs max(m, 16) shared-memory steps for a group of m lanes
// (each lane sums the values of index rank, rank + m, ... over the group),
// not 16 m: at the slice, before zero-gradient lanes were dropped and the
// sum spread over the lanes, merging made K3 slower than no merging.
// Atomics sum in no fixed order, so K3 agrees with its plain version to
// rounding (chip_smoke.py holds it to 1e-5 of the largest entry).
//
// 64-bit offsets throughout; each entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLevels = 16;
constexpr int kLanes = 128;
constexpr int kTile = 32;        // samples a block, one a lane
constexpr int kValStride = 20;   // a lane's 16 staged values, padded: float4
                                 // accesses of 8 lanes hit distinct banks

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
// Level group widths (see the notes at the top).
constexpr int kFwdGroup = 4;
constexpr int kBwdGroup = 2;

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

__device__ __forceinline__ void locate(const float* p, int vi,
                                       const int* __restrict__ prim,
                                       const float* __restrict__ bias,
                                       const float* __restrict__ scales, int l,
                                       int nv, int nb, Corner* c) {
  const float scale = scales[l];
  const long long pb = ((long long)l * nv + vi) * 3;
  uint32_t h = 0;
  int cs[3];
  float ts[3];
  for (int ax = 0; ax < 3; ++ax) {
    const float x = __fadd_rn(__fmul_rn(p[ax], scale), bias[pb + ax]);
    const float f = floorf(x);
    const int fi = (int)f;
    const int b = floor_div3(fi);
    cs[ax] = fi - 3 * b;
    ts[ax] = __fadd_rn((float)cs[ax], __fsub_rn(x, f));
    h ^= (uint32_t)b * (uint32_t)prim[pb + ax];
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

// One run of samples scattered by a K3 launch.
struct Segment {
  const float* g;    // [n, 32]
  const float* pts;  // [n, 3]
  const int* vol;    // [n]
  long long n, tiles;
};

__device__ __forceinline__ bool any_nonzero(float4 a) {
  return a.x != 0.0f || a.y != 0.0f || a.z != 0.0f || a.w != 0.0f;
}

template <int G>
__global__ void __launch_bounds__(LevelGroup<G>::kThreads)
hash_block_bwd_kernel(Segment s0, Segment s1, const int* __restrict__ prim,
                      const float* __restrict__ bias,
                      const float* __restrict__ scales,
                      float* __restrict__ d_feat, int nv, int nb) {
  using LG = LevelGroup<G>;
  __shared__ float spts[kTile * 3];
  __shared__ int svol[kTile];
  __shared__ __align__(16) float sg[kTile * LG::kRowStride];
  __shared__ __align__(16) float sval[G][32][kValStride];
  const long long tiles = s0.tiles + s1.tiles;
  const int group = (int)(blockIdx.x / tiles);
  const long long tile = blockIdx.x % tiles;
  const bool first = tile < s0.tiles;
  const float* g = first ? s0.g : s1.g;
  const long long base = (first ? tile : tile - s0.tiles) * kTile;
  const int cnt = (int)min((long long)kTile, (first ? s0.n : s1.n) - base);
  load_points(first ? s0.pts : s1.pts, first ? s0.vol : s1.vol, base, cnt,
              spts, svol);
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
  // a lane with g = 0 (the grad pass's padding rows) adds nothing
  bool active = false;
  float2 gl;
  if (lane < cnt) {
    gl = *reinterpret_cast<const float2*>(sg + lane * LG::kRowStride + 2 * w);
    active = gl.x != 0.0f || gl.y != 0.0f;
  }
  Corner c;
  float v[16];  // pair (dx, dy) = v[4*(2dx+dy) .. +3], as the row holds it
  unsigned long long key = ~0ull;  // never a real (row, cell) key
  if (active) {
    locate(spts + lane * 3, svol[lane], prim, bias, scales, group * G + w, nv,
           nb, &c);
#pragma unroll
    for (int dx = 0; dx < 2; ++dx)
#pragma unroll
      for (int dy = 0; dy < 2; ++dy)
#pragma unroll
        for (int dz = 0; dz < 2; ++dz) {
          const float wt = __fmul_rn(__fmul_rn(c.wx[dx], c.wy[dy]), c.wz[dz]);
          v[4 * (2 * dx + dy) + 2 * dz] = __fmul_rn(gl.x, wt);
          v[4 * (2 * dx + dy) + 2 * dz + 1] = __fmul_rn(gl.y, wt);
        }
    // a row offset is a multiple of 128: the cell fits in its low bits
    key = (unsigned long long)c.row | (unsigned long long)(c.cx * 16 + c.cy * 4 + c.cz);
  }
  // lanes on one (row, cell) add into its lowest lane's values: value k is
  // summed over the group's lanes, in lane order, by the lane of rank
  // k mod (group size), so a group of m lanes takes max(m, 16) steps
  const unsigned grp = __match_any_sync(0xffffffffu, key);
  const int m = __popc(grp), leader = __ffs(grp) - 1;
  const bool merge = active && m > 1;
  float* mine = sval[w][lane];
  if (merge) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      reinterpret_cast<float4*>(mine)[q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }
  __syncwarp();
  if (merge) {
    for (int k = __popc(grp & ((1u << lane) - 1)); k < 16; k += m) {
      float sum = 0.0f;
      for (unsigned b = grp; b; b &= b - 1) sum = __fadd_rn(sum, sval[w][__ffs(b) - 1][k]);
      sval[w][leader][k] = sum;   // only this lane reads or writes index k
    }
  }
  __syncwarp();
  if (!active || lane != leader) return;
  if (m > 1) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 a = reinterpret_cast<const float4*>(mine)[q];
      v[4 * q] = a.x;
      v[4 * q + 1] = a.y;
      v[4 * q + 2] = a.z;
      v[4 * q + 3] = a.w;
    }
  }
  float* row = d_feat + c.row;
#pragma unroll
  for (int dx = 0; dx < 2; ++dx)
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const int q = 2 * dx + dy;
      const float4 a = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
      if (!any_nonzero(a)) continue;
      float* p = row + pair_lane(c, dx, dy);
      if ((c.cz & 1) == 0) {
        atomicAdd(reinterpret_cast<float4*>(p), a);
      } else {
        atomicAdd(reinterpret_cast<float2*>(p), make_float2(a.x, a.y));
        atomicAdd(reinterpret_cast<float2*>(p + 2), make_float2(a.z, a.w));
      }
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

// Two segments of samples (n1 may be 0) into one gradient d_feat.
extern "C" int f2_hash_block_bwd(const void* g0, const void* pts0,
                                 const void* vol0, int n0, const void* g1,
                                 const void* pts1, const void* vol1, int n1,
                                 const void* prim, const void* bias,
                                 const void* scales, void* d_feat, int nv,
                                 int nb, void* stream) {
  const Segment s0{(const float*)g0, (const float*)pts0, (const int*)vol0,
                   n0, tiles_of(n0 > 0 ? n0 : 0)};
  const Segment s1{(const float*)g1, (const float*)pts1, (const int*)vol1,
                   n1, tiles_of(n1 > 0 ? n1 : 0)};
  const long long tiles = s0.tiles + s1.tiles;
  if (tiles == 0) return 0;
  using LG = LevelGroup<kBwdGroup>;
  hash_block_bwd_kernel<kBwdGroup><<<(unsigned)(tiles * LG::kCount),
                                     LG::kThreads, 0, (cudaStream_t)stream>>>(
      s0, s1, (const int*)prim, (const float*)bias, (const float*)scales,
      (float*)d_feat, nv, nb);
  return (int)cudaGetLastError();
}
