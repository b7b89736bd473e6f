// K2 / K3: HashBlock encode and its table-gradient scatter.
//
// Replace the XLA lowerings of f2nerf_tpu/fields/hash_block.py:
//   K2 hash_block_fwd  <- _encode_fwd_impl (:153-178)
//   K3 hash_block_bwd  <- _hash_block_bwd  (:191-215), which serves both
//      hash_block_encode and hash_block_gather_cached.
//
// One thread per (sample, level). Level-major per sample: thread t handles
// sample t/16, level t%16, so a warp writes two samples' 32 contiguous
// outputs. The block hash is computed exactly as hash_block.py:106-121:
//   x = p*scale + bias (per axis), f = floor(x), b = f // 3, c = f - 3b,
//   h = (bx*pa ^ by*pb ^ bz*pc) & (nb-1) in uint32.
// The index math uses __fmul_rn/__fadd_rn: a contracted FMA can move x by
// one ulp across a cell or block boundary, and block-boundary corner values
// are duplicated per block (not shared), so a changed block changes the
// feature. The trilinear weights follow the JAX tent form
// max(0, 1 - |lane - (c + a)|) per axis, multiplied x*y*z.
//
// Each thread reads only the 8 corners x 2 channels it needs from its
// 128-float row (8 float2 loads); the 128-lane weight sum of the TPU code
// is a vector-register idiom with no use here.
//
// Bound on this card: random row access. K2 reads 16 rows' worth of 64 B
// (8 x 8 B, two 32 B sectors per corner pair at best) per sample, ~1 KB
// per sample at n = 393k -> ~0.4 GB of sector traffic; the 128 MB table
// (2^19 table, 16 levels) does not fit the 50 MB L2. K3 issues 16 f32
// atomicAdds per (sample, level) into the same table. Sorting samples for
// locality and vectorised atomics are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLevels = 16;
constexpr int kLanes = 128;

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

__device__ __forceinline__ void locate(const float* __restrict__ pts,
                                       const int* __restrict__ vol,
                                       const int* __restrict__ prim,
                                       const float* __restrict__ bias,
                                       const float* __restrict__ scales,
                                       int i, int l, int nv, int nb,
                                       Corner* c) {
  const int vi = vol[i];
  const float scale = scales[l];
  const long long pb = ((long long)l * nv + vi) * 3;
  uint32_t h = 0;
  int cs[3];
  float ts[3];
  for (int ax = 0; ax < 3; ++ax) {
    const float x = __fadd_rn(__fmul_rn(pts[(long long)i * 3 + ax], scale),
                              bias[pb + ax]);
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

__global__ void hash_block_fwd_kernel(const float* __restrict__ feat,
                                      const int* __restrict__ prim,
                                      const float* __restrict__ bias,
                                      const float* __restrict__ scales,
                                      const float* __restrict__ pts,
                                      const int* __restrict__ vol,
                                      float* __restrict__ out, int n, int nv,
                                      int nb) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n * kLevels) return;
  const int i = (int)(t / kLevels), l = (int)(t % kLevels);
  Corner c;
  locate(pts, vol, prim, bias, scales, i, l, nv, nb, &c);
  const float* row = feat + c.row;
  float acc0 = 0.0f, acc1 = 0.0f;
  for (int dx = 0; dx < 2; ++dx)
    for (int dy = 0; dy < 2; ++dy)
      for (int dz = 0; dz < 2; ++dz) {
        const float w = __fmul_rn(__fmul_rn(c.wx[dx], c.wy[dy]), c.wz[dz]);
        const int lane = (c.cx + dx) * 32 + (c.cy + dy) * 8 + (c.cz + dz) * 2;
        const float2 r = *reinterpret_cast<const float2*>(row + lane);
        acc0 = __fadd_rn(acc0, __fmul_rn(r.x, w));
        acc1 = __fadd_rn(acc1, __fmul_rn(r.y, w));
      }
  out[(long long)i * (2 * kLevels) + 2 * l] = acc0;
  out[(long long)i * (2 * kLevels) + 2 * l + 1] = acc1;
}

__global__ void hash_block_bwd_kernel(const float* __restrict__ g,
                                      const int* __restrict__ prim,
                                      const float* __restrict__ bias,
                                      const float* __restrict__ scales,
                                      const float* __restrict__ pts,
                                      const int* __restrict__ vol,
                                      float* __restrict__ d_feat, int n,
                                      int nv, int nb) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n * kLevels) return;
  const int i = (int)(t / kLevels), l = (int)(t % kLevels);
  const float g0 = g[(long long)i * (2 * kLevels) + 2 * l];
  const float g1 = g[(long long)i * (2 * kLevels) + 2 * l + 1];
  Corner c;
  locate(pts, vol, prim, bias, scales, i, l, nv, nb, &c);
  float* row = d_feat + c.row;
  for (int dx = 0; dx < 2; ++dx)
    for (int dy = 0; dy < 2; ++dy)
      for (int dz = 0; dz < 2; ++dz) {
        const float w = __fmul_rn(__fmul_rn(c.wx[dx], c.wy[dy]), c.wz[dz]);
        const int lane = (c.cx + dx) * 32 + (c.cy + dy) * 8 + (c.cz + dz) * 2;
        atomicAdd(row + lane, __fmul_rn(g0, w));
        atomicAdd(row + lane + 1, __fmul_rn(g1, w));
      }
}

unsigned grid_for(long long threads, int block) {
  return (unsigned)((threads + block - 1) / block);
}

}  // namespace

extern "C" int f2_hash_block_fwd(const void* feat, const void* prim,
                                 const void* bias, const void* scales,
                                 const void* pts, const void* vol, void* out,
                                 int n, int nv, int nb, void* stream) {
  if (n <= 0) return 0;
  const int block = 256;
  hash_block_fwd_kernel<<<grid_for((long long)n * kLevels, block), block, 0,
                          (cudaStream_t)stream>>>(
      (const float*)feat, (const int*)prim, (const float*)bias,
      (const float*)scales, (const float*)pts, (const int*)vol, (float*)out, n,
      nv, nb);
  return (int)cudaGetLastError();
}

extern "C" int f2_hash_block_bwd(const void* g, const void* prim,
                                 const void* bias, const void* scales,
                                 const void* pts, const void* vol,
                                 void* d_feat, int n, int nv, int nb,
                                 void* stream) {
  if (n <= 0) return 0;
  const int block = 256;
  hash_block_bwd_kernel<<<grid_for((long long)n * kLevels, block), block, 0,
                          (cudaStream_t)stream>>>(
      (const float*)g, (const int*)prim, (const float*)bias,
      (const float*)scales, (const float*)pts, (const int*)vol,
      (float*)d_feat, n, nv, nb);
  return (int)cudaGetLastError();
}
