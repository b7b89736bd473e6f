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
//
// Layout: one thread per (sample, level), thread i = sample * 16 + level,
// so a warp covers two samples' 16 levels and its output stores (a float2
// a thread, level-major, channel-minor) are one contiguous 256-byte run.
// The pool is [pool, 2] f32, a corner's two channels one 8-byte float2.
//
// K5. Bound: the bytes it must move, points and volumes (16 B a sample),
// the distinct pool entries it touches (8 B each) read once, the output
// (128 B a sample) written once. Each thread issues its eight float2 corner
// loads independently (no dependence between them), so a warp has 256
// loads in flight; at 2^19 a level's 4 MB slice of the pool fits the
// 50 MB L2, the whole 67 MB pool does not.
//
// K6. Bound: g (128 B a sample), points and volumes read once, and the
// dense [pool, 2] gradient (67 MB at 2^19, zero-filled by the wrapper)
// written once. Eight float2 atomicAdds a (sample, level) (sm_90 has
// vector atomics on global memory); a (sample, level) whose two gradient
// values are both zero is skipped (the grad pass's padding rows all share
// one cell). Atomics sum in no fixed order, so K6 agrees with its plain
// version to rounding (chip_smoke.py holds it to 1e-5 of the largest
// entry).
//
// 64-bit offsets throughout; each entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLevels = 16;
constexpr int kThreads = 256;

struct Cell {
  uint32_t h0[3], h1[3];
  float a[3];
};

__device__ __forceinline__ void locate(const float* __restrict__ pts,
                                       const int* __restrict__ vol,
                                       const int* __restrict__ prim,
                                       const float* __restrict__ bias,
                                       const float* __restrict__ scales,
                                       long long s, int l, int nv, Cell* c) {
  const float scale = scales[l];
  const long long pb = ((long long)l * nv + vol[s]) * 3;
  for (int ax = 0; ax < 3; ++ax) {
    const float x = __fadd_rn(__fmul_rn(pts[s * 3 + ax], scale), bias[pb + ax]);
    const float f = floorf(x);
    const uint32_t p = (uint32_t)prim[pb + ax];
    c->a[ax] = __fsub_rn(x, f);
    c->h0[ax] = (uint32_t)(int)f * p;
    c->h1[ax] = c->h0[ax] + p;
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

__global__ void __launch_bounds__(kThreads)
hash3d_fwd_kernel(const float2* __restrict__ feat, const int* __restrict__ prim,
                  const float* __restrict__ bias, const float* __restrict__ scales,
                  const float* __restrict__ pts, const int* __restrict__ vol,
                  float2* __restrict__ out, long long n, int nv, uint32_t lsz) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * kLevels) return;
  const long long s = i / kLevels;
  const int l = (int)(i % kLevels);
  Cell c;
  locate(pts, vol, prim, bias, scales, s, l, nv, &c);
  long long idx[8];
  float w[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) corner(c, k, l, lsz, &idx[k], &w[k]);
  float2 r[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) r[k] = feat[idx[k]];
  float acc0 = 0.0f, acc1 = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    acc0 = __fadd_rn(acc0, __fmul_rn(r[k].x, w[k]));
    acc1 = __fadd_rn(acc1, __fmul_rn(r[k].y, w[k]));
  }
  out[i] = make_float2(acc0, acc1);   // out[s, 2l .. 2l+1]
}

__global__ void __launch_bounds__(kThreads)
hash3d_bwd_kernel(const float2* __restrict__ g, const int* __restrict__ prim,
                  const float* __restrict__ bias, const float* __restrict__ scales,
                  const float* __restrict__ pts, const int* __restrict__ vol,
                  float2* __restrict__ d_feat, long long n, int nv, uint32_t lsz) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * kLevels) return;
  const float2 gl = g[i];             // g[s, 2l .. 2l+1]
  if (gl.x == 0.0f && gl.y == 0.0f) return;
  const long long s = i / kLevels;
  const int l = (int)(i % kLevels);
  Cell c;
  locate(pts, vol, prim, bias, scales, s, l, nv, &c);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    long long idx;
    float w;
    corner(c, k, l, lsz, &idx, &w);
    atomicAdd(d_feat + idx, make_float2(__fmul_rn(gl.x, w), __fmul_rn(gl.y, w)));
  }
}

unsigned blocks_of(long long n) {
  return (unsigned)((n * kLevels + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int f2_hash3d_fwd(const void* feat, const void* prim,
                             const void* bias, const void* scales,
                             const void* pts, const void* vol, void* out,
                             long long n, int nv, int lsz, void* stream) {
  if (n <= 0) return 0;
  hash3d_fwd_kernel<<<blocks_of(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)feat, (const int*)prim, (const float*)bias,
      (const float*)scales, (const float*)pts, (const int*)vol, (float2*)out, n,
      nv, (uint32_t)lsz);
  return (int)cudaGetLastError();
}

extern "C" int f2_hash3d_bwd(const void* g, const void* prim, const void* bias,
                             const void* scales, const void* pts,
                             const void* vol, void* d_feat, long long n, int nv,
                             int lsz, void* stream) {
  if (n <= 0) return 0;
  hash3d_bwd_kernel<<<blocks_of(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)g, (const int*)prim, (const float*)bias,
      (const float*)scales, (const float*)pts, (const int*)vol,
      (float2*)d_feat, n, nv, (uint32_t)lsz);
  return (int)cudaGetLastError();
}
