// K9: the parallel (jittered-grid) marcher, threads a ray sized to the hit cap.
//
// Replaces f2nerf_tpu/sampler/device.py:547-646 (ray_march_parallel, with
// warp_jac_dir :173-189), a fused broadcast-and-reduce over [R, H, max_s]
// there; the plain version (ray_march_parallel_plain, sampler/device.py)
// is a chain of repeat_interleave, searchsorted and gathers. Per hit h of
// ray r:
//   step_h = sample_l * fineness (x max(|o - t_center| / t_dis, 1) with
//            scale_by_dis) / (|J(o + d near_h) d| + 1e-6), J the warp
//            Jacobian of the hit's leaf, 0 where the hit is past n_hits or
//            the step is not finite and positive;
//   n_h    = min(floor(max(far_h - near_h, 0) / max(step_h, 1e-12)), max_s);
// the hits' samples are laid end to end: slot s belongs to the first hit
// whose running end exceeds s, and
//   out_t[r, s] = near_h + ((s - start_h) + jitter[r, s]) * step_h,
//   out_dt = the hit's warp-space dt, out_node = the hit's node,
// and 0 / 0 / -1 past n_samples = min(the total, max_s). first_oct is the
// first hit's near (1e9 for a ray with none).
//
// Layout: a group of threads a ray, in whole warps, sized to the hit cap H
// (ray_march_parallel_geometry in sampler/device.py computes it and the
// wrapper passes it down): T = min(128, 32 * ceil(H / 32)) threads a ray,
// g = ceil(H / T) hits a thread (two at H 256), and several rays a block
// when T is small (K rays, K * T <= kMaxThreads), so the slice's 2,048 rays
// at H 64 are one wave. Two phases, two barriers:
//   1. a thread takes hits h = g t .. g t + g - 1 of its ray: the leaf row
//      max(trans_idx[max(node, 0)], 0), the entry point, |J d| with the 12
//      projections summed per axis in order k = 0..11 from 0.0 as
//      warp_jac_dir does (the leaf's w2xz and weight rows read as 33
//      float4 vectors), the step and n_h; the hit's near, step, dt, node
//      go to shared memory, and its running end within the thread's hits.
//      The running ends then come from warp shuffles over the threads'
//      totals, with one carry between a ray's warps (at most four) through
//      shared memory, all saturating at max_s (integers: exact; the ends
//      that matter are below max_s, and start_h of a slot's owner is the
//      end before it, so it is exact too).
//   2. over the ray's slots, coalesced: a binary search over the ends in
//      shared memory for the owner (searchsorted(right=True)), then the
//      sample.
// Every operation rounds as the plain version's torch ops do, in its
// order (__fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn/__fsqrt_rn: nvcc would
// contract the projections' multiply-adds into FMAs). fineness is a 0-d
// device tensor read through a pointer, so the caller never syncs.
//
// Bound: bytes (the hit rows, rays, jitter and the touched warp rows read
// once, the dense outputs written once): ~0.004 ms at the slice's 2,048
// rays x 512 slots. The Jacobians are ~400 f32 operations a hit, well
// under the card's f32 rate.
// Measured (chip_smoke.py --baseline, the earlier design in turns on the
// same inputs; NVIDIA H100 80GB HBM3, 700 W): 0.0176 ms at the slice step's
// 2,048 rays (hit cap 64, max_s 512; 23% of the bound) against 0.0308 for a
// block of 128 threads a ray (half of them idle in phase 1 at H 64, two
// waves of blocks, scalar loads of the leaf rows, warp 0 alone scanning
// the ends); 0.0188 against 0.0216 at 768 rays and H 256. 1, 2 or 4 rays a
// block are level; the w2xz float4s of a group of four projections loaded
// up front spilled and ran at 0.0195-0.0205 (scripts/sweep_kernels.py).

// Each entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;   // a block
constexpr int kRayThreads = 128;   // at most a ray
constexpr int kPros = 12;

struct Tree {
  const int* trans_idx;   // [N]
  const float* w2xz;      // [M, 96], rows 16-byte aligned
  const float* weight;    // [M, 36], rows 16-byte aligned
  const float* t_center;  // [M, 3]
  const float* t_dis;     // [M]
};

struct Out {
  float* t;           // [R, max_s]
  float* dt;          // [R, max_s]
  int* node;          // [R, max_s]
  int* n;             // [R]
  float* first_oct;   // [R]
};

// ((m0 x0 + m1 x1) + m2 x2): warp_jac_dir's a / b and r0d / r1d before
// the translation
__device__ __forceinline__ float row_dot(const float4 m, const float x[3]) {
  return __fadd_rn(__fadd_rn(__fmul_rn(m.x, x[0]), __fmul_rn(m.y, x[1])), __fmul_rn(m.z, x[2]));
}

__device__ __forceinline__ float lane4(const float4 v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// |J(x) d| (warp_jac_dir) of warp row tr: projection k = 4 kq + kk takes
// w2xz's float4s 2k and 2k + 1 and lane kk of weight's float4 kq of each
// axis (weight[12 ax + k])
__device__ __forceinline__ float jac_dir(const Tree& tree, int tr, const float x[3],
                                         const float d[3]) {
  const float4* m4 = reinterpret_cast<const float4*>(tree.w2xz + 96LL * tr);
  const float4* w4 = reinterpret_cast<const float4*>(tree.weight + 36LL * tr);
  float jd[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int kq = 0; kq < kPros / 4; ++kq) {
    float4 w[3];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) w[ax] = __ldg(w4 + 3 * ax + kq);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // loaded where they are used: all eight of a group up front spilled
      // at the 64 registers that keep 2,048 rays in one wave
      const float4 r0 = __ldg(m4 + 8 * kq + 2 * kk), r1 = __ldg(m4 + 8 * kq + 2 * kk + 1);
      const float a = __fadd_rn(row_dot(r0, x), r0.w);
      const float b = __fadd_rn(row_dot(r1, x), r1.w);
      const float r0d = row_dot(r0, d);
      const float r1d = row_dot(r1, d);
      const float dvd = __fsub_rn(__fdiv_rn(r0d, b),
                                  __fmul_rn(__fdiv_rn(a, __fmul_rn(b, b)), r1d));
#pragma unroll
      for (int ax = 0; ax < 3; ++ax)
        jd[ax] = __fadd_rn(jd[ax], __fmul_rn(lane4(w[ax], kk), dvd));
    }
  }
  return __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(jd[0], jd[0]), __fmul_rn(jd[1], jd[1])),
                              __fmul_rn(jd[2], jd[2])));
}

// one hit's step, warp-space dt and sample count (0 / 0 / 0 where the hit
// is past n_hits or its step is not finite and positive)
__device__ __forceinline__ int hit_samples(const Tree& tree, int node, float near, float far,
                                           const float o[3], const float d[3], float dt0,
                                           int max_s, int scale_by_dis, float& step, float& dt) {
  const int tr = max(tree.trans_idx[max(node, 0)], 0);
  float x[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) x[ax] = __fadd_rn(o[ax], __fmul_rn(d[ax], near));
  const float pnorm = __fadd_rn(jac_dir(tree, tr, x, d), (float)1e-6);
  dt = dt0;
  if (scale_by_dis) {
    float v[3];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) v[ax] = __fsub_rn(o[ax], tree.t_center[3LL * tr + ax]);
    const float nrm = __fsqrt_rn(__fadd_rn(
        __fadd_rn(__fmul_rn(v[0], v[0]), __fmul_rn(v[1], v[1])), __fmul_rn(v[2], v[2])));
    const float radius = __fdiv_rn(nrm, tree.t_dis[tr]);
    dt = __fmul_rn(dt, radius < 1.0f ? 1.0f : radius);     // NaN stays NaN
  }
  step = __fdiv_rn(dt, pnorm);
  if (isfinite(step) && step > 0.0f) {
    float span = __fsub_rn(far, near);
    span = span < 0.0f ? 0.0f : span;                     // NaN stays NaN
    float q = floorf(__fdiv_rn(span, step < (float)1e-12 ? (float)1e-12 : step));
    q = q > (float)max_s ? (float)max_s : q;
    return (int)q;
  }
  step = 0.0f;
  dt = 0.0f;
  return 0;
}

__global__ void __launch_bounds__(kMaxThreads, 4)
march_parallel_kernel(const int* __restrict__ hit_idx, const float* __restrict__ hit_near,
                      const float* __restrict__ hit_far, const int* __restrict__ n_hits,
                      const float* __restrict__ rays_o, const float* __restrict__ rays_d,
                      const float* __restrict__ jitter, const float* __restrict__ fineness,
                      Tree tree, Out out, int R, int H, int max_s, float sample_l,
                      int scale_by_dis, int ray_threads) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_warp_end[kMaxThreads / 32];   // each warp's total (saturated)
  const int k = threadIdx.x / ray_threads;        // the block's ray
  const int t = threadIdx.x - k * ray_threads;    // the ray's thread
  const int lane = threadIdx.x & 31;
  const int w = t >> 5;                           // the ray's warp
  const int g = (H + ray_threads - 1) / ray_threads;   // hits a thread
  float* s_near = reinterpret_cast<float*>(smem) + (long long)k * 5 * H;   // [H] each
  float* s_step = s_near + H;
  float* s_dt = s_step + H;
  int* s_node = reinterpret_cast<int*>(s_dt + H);
  int* s_end = s_node + H;    // the running ends, saturated at max_s

  const int r = blockIdx.x * (blockDim.x / ray_threads) + k;
  const bool live = r < R;
  const long long hrow = (long long)r * H;
  const int nh = live ? n_hits[r] : 0;
  float o[3] = {0.0f, 0.0f, 0.0f}, d[3] = {0.0f, 0.0f, 0.0f};
  if (live) {
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      o[ax] = rays_o[3 * r + ax];
      d[ax] = rays_d[3 * r + ax];
    }
  }
  // sample_l * fineness * ones: the f32 product
  const float dt0 = __fmul_rn(sample_l, *fineness);

  // ---- 1. a thread its g hits, their running end within the thread
  int run = 0;
  const int h0 = g * t;
  for (int j = 0; j < g; ++j) {
    const int h = h0 + j;
    if (!live || h >= H) break;
    const int node = hit_idx[hrow + h];
    const float near = hit_near[hrow + h];
    float step = 0.0f, dt = 0.0f;
    int n = 0;
    if (h < nh)
      n = hit_samples(tree, node, near, hit_far[hrow + h], o, d, dt0, max_s, scale_by_dis,
                      step, dt);
    run = min(run + n, max_s);
    s_near[h] = near;
    s_step[h] = step;
    s_dt[h] = dt;
    s_node[h] = node;
    s_end[h] = run;
  }
  // the threads' totals over the warp (inclusive, saturating), then each
  // warp's total to shared memory
  int inc = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc = min(inc + u, max_s);
  }
  const int before = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 31) s_warp_end[threadIdx.x >> 5] = inc;
  __syncthreads();
  // the carry into the thread: the ray's earlier warps in order, then the
  // warp's earlier threads
  int carry = 0;
  for (int v = 0; v < w; ++v) carry = min(carry + s_warp_end[(threadIdx.x >> 5) - w + v], max_s);
  if (lane > 0) carry = min(carry + before, max_s);
  for (int j = 0; j < g; ++j) {
    const int h = h0 + j;
    if (!live || h >= H) break;
    s_end[h] = min(s_end[h] + carry, max_s);
  }
  __syncthreads();
  if (!live) return;                              // no barrier follows
  const int total = s_end[H - 1];
  if (t == 0) {
    out.n[r] = total;
    out.first_oct[r] = nh > 0 ? hit_near[hrow] : 1e9f;
  }

  // ---- 2. the slots
  const long long orow = (long long)r * max_s;
  for (int s = t; s < max_s; s += ray_threads) {
    float tt = 0.0f, dt = 0.0f;
    int node = -1;
    if (s < total) {
      int lo = 0, hi = H - 1;           // the first h with end > s (one exists)
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (s_end[mid] > s) hi = mid; else lo = mid + 1;
      }
      const int start = lo > 0 ? s_end[lo - 1] : 0;
      const float kf = __fsub_rn((float)s, (float)start);
      tt = __fadd_rn(s_near[lo], __fmul_rn(__fadd_rn(kf, jitter[orow + s]), s_step[lo]));
      dt = s_dt[lo];
      node = s_node[lo];
    }
    out.t[orow + s] = tt;
    out.dt[orow + s] = dt;
    out.node[orow + s] = node;
  }
}

}  // namespace

// All outputs are written by the kernel. ray_threads (a multiple of 32,
// at most kRayThreads) and rays_per_block as ray_march_parallel_geometry
// gives them; w2xz and weight 16-byte aligned.
extern "C" int f2_ray_march_parallel(
    const void* hit_idx, const void* hit_near, const void* hit_far, const void* n_hits,
    const void* rays_o, const void* rays_d, const void* jitter, const void* fineness,
    const void* trans_idx, const void* w2xz, const void* weight, const void* t_center,
    const void* t_dis, void* out_t, void* out_dt, void* out_node, void* n_out,
    void* first_oct, int R, int H, int max_s, float sample_l, int scale_by_dis,
    int ray_threads, int rays_per_block, void* stream) {
  if (R <= 0) return 0;
  if (H < 1 || ray_threads < 32 || ray_threads % 32 != 0 || ray_threads > kRayThreads ||
      rays_per_block < 1 || ray_threads * rays_per_block > kMaxThreads ||
      ((uintptr_t)w2xz & 15) != 0 || ((uintptr_t)weight & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const Tree tree{(const int*)trans_idx, (const float*)w2xz, (const float*)weight,
                  (const float*)t_center, (const float*)t_dis};
  const Out out{(float*)out_t, (float*)out_dt, (int*)out_node, (int*)n_out,
                (float*)first_oct};
  const size_t smem = (size_t)rays_per_block * H * 5 * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        march_parallel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned grid = (unsigned)((R + rays_per_block - 1) / rays_per_block);
  march_parallel_kernel<<<grid, ray_threads * rays_per_block, smem, (cudaStream_t)stream>>>(
      (const int*)hit_idx, (const float*)hit_near, (const float*)hit_far,
      (const int*)n_hits, (const float*)rays_o, (const float*)rays_d,
      (const float*)jitter, (const float*)fineness, tree, out, R, H, max_s, sample_l,
      scale_by_dis, ray_threads);
  return (int)cudaGetLastError();
}
