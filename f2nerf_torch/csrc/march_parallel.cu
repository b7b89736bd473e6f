// K9: the parallel (jittered-grid) marcher, a block a ray.
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
// Layout: a block of kThreads a ray, in two phases.
//   1. Over the ray's H hits, a thread a hit: the leaf row
//      max(trans_idx[max(node, 0)], 0), the entry point, |J d| with the 12
//      projections summed per axis in order k = 0..11 from 0.0 as
//      warp_jac_dir does, the step and n_h; the hit's near, step, dt, node
//      and n_h go to shared memory. Warp 0 then scans n_h in chunks of 32
//      (shuffles, integers: exact), saturating at max_s: the ends that
//      matter are below max_s, and start_h of a slot's owner is the end
//      before it, so it is exact too.
//   2. Over the slots, coalesced: a binary search over the ends in shared
//      memory for the owner (searchsorted(right=True)), then the sample.
// Every operation rounds as the plain version's torch ops do, in its
// order (__fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn/__fsqrt_rn: nvcc would
// contract the projections' multiply-adds into FMAs). fineness is a 0-d
// device tensor read through a pointer, so the caller never syncs.
//
// Bound: bytes (the hit rows, rays, jitter and the touched warp rows read
// once, the dense outputs written once): ~0.005 ms at the slice's 2,048
// rays x 512 slots. The Jacobians are ~400 f32 operations a hit, well
// under the card's f32 rate.
// Measured (chip_smoke.py; NVIDIA H100 80GB HBM3, 700 W): 0.031 ms at the
// slice step's 2,048 rays (hit cap 64, max_s 512), 13% of the bound; half
// the threads idle in phase 1 at a hit cap of 64. 48 registers.

// Each entry point returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPros = 12;

struct Tree {
  const int* trans_idx;   // [N]
  const float* w2xz;      // [M, 96]
  const float* weight;    // [M, 36]
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

// ((m0 x0 + m1 x1) + m2 x2) (+ m3): warp_jac_dir's a / b and r0d / r1d
__device__ __forceinline__ float row_dot(const float* m, const float x[3]) {
  return __fadd_rn(__fadd_rn(__fmul_rn(m[0], x[0]), __fmul_rn(m[1], x[1])),
                   __fmul_rn(m[2], x[2]));
}

// |J(x) d| (warp_jac_dir) of warp row tr
__device__ float jac_dir(const Tree& tree, int tr, const float x[3], const float d[3]) {
  const float* m = tree.w2xz + 96LL * tr;
  const float* w = tree.weight + 36LL * tr;
  float jd[3] = {0.0f, 0.0f, 0.0f};
  for (int k = 0; k < kPros; ++k) {
    const float* mk = m + 8 * k;
    const float a = __fadd_rn(row_dot(mk, x), mk[3]);
    const float b = __fadd_rn(row_dot(mk + 4, x), mk[7]);
    const float r0d = row_dot(mk, d);
    const float r1d = row_dot(mk + 4, d);
    const float dvd = __fsub_rn(__fdiv_rn(r0d, b),
                                __fmul_rn(__fdiv_rn(a, __fmul_rn(b, b)), r1d));
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) jd[ax] = __fadd_rn(jd[ax], __fmul_rn(w[12 * ax + k], dvd));
  }
  return __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(jd[0], jd[0]), __fmul_rn(jd[1], jd[1])),
                              __fmul_rn(jd[2], jd[2])));
}

__global__ void __launch_bounds__(kThreads)
march_parallel_kernel(const int* __restrict__ hit_idx, const float* __restrict__ hit_near,
                      const float* __restrict__ hit_far, const int* __restrict__ n_hits,
                      const float* __restrict__ rays_o, const float* __restrict__ rays_d,
                      const float* __restrict__ jitter, const float* __restrict__ fineness,
                      Tree tree, Out out, int H, int max_s, float sample_l,
                      int scale_by_dis) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_near = reinterpret_cast<float*>(smem);  // [H] each
  float* s_step = s_near + H;
  float* s_dt = s_step + H;
  int* s_node = reinterpret_cast<int*>(s_dt + H);
  int* s_end = s_node + H;    // n_h, then the running ends (saturated at max_s)
  __shared__ int s_total;

  const int r = blockIdx.x;
  const long long hrow = (long long)r * H;
  const int nh = n_hits[r];
  const float o[3] = {rays_o[3 * r], rays_o[3 * r + 1], rays_o[3 * r + 2]};
  const float d[3] = {rays_d[3 * r], rays_d[3 * r + 1], rays_d[3 * r + 2]};
  // sample_l * fineness * ones: the f32 product
  const float dt0 = __fmul_rn(sample_l, *fineness);

  // ---- 1. a thread a hit
  for (int h = threadIdx.x; h < H; h += kThreads) {
    const int node = hit_idx[hrow + h];
    const float near = hit_near[hrow + h];
    float step = 0.0f, dt = 0.0f;
    int n = 0;
    if (h < nh) {
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
        float span = __fsub_rn(hit_far[hrow + h], near);
        span = span < 0.0f ? 0.0f : span;                     // NaN stays NaN
        float q = floorf(__fdiv_rn(span, step < (float)1e-12 ? (float)1e-12 : step));
        q = q > (float)max_s ? (float)max_s : q;
        n = (int)q;
      } else {
        step = 0.0f;
        dt = 0.0f;
      }
    }
    s_near[h] = near;
    s_step[h] = step;
    s_dt[h] = dt;
    s_node[h] = node;
    s_end[h] = n;
  }
  __syncthreads();
  // ---- the running ends: warp 0, chunks of 32, saturating at max_s
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int carry = 0;
    for (int base = 0; base < H; base += 32) {
      const int h = base + lane;
      int v = h < H ? s_end[h] : 0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v = min(v + u, max_s);
      }
      v = min(v + carry, max_s);
      if (h < H) s_end[h] = v;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
    if (lane == 0) {
      s_total = carry;
      out.n[r] = carry;
      out.first_oct[r] = nh > 0 ? hit_near[hrow] : 1e9f;
    }
  }
  __syncthreads();

  // ---- 2. the slots
  const int total = s_total;
  const long long orow = (long long)r * max_s;
  for (int s = threadIdx.x; s < max_s; s += kThreads) {
    float t = 0.0f, dt = 0.0f;
    int node = -1;
    if (s < total) {
      int lo = 0, hi = H - 1;           // the first h with end > s (one exists)
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (s_end[mid] > s) hi = mid; else lo = mid + 1;
      }
      const int start = lo > 0 ? s_end[lo - 1] : 0;
      const float k = __fsub_rn((float)s, (float)start);
      t = __fadd_rn(s_near[lo], __fmul_rn(__fadd_rn(k, jitter[orow + s]), s_step[lo]));
      dt = s_dt[lo];
      node = s_node[lo];
    }
    out.t[orow + s] = t;
    out.dt[orow + s] = dt;
    out.node[orow + s] = node;
  }
}

}  // namespace

// All outputs are written by the kernel.
extern "C" int f2_ray_march_parallel(
    const void* hit_idx, const void* hit_near, const void* hit_far, const void* n_hits,
    const void* rays_o, const void* rays_d, const void* jitter, const void* fineness,
    const void* trans_idx, const void* w2xz, const void* weight, const void* t_center,
    const void* t_dis, void* out_t, void* out_dt, void* out_node, void* n_out,
    void* first_oct, int R, int H, int max_s, float sample_l, int scale_by_dis,
    void* stream) {
  if (R <= 0) return 0;
  const Tree tree{(const int*)trans_idx, (const float*)w2xz, (const float*)weight,
                  (const float*)t_center, (const float*)t_dis};
  const Out out{(float*)out_t, (float*)out_dt, (int*)out_node, (int*)n_out,
                (float*)first_oct};
  const size_t smem = (size_t)H * 5 * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        march_parallel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  march_parallel_kernel<<<R, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)hit_idx, (const float*)hit_near, (const float*)hit_far,
      (const int*)n_hits, (const float*)rays_o, (const float*)rays_d,
      (const float*)jitter, (const float*)fineness, tree, out, H, max_s, sample_l,
      scale_by_dis);
  return (int)cudaGetLastError();
}
