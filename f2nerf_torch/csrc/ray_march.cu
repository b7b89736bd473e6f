// K7: the lockstep ray marcher, one thread per ray.
//
// Replaces the jax.lax.while_loop of f2nerf_tpu/sampler/device.py:436-544
// (ray_march), the reference-exact EMIT/ADVANCE state machine of
// RayMarchKernel (PersSampler.cu:189-314). There every iteration runs ~40
// whole-batch ops for every ray, up to max_s + H + 8 times; here a ray's
// state (t, hit pointer, step, flags, sample count) stays in registers and
// the thread runs the body on its own ray until the ray is done or the
// iteration bound is reached. A ray's body never reads another ray's
// state, so this is the lockstep loop's result exactly.
//
// EMIT (not advancing): the warp Jacobian |J(x) d| at x = o + d t in the
// current hit's leaf (the leaf's 96 w2xz and 36 weight floats, read
// through L1; a ray reads the same leaf until it advances), the step
//   e = sample_l * noise[r + n] / (|J d| + 1e-6)  (x max(radius, 1) with
//   scale_by_dis), a sample (t, e |J d|, node) unless it is the ray's
//   first evaluation, then t += e if t + e <= the hit's far, else ADVANCE.
// ADVANCE: the next hit; t jumps by the whole number of steps that
// reaches its near (at least one) if that fits inside it, else the hit
// after; the ray is done past its last hit or at max_s samples.
// Every operation rounds as the plain version's (ray_march_plain,
// sampler/device.py) does: __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn/
// __fsqrt_rn, in its order. nvcc would contract o + d*t and t + e into
// FMAs, and one ulp of t flips the t + e <= far test, which changes which
// samples a ray emits.
//
// Bound: bytes. Each input read once (the hit lists, n_hits, rays, noise,
// the trans_idx, warp and t_center/t_dis rows the rays touch) and the
// dense outputs [R, max_s] x 3 and [R] written once; the wrapper fills
// the outputs (0 and -1) and the kernel writes only the emitted slots.
// The work is a chain of dependent iterations per ray, with R only
// 512-4096 threads: its time is the longest ray's chain, not bandwidth.
//
// Each entry point returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kPros = 12;

// |J(x) d| + 1e-6 (warp_jac_dir, sampler/device.py; QueryFrameTransformJac,
// PersSampler.cu:170-187): m the leaf's [12][2][4] w2xz row, w its [3][12]
// weight row.
__device__ __forceinline__ float jac_dir(const float* __restrict__ m,
                                         const float* __restrict__ w,
                                         const float x[3], const float d[3]) {
  float jd[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < kPros; ++k) {
    const float* r0 = m + 8 * k;
    const float* r1 = r0 + 4;
    const float a = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(r0[0], x[0]),
                                                  __fmul_rn(r0[1], x[1])),
                                        __fmul_rn(r0[2], x[2])), r0[3]);
    const float b = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(r1[0], x[0]),
                                                  __fmul_rn(r1[1], x[1])),
                                        __fmul_rn(r1[2], x[2])), r1[3]);
    const float r0d = __fadd_rn(__fadd_rn(__fmul_rn(r0[0], d[0]),
                                          __fmul_rn(r0[1], d[1])),
                                __fmul_rn(r0[2], d[2]));
    const float r1d = __fadd_rn(__fadd_rn(__fmul_rn(r1[0], d[0]),
                                          __fmul_rn(r1[1], d[1])),
                                __fmul_rn(r1[2], d[2]));
    const float dvd = __fsub_rn(__fdiv_rn(r0d, b),
                                __fmul_rn(__fdiv_rn(a, __fmul_rn(b, b)), r1d));
#pragma unroll
    for (int ax = 0; ax < 3; ++ax)
      jd[ax] = __fadd_rn(jd[ax], __fmul_rn(w[12 * ax + k], dvd));
  }
  const float s = __fadd_rn(__fadd_rn(__fmul_rn(jd[0], jd[0]),
                                      __fmul_rn(jd[1], jd[1])),
                            __fmul_rn(jd[2], jd[2]));
  return __fadd_rn(__fsqrt_rn(s), 1e-6f);
}

struct Tree {
  const int* trans_idx;   // [N]
  const float* w2xz;      // [M, 96]
  const float* weight;    // [M, 36]
  const float* t_center;  // [M, 3]
  const float* t_dis;     // [M]
};

struct Out {
  float* t;     // [R, max_s]
  float* dt;    // [R, max_s]
  int* node;    // [R, max_s]
  int* n;       // [R]
};

__global__ void __launch_bounds__(kThreads)
ray_march_kernel(const int* __restrict__ hit_idx,
                 const float* __restrict__ hit_near,
                 const float* __restrict__ hit_far,
                 const int* __restrict__ n_hits,
                 const float* __restrict__ rays_o,
                 const float* __restrict__ rays_d,
                 const float* __restrict__ noise, Tree tree, Out out, int R,
                 int H, int max_s, int max_iters, float sample_l,
                 int scale_by_dis) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const long long hrow = (long long)r * H;
  const long long orow = (long long)r * max_s;
  const int nh = n_hits[r];
  const float o[3] = {rays_o[3 * r], rays_o[3 * r + 1], rays_o[3 * r + 2]};
  const float d[3] = {rays_d[3 * r], rays_d[3 * r + 1], rays_d[3 * r + 2]};
  int n = 0, ptr = 0;
  float t = hit_near[hrow];
  float exp_step = 1.0f;
  bool first = true, adv = false, done = nh <= 0;
  for (int it = 0; it < max_iters && !done; ++it) {
    if (!adv) {
      // ---- EMIT
      const int pc = min(ptr, H - 1);
      const int node = hit_idx[hrow + pc];
      const float cur_far = hit_far[hrow + pc];
      const int tr = max(tree.trans_idx[max(node, 0)], 0);
      float x[3];
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) x[ax] = __fadd_rn(o[ax], __fmul_rn(d[ax], t));
      const float pnorm = jac_dir(tree.w2xz + 96LL * tr, tree.weight + 36LL * tr,
                                  x, d);
      float e = __fdiv_rn(__fmul_rn(sample_l, noise[r + n]), pnorm);
      if (scale_by_dis) {
        float v[3];
#pragma unroll
        for (int ax = 0; ax < 3; ++ax)
          v[ax] = __fsub_rn(o[ax], tree.t_center[3LL * tr + ax]);
        const float nrm = __fsqrt_rn(__fadd_rn(
            __fadd_rn(__fmul_rn(v[0], v[0]), __fmul_rn(v[1], v[1])),
            __fmul_rn(v[2], v[2])));
        const float radius = __fdiv_rn(nrm, tree.t_dis[tr]);
        e = __fmul_rn(e, radius < 1.0f ? 1.0f : radius);  // NaN stays NaN
      }
      if (!first && n < max_s) {
        out.t[orow + n] = t;
        out.dt[orow + n] = __fmul_rn(e, pnorm);
        out.node[orow + n] = node;
        ++n;
      }
      const float t_next = __fadd_rn(t, e);
      const bool fits = t_next <= cur_far;
      first = false;
      exp_step = e;
      done = n >= max_s;
      if (fits) t = t_next;
      adv = !fits;
    } else {
      // ---- ADVANCE
      const int pa = ptr + 1;
      const int pac = min(pa, H - 1);
      const float a_near = hit_near[hrow + pac];
      const float a_far = hit_far[hrow + pac];
      float q = __fdiv_rn(__fsub_rn(a_near, t), exp_step);
      q = q < 1.0f ? 1.0f : q;                               // NaN stays NaN
      const float adv_step = __fmul_rn(exp_step, ceilf(q));
      const bool exhausted = pa >= nh;
      const float t_next = __fadd_rn(t, adv_step);
      const bool fits = t_next <= a_far;
      ptr = pa;
      done = exhausted;
      if (!exhausted && fits) t = t_next;
      adv = !exhausted && !fits;
    }
  }
  out.n[r] = n;
}

}  // namespace

// Outputs are filled by the caller (out_t, out_dt 0; out_node -1); the
// kernel writes the emitted slots and n_out.
extern "C" int f2_ray_march_lockstep(
    const void* hit_idx, const void* hit_near, const void* hit_far,
    const void* n_hits, const void* rays_o, const void* rays_d,
    const void* noise, const void* trans_idx, const void* w2xz,
    const void* weight, const void* t_center, const void* t_dis, void* out_t,
    void* out_dt, void* out_node, void* n_out, int R, int H, int max_s,
    int max_iters, float sample_l, int scale_by_dis, void* stream) {
  if (R <= 0) return 0;
  const Tree tree{(const int*)trans_idx, (const float*)w2xz,
                  (const float*)weight, (const float*)t_center,
                  (const float*)t_dis};
  const Out out{(float*)out_t, (float*)out_dt, (int*)out_node, (int*)n_out};
  ray_march_kernel<<<(R + kThreads - 1) / kThreads, kThreads, 0,
                     (cudaStream_t)stream>>>(
      (const int*)hit_idx, (const float*)hit_near, (const float*)hit_far,
      (const int*)n_hits, (const float*)rays_o, (const float*)rays_d,
      (const float*)noise, tree, out, R, H, max_s, max_iters, sample_l,
      scale_by_dis);
  return (int)cudaGetLastError();
}
