// K7: the lockstep ray marcher, a warp per ray.
//
// Replaces the jax.lax.while_loop of f2nerf_tpu/sampler/device.py:436-544
// (ray_march), the reference-exact EMIT/ADVANCE state machine of
// RayMarchKernel (PersSampler.cu:189-314). There every iteration runs ~40
// whole-batch ops for every ray, up to max_s + H + 8 times. Here a group of
// kLanes lanes runs one ray's body until the ray is done or the iteration
// bound is reached. A ray's body never reads another ray's state, so this
// is the lockstep loop's result exactly.
//
// EMIT (not advancing): |J(x) d| + 1e-6 at x = o + d t in the current
// hit's leaf (the leaf's 96 w2xz and 36 weight floats), the step
//   e = sample_l * noise[r + n] / (|J d| + 1e-6)  (x max(radius, 1) with
//   scale_by_dis), a sample (t, e |J d|, node) unless it is the ray's
//   first evaluation, then t += e if t + e <= the hit's far, else ADVANCE.
// ADVANCE: the next hit; t jumps by the whole number of steps that
// reaches its near (at least one) if that fits inside it, else the hit
// after; the ray is done past its last hit or at max_s samples.
//
// Layout: a warp a ray (kLanes 32), blocks of kWarps 2 warps, R warps in
// the grid. The ray's state (t, hit pointer, sample count, step, flags)
// is the same in every lane: each lane computes it with the same rounded
// operations, so every branch is uniform over the warp. Lanes differ only
// in what they hold:
//   - the hit list, in chunks of 32: lane j holds entry hb + j of
//     hit_idx, hit_near and hit_far (one coalesced load each), the
//     entry's leaf row max(trans_idx[max(node, 0)], 0) and, with
//     scale_by_dis, its max(|o - t_center| / t_dis, 1); entry
//     min(ptr, H - 1) is taken by shuffle, and the chunk is reloaded when
//     the pointer leaves it (any H);
//   - noise[r + nb + j], reloaded (issued early) when n leaves the chunk;
//   - the leaf, loaded when the hit pointer changes, not at every EMIT
//     (the plain version reads the same rows again at every EMIT of one
//     hit, so caching them is exact): lane j holds projection k = j mod
//     12, its 8 w2xz floats and its 3 weight entries, and its r0.d and
//     r1.d, which do not depend on x;
//   - the samples: slot n goes to lane n mod 32, and each time 32 slots
//     are filled the warp writes them with one coalesced store per
//     output; the partial chunk is written at the end with n_out[r].
// The Jacobian: lane k < 12 computes its projection's dvd_k and the three
// products w[ax][k] * dvd_k (lanes 12 and up repeat projections 0-11 on
// the same rows, so no lane takes another branch) and writes them to the
// ray's 36 floats of shared memory; lane ax < 3 reads axis ax's 12 (three
// 16-byte loads) and adds them in order k = 0..11 from 0.0f, exactly as
// warp_jac_dir does, and the three sums are shuffled to every lane. A
// tree reduction would round otherwise, and one ulp of t flips the
// t + e <= far test.
// Every operation rounds as the plain version's (ray_march_plain,
// sampler/device.py) does: __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn/
// __fsqrt_rn, in its order. nvcc would contract o + d*t and t + e into
// FMAs, which changes which samples a ray emits.
//
// Bound: the chain. The bytes (each input read once: hit lists, rays,
// noise, the touched trans_idx and warp rows; the dense outputs written
// once) and the f32 operations take < 0.01 ms; the longest ray's chain of
// dependent iterations takes more: each EMIT is 32 dependent f32
// operations (chip_smoke.py MARCH_CHAIN_EMIT), each ADVANCE 7, at >= 4
// cycles each, and one ray's iterations cannot overlap. The design
// shortens each iteration (no global load on it once a hit's leaf is in
// registers; 12 projections side by side instead of one after another)
// and spreads the rays over every SM (one thread a ray in blocks of 64
// put the step's 1,536 rays on 24 of the 132 SMs).
// Measured (chip_smoke.py --phases device,build,march on copies with
// these constants edited, one run each; NVIDIA H100 80GB HBM3, 700 W; ms
// at the reference-semantics step's 1,536 rays / uniform 1,536 / uniform
// 4,096). In one call:
//   sums in shared memory, 2 warps a block (kept): 0.0682 / 0.0586 / 0.0774;
//   the same, 4 warps: 0.0682 / 0.0593 / 0.0819 and 0.0680 / 0.0588 / 0.0816;
//   the same, 16 lanes (two rays a warp, which diverge), 4 warps:
//       0.0834 / 0.0740 / 0.0801;
//   the 36 products gathered by shuffle in every lane and summed there,
//       4 warps: 0.0725 / 0.0620 / 0.0893;
//   one thread a ray (the earlier design): 0.5029 / 0.3544 / 0.3580.
// In an earlier call, all with the shuffled sums: 4 warps 0.0740 / 0.0636
// / 0.0881; with the next hit's rows prefetched as a leaf is installed (80
// registers) 0.0731 / 0.0621 / 0.0916; the same with 2 warps 0.0729 /
// 0.0615 / 0.0888, 8 warps 0.0781 / 0.0660 / 0.0958 (192 blocks on 132
// SMs, unevenly), 16 lanes 0.1049 / 0.0934 / 0.0993.
// Registers: 67 a thread, no spills, 288 bytes of shared memory a block:
// 28 warps an SM, so an eval chunk's 4,096 rays (31 warps an SM) take a
// little more than one wave. The longest ray takes ~1,200 cycles an
// iteration against the chain's 128 an EMIT. The likely reason (not
// measured): with ~12 warps an SM the four schedulers' issue slots are
// shared, and an EMIT issues well over a hundred instructions (three IEEE
// divisions and a square root as multi-instruction sequences, the ordered
// sums, the ray's state); 4,096 rays take 1.3x the time of 1,536.

// Each entry point returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;    // lanes a ray (16: two rays a warp)
constexpr int kWarps = 2;     // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kPros = 12;

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

// One projection's rows of a leaf: m its [2][4] w2xz, w its weight column.
struct Rows {
  float m[8];
  float w[3];
};

__device__ __forceinline__ Rows load_rows(const Tree& tree, int tr, int k) {
  Rows p;
  const float* m = tree.w2xz + 96LL * tr + 8 * k;
#pragma unroll
  for (int i = 0; i < 8; ++i) p.m[i] = m[i];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) p.w[ax] = tree.weight[36LL * tr + 12 * ax + k];
  return p;
}

// r.d for the row r = m[0..2] (warp_jac_dir's r0d / r1d)
__device__ __forceinline__ float row_dot(const float* m, const float d[3]) {
  return __fadd_rn(__fadd_rn(__fmul_rn(m[0], d[0]), __fmul_rn(m[1], d[1])),
                   __fmul_rn(m[2], d[2]));
}

// a row's projective coordinate at x (warp_jac_dir's a / b)
__device__ __forceinline__ float row_at(const float* m, const float x[3]) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(m[0], x[0]),
                                       __fmul_rn(m[1], x[1])),
                             __fmul_rn(m[2], x[2])), m[3]);
}

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
  const int r = (blockIdx.x * kThreads + threadIdx.x) / kLanes;
  if (r >= R) return;                        // the whole group leaves
  const int lane = threadIdx.x & (kLanes - 1);
  const unsigned mask = (0xffffffffu >> (32 - kLanes))
                        << (threadIdx.x & 31 & ~(kLanes - 1));
  const int k = lane % kPros;                // this lane's projection
  // the ray's 36 Jacobian products, [axis][projection]
  __shared__ __align__(16) float prod_all[kThreads / kLanes][3 * kPros];
  float* prod = prod_all[threadIdx.x / kLanes];
  const long long hrow = (long long)r * H;
  const long long orow = (long long)r * max_s;
  const long long noise_len = (long long)R + max_s + 1;  // the wrapper's least
  const int nh = n_hits[r];
  const int nh_c = min(nh, H);               // entries an EMIT can read
  const float o[3] = {rays_o[3 * r], rays_o[3 * r + 1], rays_o[3 * r + 2]};
  const float d[3] = {rays_d[3 * r], rays_d[3 * r + 1], rays_d[3 * r + 2]};

  // ---- the hit chunk [hb, hb + kLanes): each entry with its leaf's warp
  // row and scale_by_dis factor
  int hb = 0, h_node = -1, h_tr = 0;
  float h_near = 0.0f, h_far = 0.0f, h_rad = 1.0f;
  auto load_hits = [&](int base) {
    hb = base;
    const int j = base + lane;
    if (j < H) {
      h_node = hit_idx[hrow + j];
      h_near = hit_near[hrow + j];
      h_far = hit_far[hrow + j];
    }
    if (j < nh_c) {
      h_tr = max(tree.trans_idx[max(h_node, 0)], 0);
      if (scale_by_dis) {
        float v[3];
#pragma unroll
        for (int ax = 0; ax < 3; ++ax)
          v[ax] = __fsub_rn(o[ax], tree.t_center[3LL * h_tr + ax]);
        const float nrm = __fsqrt_rn(__fadd_rn(
            __fadd_rn(__fmul_rn(v[0], v[0]), __fmul_rn(v[1], v[1])),
            __fmul_rn(v[2], v[2])));
        const float radius = __fdiv_rn(nrm, tree.t_dis[h_tr]);
        h_rad = radius < 1.0f ? 1.0f : radius;             // NaN stays NaN
      }
    }
  };
  // ---- the noise chunk noise[r + nb .. r + nb + kLanes)
  int nb = 0;
  float nz = 0.0f;
  auto load_noise = [&](int base) {
    nb = base;
    const long long j = (long long)r + base + lane;
    if (j < noise_len) nz = noise[j];
  };
  load_hits(0);
  load_noise(0);

  // ---- the current hit's leaf (hit pointer leaf_ptr)
  int leaf_ptr = -1, node = 0;
  float cur_far = 0.0f, rad = 1.0f, r0d = 0.0f, r1d = 0.0f;
  Rows leaf = {};

  // ---- the samples of slots [n - n mod kLanes, n), one a lane
  float s_t = 0.0f, s_dt = 0.0f;
  int s_node = -1;

  int n = 0, ptr = 0;
  float t = __shfl_sync(mask, h_near, 0, kLanes);
  float exp_step = 1.0f;
  bool first = true, adv = false, done = nh <= 0;
  for (int it = 0; it < max_iters && !done; ++it) {
    if (!adv) {
      // ---- EMIT
      if (ptr != leaf_ptr) {
        const int pc = min(ptr, H - 1);
        if (pc >= hb + kLanes) load_hits(pc & ~(kLanes - 1));
        node = __shfl_sync(mask, h_node, pc - hb, kLanes);
        cur_far = __shfl_sync(mask, h_far, pc - hb, kLanes);
        const int tr = __shfl_sync(mask, h_tr, pc - hb, kLanes);
        rad = __shfl_sync(mask, h_rad, pc - hb, kLanes);
        leaf = load_rows(tree, tr, k);
        r0d = row_dot(leaf.m, d);
        r1d = row_dot(leaf.m + 4, d);
        leaf_ptr = ptr;
      }
      float x[3];
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) x[ax] = __fadd_rn(o[ax], __fmul_rn(d[ax], t));
      const float a = row_at(leaf.m, x);
      const float b = row_at(leaf.m + 4, x);
      const float dvd = __fsub_rn(__fdiv_rn(r0d, b),
                                  __fmul_rn(__fdiv_rn(a, __fmul_rn(b, b)), r1d));
      if (lane < kPros) {
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) prod[kPros * ax + lane] = __fmul_rn(leaf.w[ax], dvd);
      }
      __syncwarp(mask);
      // lane ax sums axis ax (the other lanes repeat lanes 0-2)
      const float4* row = reinterpret_cast<const float4*>(prod + kPros * (lane % 3));
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < kPros / 4; ++i) {
        const float4 v = row[i];
        acc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc, v.x), v.y), v.z), v.w);
      }
      __syncwarp(mask);                  // the next EMIT writes prod again
      float jd[3];
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) jd[ax] = __shfl_sync(mask, acc, ax, kLanes);
      const float s = __fadd_rn(__fadd_rn(__fmul_rn(jd[0], jd[0]),
                                          __fmul_rn(jd[1], jd[1])),
                                __fmul_rn(jd[2], jd[2]));
      const float pnorm = __fadd_rn(__fsqrt_rn(s), 1e-6f);
      const float nz_n = __shfl_sync(mask, nz, n - nb, kLanes);
      float e = __fdiv_rn(__fmul_rn(sample_l, nz_n), pnorm);
      if (scale_by_dis) e = __fmul_rn(e, rad);
      if (!first && n < max_s) {
        if (lane == (n & (kLanes - 1))) {
          s_t = t;
          s_dt = __fmul_rn(e, pnorm);
          s_node = node;
        }
        ++n;
        if ((n & (kLanes - 1)) == 0) {
          const long long o_at = orow + n - kLanes + lane;
          out.t[o_at] = s_t;
          out.dt[o_at] = s_dt;
          out.node[o_at] = s_node;
          load_noise(n);             // issued now, read at the next EMIT
        }
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
      if (pac >= hb + kLanes) load_hits(pac & ~(kLanes - 1));
      const float a_near = __shfl_sync(mask, h_near, pac - hb, kLanes);
      const float a_far = __shfl_sync(mask, h_far, pac - hb, kLanes);
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
  const int rem = n & (kLanes - 1);
  if (lane < rem) {
    const long long o_at = orow + n - rem + lane;
    out.t[o_at] = s_t;
    out.dt[o_at] = s_dt;
    out.node[o_at] = s_node;
  }
  if (lane == 0) out.n[r] = n;
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
  const long long threads = (long long)R * kLanes;
  ray_march_kernel<<<(unsigned)((threads + kThreads - 1) / kThreads), kThreads,
                     0, (cudaStream_t)stream>>>(
      (const int*)hit_idx, (const float*)hit_near, (const float*)hit_far,
      (const int*)n_hits, (const float*)rays_o, (const float*)rays_d,
      (const float*)noise, tree, out, R, H, max_s, max_iters, sample_l,
      scale_by_dis);
  return (int)cudaGetLastError();
}
