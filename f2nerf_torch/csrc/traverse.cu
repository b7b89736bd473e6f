// K8: the rope traversal, one thread a ray.
//
// Replaces the jax.lax.while_loop of f2nerf_tpu/sampler/device.py:231-432
// (traverse), the redesigned FindRayOctreeIntersectionKernel
// (PersSampler.cu:53-152): for each ray, the leaves it crosses in order,
// as hit rows (node, near, far), their count and a truncation flag. There
// every iteration runs ~60 whole-batch ops for every ray, and the torch
// loop of the plain version (traverse_plain, sampler/device.py) syncs the
// host once an iteration to test whether every ray is done. Here a thread
// runs one ray's body, with the ray's state in registers (t, node u, hit
// count, eps, the last emitted node, done, trunc), until the ray is done
// or reaches max_iters.
//
// Why this is the lockstep loop's result exactly: a ray's body reads no
// other ray's state, and a done ray's state never changes there (its t, u
// and eps are kept, emitting needs ~done, trunc only ORs ~done terms). So
// each ray's outputs are those of running it alone. The loop's iteration
// count is the largest per-ray count (a ray done at entry counts 0), at
// most max_iters: an atomicMax over the rays into one device int32, which
// the host never has to read.
//
// An iteration at node u, with p = o + d (t + eps):
//   - outside u (not the root): restart at the root;
//   - a leaf: emit (u, near, far) if it is valid, ahead of t, not the last
//     node emitted and the hit list has room; then leave by the exit face
//     (the first axis of least exit distance) through its rope; eps is
//     floored at the leaf's side * 1e-4, the root's * 1e-6 and t's f32 ulp
//     scale (|t| * 5e-7), and grows 4x on a visit with no progress;
//   - internal: descend into the child octant that holds p, or, if that
//     child is missing or p lies outside it, skip to the child's entry
//     (if it is ahead inside the octant) or the octant's exit, with the
//     skip-stall escalation of eps;
//   - done at a border rope (-1), at t + eps >= the ray's end, or with the
//     hit list full (trunc unless it also reached the end).
// Every operation rounds as the plain version's torch ops do, in its
// order: __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn (nvcc would contract
// o + d (t + eps) into an FMA, and emission is discontinuous in the last
// bit); minimum/maximum propagate NaN as torch's do; the exit axis is the
// first of equal distances, as torch.argmin's. Constants are the f32
// values torch multiplies by ((float)1e-6 etc.).
//
// Outputs: the kernel writes every slot of the hit rows (slots at n_hits
// and above as -1 / 0 / 0, as the plain version leaves them), n_hits,
// trunc (with ~done at exit), each ray's iteration count and the loop's
// count; the caller allocates them uninitialised.
//
// Bound: the chain. One ray's iterations depend on one another (t, u), so
// the kernel takes at least the longest ray's iterations times the
// dependent f32 operations on one iteration's critical path
// (chip_smoke.py TRAV_CHAIN), at >= 4 cycles each; the loads on that
// path (the node's center, side, child, the child's center) are not
// counted, so this stays a lower bound. The bytes (rays in, hit rows out,
// the touched tree rows once) take microseconds. A simple design first:
// one thread a ray, in blocks of 128, so the bench's 2,048-ray bucket
// fills 16 blocks on 16 of the 132 SMs; a warp a ray or the tree's top
// levels in shared memory are later work.
// Measured (chip_smoke.py; NVIDIA H100 80GB HBM3, 700 W): 0.087 ms at the
// slice step's 2,048 rays (58 iterations on the 945-node tree), 0.7% of
// the chain bound, ~1,500 ns an iteration of the longest ray; 0.57 ms at
// 768 rays on the 223,817-node tree (288 iterations). 53 registers and
// 40 bytes of stack (ptxas).

// Each entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

struct Tree {
  const float* center;           // [N, 3]
  const float* side;             // [N]
  const int* child;              // [N, 8]
  const unsigned char* is_leaf;  // [N] bool
  const int* trans_idx;          // [N]
  const int* rope;               // [N, 6]
};

struct Hits {
  int* idx;               // [R, H]
  float* near;            // [R, H]
  float* far;             // [R, H]
  int* n;                 // [R]
  unsigned char* trunc;   // [R] bool
  int* iters;             // [R]
  int* n_iters;           // [] the loop's count (zeroed by the entry point)
};

// torch.minimum / torch.maximum: NaN propagates, else fminf/fmaxf
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
// amax / amin's combine: NaN propagates, else the larger / smaller
__device__ __forceinline__ float rmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ float rmin(float a, float b) {
  return (a != a || a < b) ? a : b;
}

struct Ray {
  float o[3], d[3], safe_d[3];
  bool deg[3];  // |d| < 1e-6
};

// _slab: ray-AABB (near, far) with the |d| < 1e-6 inside/outside
// convention, big = 1e6
__device__ __forceinline__ void slab(const float c[3], float side, const Ray& ray,
                                     float& tn, float& tf) {
  const float hf = __fmul_rn(side, 0.5f);
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float lo = __fsub_rn(c[ax], hf);
    const float hi = __fadd_rn(c[ax], hf);
    const float t0 = __fdiv_rn(__fsub_rn(lo, ray.o[ax]), ray.safe_d[ax]);
    const float t1 = __fdiv_rn(__fsub_rn(hi, ray.o[ax]), ray.safe_d[ax]);
    float n = tmin(t0, t1), f = tmax(t0, t1);
    if (ray.deg[ax]) {
      const bool inside = ray.o[ax] > lo && ray.o[ax] < hi;
      n = inside ? -1e6f : 1e6f;
      f = inside ? 1e6f : -1e6f;
    }
    tn = ax == 0 ? n : rmax(tn, n);
    tf = ax == 0 ? f : rmin(tf, f);
  }
}

__device__ __forceinline__ void load3(const float* p, int i, float v[3]) {
  v[0] = p[3 * i];
  v[1] = p[3 * i + 1];
  v[2] = p[3 * i + 2];
}

// max over the axes of |p - c| (non-negative, so the order does not matter)
__device__ __forceinline__ float max_abs_diff(const float p[3], const float c[3]) {
  return fmaxf(fmaxf(fabsf(__fsub_rn(p[0], c[0])), fabsf(__fsub_rn(p[1], c[1]))),
               fabsf(__fsub_rn(p[2], c[2])));
}

__global__ void __launch_bounds__(kThreads)
traverse_kernel(Tree tree, const float* __restrict__ rays_o,
                const float* __restrict__ rays_d, const float* __restrict__ near_in,
                const float* __restrict__ far_in, Hits out, int R, int H,
                int max_iters) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  int iters = 0;
  if (r < R) {
    Ray ray;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      ray.o[ax] = rays_o[3 * r + ax];
      ray.d[ax] = rays_d[3 * r + ax];
      ray.deg[ax] = fabsf(ray.d[ax]) < (float)1e-6;
      ray.safe_d[ax] = ray.deg[ax] ? 1.0f : ray.d[ax];
    }
    float sgn[3];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax)
      sgn[ax] = (float)((0.0f < ray.safe_d[ax]) - (ray.safe_d[ax] < 0.0f));
    const float nr = near_in[r], fr = far_in[r];
    const long long hrow = (long long)r * H;

    float c0[3];
    load3(tree.center, 0, c0);
    const float root_side = tree.side[0];
    const float eps0 = __fmul_rn(root_side, (float)1e-6);
    float rn, rf;
    slab(c0, root_side, ray, rn, rf);
    float t = tmax(rn, nr);
    const float t_end = tmin(rf, fr);
    bool done = t >= t_end;
    // the ulp floor applies to the initial eps too
    float eps = tmax(eps0, __fmul_rn(fabsf(t), (float)5e-7));
    int u = 0, cnt = 0, last = -1;
    bool trunc = false;

    while (iters < max_iters && !done) {
      ++iters;
      const float te = __fadd_rn(t, eps);
      float p[3];
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) p[ax] = __fadd_rn(ray.o[ax], __fmul_rn(ray.d[ax], te));
      float cu[3];
      load3(tree.center, u, cu);
      const float su = tree.side[u];
      const bool leaf = tree.is_leaf[u] != 0;
      const bool outside = u != 0 && max_abs_diff(p, cu) > __fmul_rn(su, 0.5f);

      // the child octant that holds p, and whether p lies inside the child
      int ge[3];
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) ge[ax] = p[ax] >= cu[ax];
      const int c = tree.child[8 * u + ((ge[0] << 2) | (ge[1] << 1) | ge[2])];
      const int cs = c < 0 ? 0 : c;
      float cc[3];
      load3(tree.center, cs, cc);
      const float c_side = tree.side[cs];
      const bool inside_c = c >= 0 && max_abs_diff(p, cc) <= __fmul_rn(c_side, 0.5f);

      float new_t = t, new_eps = eps;
      int new_u = u;
      bool emit = false, rope_end = false;
      if (outside) {
        new_u = 0;
      } else if (leaf) {
        // ---- emit (if valid) and follow the exit-face rope
        float n_l, f_l;
        slab(cu, su, ray, n_l, f_l);
        n_l = tmax(n_l, nr);
        f_l = tmin(f_l, fr);
        const bool progress = f_l > t;
        emit = tree.trans_idx[u] >= 0 && n_l < f_l && progress && cnt < H && u != last;
        if (emit) {
          out.idx[hrow + cnt] = u;
          out.near[hrow + cnt] = n_l;
          out.far[hrow + cnt] = f_l;
        }
        int face_ax = 0;
        float best = 0.0f;
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) {
          float v = __fdiv_rn(
              __fsub_rn(__fadd_rn(cu[ax], __fmul_rn(__fmul_rn(sgn[ax], su), 0.5f)), ray.o[ax]),
              ray.safe_d[ax]);
          if (ray.deg[ax]) v = 1e9f;
          // torch.argmin: the first least value, NaN counted least
          if (ax == 0 || (best == best && (v != v || v < best))) {
            best = v;
            face_ax = ax;
          }
        }
        const int face = face_ax * 2 + (ray.d[face_ax] > 0.0f);
        const int rope_u = tree.rope[6 * u + face];
        const float leaf_t = tmax(f_l, t);
        float leaf_eps = tmax(tmax(__fmul_rn(su, (float)1e-4), eps0),
                              __fmul_rn(fabsf(leaf_t), (float)5e-7));
        if (!progress) leaf_eps = tmax(leaf_eps, __fmul_rn(eps, 4.0f));
        new_t = leaf_t;
        new_u = rope_u < 0 ? 0 : rope_u;
        if (!inside_c) new_eps = leaf_eps;
        rope_end = rope_u < 0;
      } else if (inside_c) {
        new_u = c;
      } else {
        // ---- internal, p outside the child: skip the empty region
        float oc[3];
#pragma unroll
        for (int ax = 0; ax < 3; ++ax)
          oc[ax] = __fadd_rn(cu[ax], __fmul_rn(__fmul_rn((float)ge[ax] - 0.5f, su), 0.5f));
        const float oct_side = __fmul_rn(su, 0.5f);
        float n_o, f_o, n_c, f_c;
        slab(oc, oct_side, ray, n_o, f_o);
        slab(cc, c_side, ray, n_c, f_c);
        const bool ahead = c >= 0 && n_c > t && n_c < f_o && n_c < f_c;
        const float skip_t = tmax(ahead ? n_c : f_o, t);
        new_t = skip_t;
        new_eps = tmax(tmax(__fmul_rn(ahead ? c_side : oct_side, (float)1e-4), eps0),
                       __fmul_rn(fabsf(skip_t), (float)5e-7));
        if (new_t <= t) new_eps = tmax(new_eps, __fmul_rn(eps, 4.0f));  // the skip stall
      }
      cnt += emit;
      const bool reached_end = !inside_c && !outside && __fadd_rn(new_t, new_eps) >= t_end;
      const bool cap_hit = cnt >= H;
      done = rope_end || reached_end || cap_hit;
      trunc = trunc || (cap_hit && !reached_end && !rope_end);
      if (emit) last = u;
      t = new_t;
      u = new_u;
      eps = new_eps;
    }
    for (int k = cnt; k < H; ++k) {
      out.idx[hrow + k] = -1;
      out.near[hrow + k] = 0.0f;
      out.far[hrow + k] = 0.0f;
    }
    out.n[r] = cnt;
    out.trunc[r] = trunc || !done;  // ~done at exit == max_iters reached
    out.iters[r] = iters;
  }
  // the loop's count: the largest per-ray count, a warp's max then one atomic
  const int m = __reduce_max_sync(0xffffffffu, iters);
  if ((threadIdx.x & 31) == 0 && m > 0) atomicMax(out.n_iters, m);
}

}  // namespace

// All outputs are written by the kernel (n_iters zeroed here first).
extern "C" int f2_traverse(const void* center, const void* side, const void* child,
                           const void* is_leaf, const void* trans_idx, const void* rope,
                           const void* rays_o, const void* rays_d, const void* near,
                           const void* far, void* hit_idx, void* hit_near, void* hit_far,
                           void* n_hits, void* trunc, void* iters, void* n_iters, int R,
                           int H, int max_iters, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(n_iters, 0, sizeof(int), s);
  if (e != cudaSuccess || R <= 0) return (int)e;
  const Tree tree{(const float*)center, (const float*)side, (const int*)child,
                  (const unsigned char*)is_leaf, (const int*)trans_idx, (const int*)rope};
  const Hits out{(int*)hit_idx, (float*)hit_near, (float*)hit_far, (int*)n_hits,
                 (unsigned char*)trunc, (int*)iters, (int*)n_iters};
  traverse_kernel<<<(R + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      tree, (const float*)rays_o, (const float*)rays_d, (const float*)near,
      (const float*)far, out, R, H, max_iters);
  return (int)cudaGetLastError();
}
