// K8: the rope traversal, one thread a ray, over a packed node record
// staged in shared memory.
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
// The design, against a first one that read six SoA arrays in three
// dependent rounds of global loads an iteration (~1,500 ns an iteration):
//   - the node record (DeviceTree.node_rec, built once a tree by
//     to_device_tree): center, side, the 8 children, the 6 ropes and
//     is_leaf in five 16-byte vectors (80 B), so one round of vector loads
//     fetches a node, and a second one the child's center and side;
//     trans_idx, which occupancy culling rewrites every step, is read from
//     the tree's own array, never copied into the record;
//   - a tree of at most n_smem nodes is staged into shared memory by every
//     block at entry (the records and trans_idx, 84 B a node; the 945-node
//     slice tree takes 79 KB), so both rounds are shared-memory loads; a
//     larger tree is read from global memory (L2-resident: the
//     223,817-node tree's records are 18 MB) with the same vector loads;
//   - one slab an iteration for the leaf and the skip branches alike (of
//     the node's box for a leaf, of the child's for a skip), so a warp
//     whose rays are in both branches runs it once; the leaf's exit
//     distances are that slab's far planes (cu + sgn * su * 0.5 is the
//     slab's hi when sgn = +1 and its lo when sgn = -1, bit for bit), and
//     the octant's far needs only its far planes (max(t0, t1) is the plane
//     on the ray's side: no NaN arises from finite inputs): 6 divisions a
//     leaf iteration instead of 9, 9 a skip instead of 12;
//   - children and ropes are selected from registers, never indexed
//     dynamically (no local memory);
//   - the empty slots of the hit rows are written by the warp's lanes along
//     one row at a time, so a store covers consecutive slots.
//
// Outputs: the kernel writes every slot of the hit rows (slots at n_hits
// and above as -1 / 0 / 0, as the plain version leaves them), n_hits,
// trunc (with ~done at exit), each ray's iteration count and the loop's
// count; the caller allocates them uninitialised.
//
// Bound: the chain. One ray's iterations depend on one another (t, u), so
// the kernel takes at least the longest ray's iterations times the
// dependent f32 operations on one iteration's critical path
// (chip_smoke.py TRAV_CHAIN), at >= 4 cycles each; the loads on that path
// are not counted, so this stays a lower bound. The bytes (rays in, hit
// rows out, the touched tree rows once) take microseconds.
// Measured (chip_smoke.py --baseline, scripts/sweep_kernels.py; NVIDIA
// H100 80GB HBM3, 700 W): ~0.06 ms at the slice step's 2,048 rays (58
// iterations on the 945-node tree) against ~0.09 for the SoA design in the
// same call; ~0.33 ms against ~0.53 at 768 rays on the 223,817-node tree.
// What is left is one iteration's instructions run by a lone warp (2,048
// rays fill 64 warps for 528 schedulers): with every ray on one path an
// iteration still takes ~600 ns, the IEEE divisions ~15% of it, while
// reading the tree from global memory instead (its records then sit in
// L1) costs about as much as the staged copy.

// Each entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kRecVecs = 5;               // int4 vectors a node record
constexpr int kStage = 16;                // vector loads in flight a thread when staging
constexpr int kSmemNodeBytes = kRecVecs * 16 + 4;   // a record and its trans_idx
constexpr int kSmemMaxBytes = 232448;     // dynamic shared memory a block, sm_90

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

// A box's planes along the ray, as _slab computes them: t0 at its low
// face, t1 at its high face, and whether the origin lies strictly between
// them (the degenerate axes' convention).
__device__ __forceinline__ void planes(const float c[3], float side, const Ray& ray,
                                       float t0[3], float t1[3], bool inside[3]) {
  const float hf = __fmul_rn(side, 0.5f);
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float lo = __fsub_rn(c[ax], hf);
    const float hi = __fadd_rn(c[ax], hf);
    t0[ax] = __fdiv_rn(__fsub_rn(lo, ray.o[ax]), ray.safe_d[ax]);
    t1[ax] = __fdiv_rn(__fsub_rn(hi, ray.o[ax]), ray.safe_d[ax]);
    inside[ax] = ray.o[ax] > lo && ray.o[ax] < hi;
  }
}

// _slab's (near, far) from the planes, with the |d| < 1e-6 inside/outside
// convention, big = 1e6
__device__ __forceinline__ void slab(const float t0[3], const float t1[3],
                                     const bool inside[3], const Ray& ray, float& tn,
                                     float& tf) {
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    float n = tmin(t0[ax], t1[ax]), f = tmax(t0[ax], t1[ax]);
    if (ray.deg[ax]) {
      n = inside[ax] ? -1e6f : 1e6f;
      f = inside[ax] ? 1e6f : -1e6f;
    }
    tn = ax == 0 ? n : rmax(tn, n);
    tf = ax == 0 ? f : rmin(tf, f);
  }
}

// max over the axes of |p - c| (non-negative, so the order does not matter)
__device__ __forceinline__ float max_abs_diff(const float p[3], const float c[3]) {
  return fmaxf(fmaxf(fabsf(__fsub_rn(p[0], c[0])), fabsf(__fsub_rn(p[1], c[1]))),
               fabsf(__fsub_rn(p[2], c[2])));
}

__device__ __forceinline__ int pick4(const int4& v, int i) {
  return (i & 2) ? ((i & 1) ? v.w : v.z) : ((i & 1) ? v.y : v.x);
}

// kShared: the records and trans_idx of nodes [0, n_nodes) are staged into
// shared memory at entry and read there; else read from global memory.
template <bool kShared>
__global__ void __launch_bounds__(kThreads)
traverse_kernel(const int4* __restrict__ rec_g, const int* __restrict__ trans_g,
                int n_nodes, const float* __restrict__ rays_o,
                const float* __restrict__ rays_d, const float* __restrict__ near_in,
                const float* __restrict__ far_in, Hits out, int R, int H, int max_iters) {
  extern __shared__ int4 smem[];
  const int4* rec = rec_g;
  const int* trans = trans_g;
  if (kShared) {
    // kStage vector loads in flight a thread, then their stores
    int* strans = reinterpret_cast<int*>(smem + kRecVecs * n_nodes);
    const int total = kRecVecs * n_nodes;
    for (int i0 = threadIdx.x; i0 < total; i0 += kThreads * kStage) {
      int4 v[kStage];
#pragma unroll
      for (int k = 0; k < kStage; ++k)
        if (i0 + k * kThreads < total) v[k] = __ldg(rec_g + i0 + k * kThreads);
#pragma unroll
      for (int k = 0; k < kStage; ++k)
        if (i0 + k * kThreads < total) smem[i0 + k * kThreads] = v[k];
    }
    for (int i = threadIdx.x; i < n_nodes; i += kThreads) strans[i] = __ldg(trans_g + i);
    __syncthreads();
    rec = smem;
    trans = strans;
  }
  const int r = blockIdx.x * kThreads + threadIdx.x;
  int iters = 0, cnt = 0;
  if (r < R) {
    Ray ray;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      ray.o[ax] = rays_o[3 * r + ax];
      ray.d[ax] = rays_d[3 * r + ax];
      ray.deg[ax] = fabsf(ray.d[ax]) < (float)1e-6;
      ray.safe_d[ax] = ray.deg[ax] ? 1.0f : ray.d[ax];
    }
    const float nr = near_in[r], fr = far_in[r];
    const long long hrow = (long long)r * H;

    const int4 root = rec[0];
    const float c0[3] = {__int_as_float(root.x), __int_as_float(root.y),
                         __int_as_float(root.z)};
    const float root_side = __int_as_float(root.w);
    const float eps0 = __fmul_rn(root_side, (float)1e-6);
    float rn, rf;
    {
      float t0[3], t1[3];
      bool in[3];
      planes(c0, root_side, ray, t0, t1, in);
      slab(t0, t1, in, ray, rn, rf);
    }
    float t = tmax(rn, nr);
    const float t_end = tmin(rf, fr);
    bool done = t >= t_end;
    // the ulp floor applies to the initial eps too
    float eps = tmax(eps0, __fmul_rn(fabsf(t), (float)5e-7));
    int u = 0, last = -1;
    bool trunc = false;

    while (iters < max_iters && !done) {
      ++iters;
      const float te = __fadd_rn(t, eps);
      float p[3];
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) p[ax] = __fadd_rn(ray.o[ax], __fmul_rn(ray.d[ax], te));
      // round 1: the node's record and its trans_idx
      const int4* nu = rec + (long long)kRecVecs * u;
      const int4 box = nu[0], ch_lo = nu[1], ch_hi = nu[2], rope_lo = nu[3], tail = nu[4];
      const int tr_u = trans[u];
      const float cu[3] = {__int_as_float(box.x), __int_as_float(box.y), __int_as_float(box.z)};
      const float su = __int_as_float(box.w);
      const bool leaf = tail.z != 0;
      const bool outside = u != 0 && max_abs_diff(p, cu) > __fmul_rn(su, 0.5f);

      // the child octant that holds p, and whether p lies inside the child
      int ge[3];
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) ge[ax] = p[ax] >= cu[ax];
      const int oct = (ge[0] << 2) | (ge[1] << 1) | ge[2];
      const int c = pick4(oct & 4 ? ch_hi : ch_lo, oct);
      // round 2: the child's center and side (unused when outside)
      float cc[3] = {0.0f, 0.0f, 0.0f}, c_side = 0.0f;
      if (c >= 0 && !outside) {
        const int4 cb = rec[(long long)kRecVecs * c];
        cc[0] = __int_as_float(cb.x);
        cc[1] = __int_as_float(cb.y);
        cc[2] = __int_as_float(cb.z);
        c_side = __int_as_float(cb.w);
      }
      const bool inside_c = c >= 0 && !outside &&
                            max_abs_diff(p, cc) <= __fmul_rn(c_side, 0.5f);

      float new_t = t, new_eps = eps;
      int new_u = u;
      bool emit = false, rope_end = false;
      if (outside) {
        new_u = 0;
      } else if (!leaf && inside_c) {
        new_u = c;
      } else {
        // one slab: the node's box for a leaf, the child's for a skip
        float bc[3];
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) bc[ax] = leaf ? cu[ax] : cc[ax];
        float t0[3], t1[3];
        bool in[3];
        planes(bc, leaf ? su : c_side, ray, t0, t1, in);
        float n_b, f_b;
        slab(t0, t1, in, ray, n_b, f_b);
        if (leaf) {
          // ---- emit (if valid) and follow the exit-face rope
          const float n_l = tmax(n_b, nr);
          const float f_l = tmin(f_b, fr);
          const bool progress = f_l > t;
          emit = tr_u >= 0 && n_l < f_l && progress && cnt < H && u != last;
          if (emit) {
            out.idx[hrow + cnt] = u;
            out.near[hrow + cnt] = n_l;
            out.far[hrow + cnt] = f_l;
          }
          // the exit distance on each axis: the far plane of the slab
          int face_ax = 0;
          float best = 0.0f;
#pragma unroll
          for (int ax = 0; ax < 3; ++ax) {
            float v = ray.safe_d[ax] > 0.0f ? t1[ax] : t0[ax];
            if (ray.deg[ax]) v = 1e9f;
            // torch.argmin: the first least value, NaN counted least
            if (ax == 0 || (best == best && (v != v || v < best))) {
              best = v;
              face_ax = ax;
            }
          }
          const float d_face = face_ax == 0 ? ray.d[0] : (face_ax == 1 ? ray.d[1] : ray.d[2]);
          const int face = face_ax * 2 + (d_face > 0.0f);
          const int rope_u = face < 4 ? pick4(rope_lo, face) : (face == 4 ? tail.x : tail.y);
          const float leaf_t = tmax(f_l, t);
          float leaf_eps = tmax(tmax(__fmul_rn(su, (float)1e-4), eps0),
                                __fmul_rn(fabsf(leaf_t), (float)5e-7));
          if (!progress) leaf_eps = tmax(leaf_eps, __fmul_rn(eps, 4.0f));
          new_t = leaf_t;
          new_u = rope_u < 0 ? 0 : rope_u;
          if (!inside_c) new_eps = leaf_eps;
          rope_end = rope_u < 0;
        } else {
          // ---- internal, p outside the child: skip the empty region. The
          // octant's far: on each axis the plane on the ray's side
          const float oct_side = __fmul_rn(su, 0.5f);
          const float hf = __fmul_rn(oct_side, 0.5f);
          float f_o = 0.0f;
#pragma unroll
          for (int ax = 0; ax < 3; ++ax) {
            const float oc = __fadd_rn(cu[ax], __fmul_rn(__fmul_rn((float)ge[ax] - 0.5f, su), 0.5f));
            const float lo = __fsub_rn(oc, hf);
            const float hi = __fadd_rn(oc, hf);
            float f;
            if (ray.deg[ax]) {
              f = ray.o[ax] > lo && ray.o[ax] < hi ? 1e6f : -1e6f;
            } else {
              f = __fdiv_rn(__fsub_rn(ray.safe_d[ax] > 0.0f ? hi : lo, ray.o[ax]),
                            ray.safe_d[ax]);
            }
            f_o = ax == 0 ? f : rmin(f_o, f);
          }
          const bool ahead = c >= 0 && n_b > t && n_b < f_o && n_b < f_b;
          const float skip_t = tmax(ahead ? n_b : f_o, t);
          new_t = skip_t;
          new_eps = tmax(tmax(__fmul_rn(ahead ? c_side : oct_side, (float)1e-4), eps0),
                         __fmul_rn(fabsf(skip_t), (float)5e-7));
          if (new_t <= t) new_eps = tmax(new_eps, __fmul_rn(eps, 4.0f));  // the skip stall
        }
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
    out.n[r] = cnt;
    out.trunc[r] = trunc || !done;  // ~done at exit == max_iters reached
    out.iters[r] = iters;
  }
  // the slots past each ray's hits, -1 / 0 / 0: the warp's lanes write one
  // row at a time along the row (a thread filling its own row would write
  // 32 rows H apart with each store)
  const int lane = threadIdx.x & 31;
  const int r0 = r - lane;
  for (int j = 0; j < 32 && r0 + j < R; ++j) {
    const int cj = __shfl_sync(0xffffffffu, cnt, j);
    const long long row = (long long)(r0 + j) * H;
    for (int k = cj + lane; k < H; k += 32) {
      out.idx[row + k] = -1;
      out.near[row + k] = 0.0f;
      out.far[row + k] = 0.0f;
    }
  }
  // the loop's count: the largest per-ray count, a warp's max then one atomic
  const int m = __reduce_max_sync(0xffffffffu, iters);
  if (lane == 0 && m > 0) atomicMax(out.n_iters, m);
}

}  // namespace

// node_rec: [>= n_nodes, 20] int32 (the packed records); trans_idx: [>=
// n_nodes] int32. n_smem: the tree's node count to stage into shared
// memory, or 0 to read the tree from global memory. All outputs are
// written by the kernel (n_iters zeroed here first).
extern "C" int f2_traverse(const void* node_rec, const void* trans_idx, const void* rays_o,
                           const void* rays_d, const void* near, const void* far,
                           void* hit_idx, void* hit_near, void* hit_far, void* n_hits,
                           void* trunc, void* iters, void* n_iters, int n_smem, int R,
                           int H, int max_iters, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_smem < 0 || (long long)n_smem * kSmemNodeBytes > kSmemMaxBytes)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(n_iters, 0, sizeof(int), s);
  if (e != cudaSuccess || R <= 0) return (int)e;
  const Hits out{(int*)hit_idx, (float*)hit_near, (float*)hit_far, (int*)n_hits,
                 (unsigned char*)trunc, (int*)iters, (int*)n_iters};
  const unsigned blocks = (unsigned)((R + kThreads - 1) / kThreads);
  const int4* rec = (const int4*)node_rec;
  const int* tr = (const int*)trans_idx;
  if (n_smem > 0) {
    // above 48 KB only once allowed (a host call, per device)
    e = cudaFuncSetAttribute(traverse_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMaxBytes);
    if (e != cudaSuccess) return (int)e;
    traverse_kernel<true><<<blocks, kThreads, (size_t)n_smem * kSmemNodeBytes, s>>>(
        rec, tr, n_smem, (const float*)rays_o, (const float*)rays_d, (const float*)near,
        (const float*)far, out, R, H, max_iters);
  } else {
    traverse_kernel<false><<<blocks, kThreads, 0, s>>>(
        rec, tr, 0, (const float*)rays_o, (const float*)rays_d, (const float*)near,
        (const float*)far, out, R, H, max_iters);
  }
  return (int)cudaGetLastError();
}
