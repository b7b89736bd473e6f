// K15: pixels to world rays (Img2WorldRayKernel, Dataset.cu:98-123, with
// iterative_camera_undistortion, Dataset.cu:31-69), in one launch. Replaces
// the torch chain of f2nerf_torch/data/dataset.py sample_rays_plain and
// f2nerf_torch/core/camera.py pixel_to_ray_plain: the row gathers of the
// images, poses, intrinsics, distortion, bounds and train ids, the cast and
// divide of gt, and undistort's 10 Newton steps of ~89 elementwise ops each,
// ~957 outermost aten ops a 512-ray call, each moving a few kilobytes.
//
// A thread a ray r. Its camera row c, in one of two forms:
//   a camera pick per ray (sample_rays): k = pick[r] indexes train_ids and
//     the rows of images; c = train_ids[k]; (i, j) are integer pixels,
//     shifted by 0.5 here; gt[r] = image[k, i, j] as floats times 1/255
//     (what torch's CUDA divide by a CPU scalar computes: a multiply by the
//     f32 reciprocal), bounds[r] = bounds[c], img_idx[r] = train_ids[k];
//   no pick (pixel_to_ray): c = r * cam_step, cam_step 1 where the camera
//     rows are the rays' own ([n, 3, 4] poses), 0 for one camera ([3, 4]);
//     (i, j) are floats, already shifted.
// Then u = (j - cx) / fx, v = (i - cy) / fy, n_iters Newton steps of
// undistort in registers, rays_o[r] = pose[c, :, 3] and
// rays_d[r, a] = (R[a, 0] u - R[a, 1] v) - R[a, 2].
//
// Every operation rounds as the plain version's torch ops do on the card,
// in their order (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn; nvcc would
// contract a multiply-add into an FMA, and the package builds without
// --use_fast_math), so the rays, gt and bounds are bit for bit the plain
// route's on the card, NaN, inf and signed zeros included. An index below
// zero counts from the end, as torch's gathers do (the ray itself uses the
// pixel as given); one out of range traps, as torch's device assert does.
//
// Bound: bytes. A ray reads its draws (24 bytes as int64), 3 image bytes
// and writes 48 (rays_o, rays_d, gt, bounds, img_idx); the camera rows
// (112 bytes a camera) are read once. At the step's 512 rays that is ~39
// KB, ~0.01 us at 3.35 TB/s: the launch itself is the cost. The Newton
// steps are ~700 f32 operations a ray, two of them divides.
//
// f2_rays returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

struct Rays {
  const void* pick;               // [n] I, or null
  const void* pi;                 // [n] I rows, or f32 shifted rows where I is float
  const void* pj;                 // [n] the columns alike
  const int* train_ids;           // [n_rows] with pick
  const unsigned char* images;    // [n_rows, height, width, 3] u8 with pick
  const float* poses;             // [n_cams, 3, 4]
  const float* intri;             // [n_cams, 3, 3]
  const float* dist;              // [n_cams, 4]
  const float* bounds;            // [n_cams, 2] with pick
  float* rays_o;                  // [n, 3]
  float* rays_d;                  // [n, 3]
  float* gt;                      // [n, 3] with pick
  float* bounds_out;              // [n, 2] with pick
  int* img_idx;                   // [n] with pick
  long long n;
  long long n_rows, n_cams, height, width;
  int cam_step, n_iters;
};

// torch's gather index: from the end below zero; out of range is an error
__device__ __forceinline__ long long wrap(long long k, long long size) {
  if (k < -size || k >= size) __trap();
  return k < 0 ? k + size : k;
}

// undistort (camera.py): (x, y) with (x, y) + D(x, y) = (u, v)
__device__ __forceinline__ void undistort(const float* d, float u, float v, int n_iters,
                                          float& x, float& y) {
  const float k1 = d[0], k2 = d[1], p1 = d[2], p2 = d[3];
  const float c2k2 = mul(2.0f, k2), c2p1 = mul(2.0f, p1), c2p2 = mul(2.0f, p2);
  const float c6p1 = mul(6.0f, p1), c6p2 = mul(6.0f, p2);
  const float tiny = static_cast<float>(1e-12);  // torch's f32 of the scalar 1e-12
  x = u;
  y = v;
  for (int it = 0; it < n_iters; ++it) {
    const float x2 = mul(x, x), y2 = mul(y, y), xy = mul(x, y);
    const float r2 = add(x2, y2);
    const float radial = add(mul(k1, r2), mul(mul(k2, r2), r2));
    const float drad = add(k1, mul(c2k2, r2));
    const float du = add(add(mul(x, radial), mul(c2p1, xy)), mul(p2, add(r2, mul(2.0f, x2))));
    const float dv = add(add(mul(y, radial), mul(c2p2, xy)), mul(p1, add(r2, mul(2.0f, y2))));
    const float fx = sub(add(x, du), u);
    const float fy = sub(add(y, dv), v);
    const float one_r = add(1.0f, radial);
    const float xd2 = mul(mul(x, drad), 2.0f), yd2 = mul(mul(y, drad), 2.0f);
    const float j00 = add(add(add(one_r, mul(xd2, x)), mul(c2p1, y)), mul(c6p2, x));
    const float j01 = add(add(mul(xd2, y), mul(c2p1, x)), mul(c2p2, y));
    const float j10 = add(add(mul(yd2, x), mul(c2p2, y)), mul(c2p1, x));
    const float j11 = add(add(add(one_r, mul(yd2, y)), mul(c2p2, x)), mul(c6p1, y));
    float det = sub(mul(j00, j11), mul(j01, j10));
    if (fabsf(det) < tiny) det = tiny;
    const float sx = dvd(sub(mul(j11, fx), mul(j01, fy)), det);
    const float sy = dvd(add(mul(-j10, fx), mul(j00, fy)), det);
    x = sub(x, sx);
    y = sub(y, sy);
  }
}

template <typename I>
__global__ void __launch_bounds__(kThreads) rays_kernel(const Rays p) {
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= p.n) return;
  float fi, fj;
  long long c;
  if constexpr (std::is_same<I, float>::value) {
    fi = ((const float*)p.pi)[r];
    fj = ((const float*)p.pj)[r];
    c = r * p.cam_step;
  } else {
    const long long i = ((const I*)p.pi)[r], j = ((const I*)p.pj)[r];
    const long long k = wrap(((const I*)p.pick)[r], p.n_rows);
    const int id = p.train_ids[k];
    c = wrap(id, p.n_cams);
    // torch: .long() -> .to(float32) -> + 0.5
    fi = add((float)i, 0.5f);
    fj = add((float)j, 0.5f);
    const unsigned char* px =
        p.images + ((k * p.height + wrap(i, p.height)) * p.width + wrap(j, p.width)) * 3;
    const float inv = dvd(1.0f, 255.0f);
#pragma unroll
    for (int a = 0; a < 3; ++a) p.gt[3 * r + a] = mul((float)px[a], inv);
    p.bounds_out[2 * r] = p.bounds[2 * c];
    p.bounds_out[2 * r + 1] = p.bounds[2 * c + 1];
    p.img_idx[r] = id;
  }
  const float* K = p.intri + 9 * c;
  const float u = dvd(sub(fj, K[2]), K[0]);
  const float v = dvd(sub(fi, K[5]), K[4]);
  float x, y;
  undistort(p.dist + 4 * c, u, v, p.n_iters, x, y);
  const float* P = p.poses + 12 * c;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    p.rays_o[3 * r + a] = P[4 * a + 3];
    p.rays_d[3 * r + a] = sub(sub(mul(P[4 * a], x), mul(P[4 * a + 1], y)), P[4 * a + 2]);
  }
}

}  // namespace

// pick, pi, pj [n] of kind 0 (int32), 1 (int64) or 2 (f32: pi, pj the shifted
// pixel, pick null). With a pick: train_ids [n_rows] i32, images
// [n_rows, height, width, 3] u8, bounds [n_cams, 2] f32, and the outputs gt
// [n, 3], bounds_out [n, 2] f32 and img_idx [n] i32. Always poses
// [n_cams, 3, 4], intri [n_cams, 3, 3], dist [n_cams, 4] f32, rays_o and
// rays_d [n, 3] f32; without a pick ray r takes camera r * cam_step.
extern "C" int f2_rays(const void* pick, const void* pi, const void* pj, int kind,
                       const void* train_ids, const void* images, const void* poses,
                       const void* intri, const void* dist, const void* bounds, void* rays_o,
                       void* rays_d, void* gt, void* bounds_out, void* img_idx, long long n,
                       long long n_rows, long long n_cams, long long height, long long width,
                       int cam_step, int n_iters, void* stream) {
  if (n <= 0) return 0;
  const bool picked = kind != 2;
  if (kind < 0 || kind > 2 || n_cams <= 0 || n_iters < 0 || (pick != nullptr) != picked ||
      (picked && (!train_ids || !images || !bounds || !gt || !bounds_out || !img_idx ||
                  n_rows <= 0 || height <= 0 || width <= 0)) ||
      (!picked && (cam_step < 0 || cam_step > 1 || (cam_step == 1 && n_cams < n))))
    return (int)cudaErrorInvalidValue;
  const Rays p{pick, pi, pj, (const int*)train_ids, (const unsigned char*)images,
               (const float*)poses, (const float*)intri, (const float*)dist,
               (const float*)bounds, (float*)rays_o, (float*)rays_d, (float*)gt,
               (float*)bounds_out, (int*)img_idx, n, n_rows, n_cams, height, width,
               cam_step, n_iters};
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (kind == 0)
    rays_kernel<int32_t><<<blocks, kThreads, 0, s>>>(p);
  else if (kind == 1)
    rays_kernel<long long><<<blocks, kThreads, 0, s>>>(p);
  else
    rays_kernel<float><<<blocks, kThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}
