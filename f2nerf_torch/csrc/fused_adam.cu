// K1: fused Adam(+coupled weight decay) update, one pass over one leaf.
//
// Replaces the Pallas TPU kernel f2nerf_tpu/ops/fused_adam.py::adam_rows
// (_adam_kernel, pallas_call at :84). Same math, same order:
//   g' = g + wd*p;  m = b1*m + (1-b1)*g';  v = b2*v + (1-b2)*g'^2;
//   p -= lr * (m*c1) / (sqrt(v*c2) + eps),  c1 = 1/(1-b1^t), c2 = 1/(1-b2^t).
// lr, c1, c2 are read from a 3-float device buffer and the all-finite
// guard from a device bool, so the step's NaN guard costs no host sync:
// when the flag is 0 the kernel returns without writing anything.
//
// Bound on this card: device memory. Per element it reads p, m, v, g and
// writes p, m, v: 28 B. The wanjinyou feature pool is 33.5 M floats,
// ~0.94 GB per step, ~0.28 ms at 3.35 TB/s. The TPU kernel tiled rows into
// VMEM blocks; here a grid-stride loop with coalesced float accesses is
// enough to stream at near peak bandwidth (vector loads are later work).

#include <cuda_runtime.h>

namespace {

__global__ void adam_kernel(float* __restrict__ p, float* __restrict__ m,
                            float* __restrict__ v, const float* __restrict__ g,
                            long long n, const float* __restrict__ scal,
                            const bool* __restrict__ flag, float b1, float omb1,
                            float b2, float omb2, float eps, float wd) {
  if (!*flag) return;
  const float lr = scal[0], c1 = scal[1], c2 = scal[2];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float gi = g[i];
    const float pi = p[i];
    if (wd != 0.0f) gi = gi + wd * pi;
    const float mi = b1 * m[i] + omb1 * gi;
    const float vi = b2 * v[i] + omb2 * (gi * gi);
    const float u = (mi * c1) / (sqrtf(vi * c2) + eps);
    p[i] = pi - lr * u;
    m[i] = mi;
    v[i] = vi;
  }
}

}  // namespace

extern "C" int f2_fused_adam(void* p, void* m, void* v, const void* g,
                             long long n, const void* scal, const void* flag,
                             float b1, float omb1, float b2, float omb2,
                             float eps, float wd, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // 16 blocks per SM, grid-stride
  adam_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (float*)p, (float*)m, (float*)v, (const float*)g, n,
      (const float*)scal, (const bool*)flag, b1, omb1, b2, omb2, eps, wd);
  return (int)cudaGetLastError();
}
