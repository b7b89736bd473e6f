// K4: row gather, out[i, :] = table[idx[i], :] for an f32 table [t, W].
//
// Replaces the Pallas TPU kernel benchmarks/micro_gather.py::
// pallas_gather_case (kernel :116, pallas_call :123): blocks of 2048 rows
// whose indices sit in VMEM beside the whole [16384, 128] table (8 MiB),
// one serial row load per index. On the main path it is the forward of
// hash_block_gather_cached: B's encodings are rows of the prefilter's A
// encodings ([cap1, 32] f32, cap2 indices).
//
// Hopper has no 8 MiB of fast memory per SM (227 KB of shared memory), so
// the table is not staged: it is read through L2 (50 MB), which holds
// micro_gather's 8 MiB table and the slice's [cap1, 32] cache (~50 MB at
// cap1 393k, part of it). Each row gets a group of threads: a power of two
// lanes of one warp, sized to the row (W = 128 floats as 32 float4 -> one
// warp per row; W = 32 -> 8 lanes per row, 4 rows per warp), so a group's
// loads and stores cover one contiguous row. The index is loaded once per
// row by every lane of its group (one broadcast transaction).
//
// Bound on this card: device memory. Per row it writes W*4 B and reads W*4 B
// from L2 (or HBM) plus the index; at micro_gather's n = 2^20, W = 128 the
// 512 MB of output alone take 0.16 ms at 3.35 TB/s.
//
// 16-byte loads and stores where W % 4 == 0 and both pointers are 16-byte
// aligned, scalar otherwise; the choice is made inside the kernel and is
// uniform over the grid. Offsets are 64-bit. Indices are int32 or int64 and
// in range by construction (the caller's compaction makes them); the
// kernel does not check them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename Idx>
__global__ void row_gather_kernel(const float* __restrict__ table,
                                  const Idx* __restrict__ idx,
                                  float* __restrict__ out, long long n, int w,
                                  int lanes_log2) {
  const bool vec = (w & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(table) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const int lanes = 1 << lanes_log2;
  const int lane = threadIdx.x & (lanes - 1);
  const long long groups_per_block = blockDim.x >> lanes_log2;
  const long long stride = (long long)gridDim.x * groups_per_block;
  for (long long r = (long long)blockIdx.x * groups_per_block +
                     (threadIdx.x >> lanes_log2);
       r < n; r += stride) {
    const long long src = (long long)idx[r] * w;
    const long long dst = r * w;
    if (vec) {
      const float4* s = reinterpret_cast<const float4*>(table + src);
      float4* d = reinterpret_cast<float4*>(out + dst);
      for (int c = lane; c < (w >> 2); c += lanes) d[c] = __ldg(s + c);
    } else {
      for (int c = lane; c < w; c += lanes) out[dst + c] = __ldg(table + src + c);
    }
  }
}

// lanes per row: the row's width in loads (float4 or float), rounded up to
// a power of two, at most a warp
int lanes_log2_for(int w) {
  const int units = (w & 3) == 0 ? (w >> 2) : w;
  int l = 0;
  while ((1 << l) < units && l < 5) ++l;
  return l;
}

}  // namespace

extern "C" int f2_row_gather(const void* table, const void* idx, int idx_is_64,
                             void* out, long long n, int w, void* stream) {
  if (n <= 0 || w <= 0) return 0;
  const int threads = 256;
  const int lanes_log2 = lanes_log2_for(w);
  const long long rows_per_block = threads >> lanes_log2;
  long long blocks = (n + rows_per_block - 1) / rows_per_block;
  if (blocks > 132 * 16) blocks = 132 * 16;  // 16 blocks per SM, grid-stride
  cudaStream_t s = (cudaStream_t)stream;
  if (idx_is_64) {
    row_gather_kernel<long long><<<(unsigned)blocks, threads, 0, s>>>(
        (const float*)table, (const long long*)idx, (float*)out, n, w,
        lanes_log2);
  } else {
    row_gather_kernel<int><<<(unsigned)blocks, threads, 0, s>>>(
        (const float*)table, (const int*)idx, (float*)out, n, w, lanes_log2);
  }
  return (int)cudaGetLastError();
}
