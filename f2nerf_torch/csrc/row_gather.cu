// K4: row gather, out[i, :] = table[idx[i], :] for an f32 table [t, W].
//
// Replaces the Pallas TPU kernel benchmarks/micro_gather.py::
// pallas_gather_case (kernel :116, pallas_call :123): blocks of 2048 rows
// whose indices sit in VMEM beside the whole [16384, 128] table (8 MiB),
// one serial row load per index. On the main path it is the forward of
// hash_block_grad_pass (fields/hash_block.py): B's encodings are rows of
// the prefilter's A encodings ([cap1, 32] f32, cap2 int64 indices, in
// increasing order; the padding rows, 58-86% of B, all carry index n - 1).
//
// Bound on this card: device memory. Per row it writes W*4 B and reads the
// index; each distinct row is read once from HBM (repeats hit L2, 50 MB).
// At the slice's inputs that is ~0.012-0.015 ms at 3.35 TB/s; at
// micro_gather's n = 2^20, W = 128 the 512 MB of output alone take 0.16 ms.
//
// Design: a row is a chain of two dependent loads (index, then the row),
// and the first version of this kernel kept one such chain in flight per
// lane in a grid of 132 x 16 blocks, twice what the SMs hold at once. Here
// a group of lanes (a power of two of one warp, sized to the row: W = 32
// -> 8 lanes of float4, W = 128 -> 32) owns kRows consecutive rows per
// step: it loads their kRows indices with one 16-byte load (two for int64)
// broadcast to the group, then issues all kRows row loads, then the
// stores, so each lane has kRows 16-byte loads in flight instead of one.
// The grid is the number of blocks the SMs hold at once (occupancy query),
// striding over the rows.
//
// Measured on one H100 SXM (chip_smoke.py, device time with the stream
// held busy so the host's enqueue is not counted): this design and the
// first one take the same time within 3% (kRows 8 too), 65-72% of the
// bound at the slice's inputs and at micro_gather's shape. One chain per
// lane was not what held the first version at ~1.6 TB/s: its timing
// counted the wrapper's host time, as long as the kernel at these sizes.
// What remains is the launch's ramp and tail: a contiguous copy of the
// same output bytes is no faster.
//
// 16-byte row accesses where W % 4 == 0 and table and out are 16-byte
// aligned, 4-byte ones (the same structure over floats) otherwise; vector
// index loads where idx is 16-byte aligned, one load per index otherwise.
// Offsets are 64-bit. Indices are int32 or int64 and in range by
// construction (the caller's compaction makes them); the kernel does not
// check them. The result is a copy: bit for bit index_select.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;  // rows a lane group has in flight

static_assert(kRows % 4 == 0, "indices load as whole int4 / longlong2 vectors");

// the kRows indices of a group's rows from a 16-byte aligned address
__device__ __forceinline__ void load_rows_idx(const int* p, long long (&ix)[kRows]) {
#pragma unroll
  for (int q = 0; q < kRows / 4; ++q) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(p) + q);
    ix[4 * q] = v.x; ix[4 * q + 1] = v.y; ix[4 * q + 2] = v.z; ix[4 * q + 3] = v.w;
  }
}

__device__ __forceinline__ void load_rows_idx(const long long* p,
                                              long long (&ix)[kRows]) {
#pragma unroll
  for (int q = 0; q < kRows / 2; ++q) {
    const longlong2 v = __ldg(reinterpret_cast<const longlong2*>(p) + q);
    ix[2 * q] = v.x; ix[2 * q + 1] = v.y;
  }
}

// T is float4 (units = W / 4) or float (units = W)
template <typename T, typename Idx>
__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const T* __restrict__ table, const Idx* __restrict__ idx,
                  T* __restrict__ out, long long n, int units, int lanes_log2,
                  int idx_vec) {
  const int lanes = 1 << lanes_log2;
  const int lane = threadIdx.x & (lanes - 1);
  const long long per_block = kThreads >> lanes_log2;
  const long long step = (long long)gridDim.x * per_block * kRows;
  for (long long r0 = ((long long)blockIdx.x * per_block +
                       (threadIdx.x >> lanes_log2)) * kRows;
       r0 < n; r0 += step) {
    const bool full = r0 + kRows <= n;
    long long ix[kRows];
    if (full && idx_vec) {
      load_rows_idx(idx + r0, ix);
    } else {
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        ix[k] = r0 + k < n ? (long long)__ldg(idx + r0 + k) : 0;
    }
    for (int c = lane; c < units; c += lanes) {
      T v[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        if (full || r0 + k < n) v[k] = __ldg(table + ix[k] * units + c);
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        if (full || r0 + k < n) out[(r0 + k) * units + c] = v[k];
    }
  }
}

// lanes per row: the row's width in loads (float4 or float), rounded up to
// a power of two, at most a warp
int lanes_log2_for(int units) {
  int l = 0;
  while ((1 << l) < units && l < 5) ++l;
  return l;
}

template <typename T, typename Idx>
int launch(const void* table, const void* idx, void* out, long long n,
           int units, int idx_vec, cudaStream_t s) {
  // blocks of this kernel one SM holds at once (the same on every card of
  // one architecture); the benign race of two first calls writes one value
  static int per_sm = 0;
  cudaError_t e;
  if (per_sm == 0) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, row_gather_kernel<T, Idx>, kThreads, 0);
    if (e != cudaSuccess) return (int)e;
  }
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int lanes_log2 = lanes_log2_for(units);
  const long long rows_per_block = (long long)(kThreads >> lanes_log2) * kRows;
  long long blocks = (n + rows_per_block - 1) / rows_per_block;
  const long long resident = (long long)sms * per_sm;
  if (blocks > resident) blocks = resident;
  row_gather_kernel<T, Idx><<<(unsigned)blocks, kThreads, 0, s>>>(
      (const T*)table, (const Idx*)idx, (T*)out, n, units, lanes_log2, idx_vec);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" int f2_row_gather(const void* table, const void* idx, int idx_is_64,
                             void* out, long long n, int w, void* stream) {
  if (n <= 0 || w <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = (w & 3) == 0 && aligned16(table) && aligned16(out);
  const int idx_vec = aligned16(idx) ? 1 : 0;
  if (vec) {
    return idx_is_64 ? launch<float4, long long>(table, idx, out, n, w >> 2, idx_vec, s)
                     : launch<float4, int>(table, idx, out, n, w >> 2, idx_vec, s);
  }
  return idx_is_64 ? launch<float, long long>(table, idx, out, n, w, idx_vec, s)
                   : launch<float, int>(table, idx, out, n, w, idx_vec, s);
}
