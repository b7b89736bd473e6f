// K13: the keep-set compaction A -> B (the prefilter's survivors into the
// grad pass's buffer), and B's ray segments. Replaces
// f2nerf_tpu/render/renderer.py:72 (_compact with a ray-id source:
// jnp.nonzero(size=cap) and one where/gather a field), and on B the offsets
// launch (ray_offsets in csrc/segment.cu: JAX's local_index and the step's
// segment_sum of ones) and first_flags_from_ray_id. For keep flags over A's
// n rows, rid_src A's ray ids (sorted, padding rows == n_rays, kept rows in
// rays), K(i) the kept rows before row i and m = min(total kept, cap):
//   slot p < m takes the p-th kept row i: t, dt, node, trans, pts01 [3],
//   dirs [3] = A's row i, rid = rid_src[i], ok = 1, idx = i (int64, the
//   cached-B gather's index); kept rows past cap are dropped;
//   slots p >= m: zeros, rid = n_rays, ok = 0, idx = n - 1 (the JAX fill
//   index, which the cached-B gather reads);
//   B's segments, what ray_offsets and first_flags_from_ray_id give for
//   B's rid: offsets [n_rays + 1] (ray q's first slot: min(cap, K(the first
//   row of A at or past ray q)), so offsets[n_rays] = m), counts [n_rays]
//   f32, local [cap] (a slot's index in its ray; padding slots continue
//   the last ray's count) and first [cap] (slot p < m starts its ray).
// A row i of A where the ray id changes (row 0 after a virtual -1, a
// virtual row n before a virtual n_rays) writes offsets[q] = min(cap, K(i))
// for every ray q in (previous, current]: the offsets launch's rule with
// the kept count in place of the row index.
//
// One launch, no grid barrier. Blocks 0 .. n_tiles - 1 are tiles of
// kTileRows rows of A (the virtual row n included), the rest padding
// blocks of kPadSlots slots of B. A tile waits only on tiles of lower
// index, a padding block only on tiles. That rests on blocks being
// dispatched in index order, as CUB's decoupled look-back also assumes:
// CUDA does not promise it, the card does it, and a grid many times what
// the card holds at once runs to its end (tests/test_torch_compact_warp.py
// at 2^23 rows):
//   tile: 1. loads its flags and ray ids (a row a thread in chunks of
//      kThreads rows, every load in flight at once); ballots of kept rows
//      and of ray starts; warp 0 scans them: the tile's kept rows before
//      each (chunk, warp) and the last ray start before it;
//   2. publishes its aggregate (kept rows; kept rows at or after its last
//      ray start, and whether one starts in it), then warp 0 looks back
//      over the earlier tiles' records, 32 at a time, waiting for each
//      until published: aggregates until a tile that has published its
//      prefix. That gives K at the tile's first row and at the start of the
//      ray that runs into the tile from before; the tile publishes its
//      prefix (kept rows to its end, K at its last ray start). Integers
//      only: whichever records a look-back reads, the sums are the same;
//   3. each thread copies its kept rows below cap to their slots (kCopy
//      rows' loads in flight), writes the offsets of a ray that starts at
//      its row and the count of the ray before it, and a kept slot's local
//      index and first flag: a ray's first slot is K at its start, the
//      last start at or before the row in the tile (from the ballots in
//      shared memory) or the look-back's for the ray that runs in;
//   4. counts itself done;
//   padding block: waits for the last tile's prefix (m), writes its
//   padding slots' fields and first flags, waits for every tile to be
//   done, then their local indices (from the last kept slot's ray). The
//   last padding block to get there puts the counters and flags back to
//   zero, so a call needs no reset on the stream and no host sync
//   (render/renderer.py keeps one zeroed state buffer a device and
//   stream).
// Integers and copies only: the result does not depend on any order and
// equals the plain version bit for bit.
//
// Bound: bytes: the flags and A's rid read once, the kept rows (40 bytes
// of fields) read once, 53 bytes a B slot, the segments (5 bytes a slot
// and 8 a ray) written. At the slice (cap1 262,144, ~142k kept, cap2
// 262,144) ~22 MB, ~0.0067 ms at 3.35 TB/s.
//
// Chosen by scripts/sweep_kernels.py's k13 sweep (PERF.md §6; NVIDIA
// H100 80GB HBM3, 700 W): 4 rows a thread (2: longer look-backs;
// 8 and 16: one tile an SM, its latency chain unhidden); each thread its
// own rows (a shared list of the tile's kept rows, a thread a slot, was
// slower); tiles by index (a ticket from one atomic word serialized ~257
// blocks, ~0.004 ms); a cooperative form with grid barriers and pts01/dirs
// staged through shared memory were slower too.
//
// Each entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;                         // rows a thread in a tile
constexpr int kTileRows = kThreads * kRows;      // rows a tile
constexpr int kEntries = kRows * kWarps;         // a tile's (chunk, warp) entries
constexpr int kPadSlots = kThreads * 8;          // B slots a padding block
constexpr int kCopy = kRows < 4 ? kRows : 4;    // kept rows a thread copies at once
constexpr unsigned kFull = 0xffffffffu;

// A tile's record. flag: 0 until published, kAgg once cnt and tail are,
// kPrefix once incl and last_k are too, kStart if a ray starts in it.
struct Tile {
  int cnt;      // kept rows in the tile
  int tail;     // kept rows at or after its last ray start (cnt if none)
  int incl;     // kept rows before its end
  int last_k;   // kept rows before the last ray start at or before its end
  int flag;
  int pad[3];
};
constexpr int kAgg = 1, kStart = 2, kPrefix = 4;

struct Keep {
  const unsigned char* keep;   // [n]
  const float* t;              // [n] each
  const float* dt;
  const int* node;
  const int* trans;
  const float* pts01;          // [n, 3]
  const float* dirs;           // [n, 3]
  const int* rid_src;          // [n]
  float* o_t;                  // [cap] each
  float* o_dt;
  int* o_node;
  int* o_trans;
  float* o_pts01;              // [cap, 3]
  float* o_dirs;               // [cap, 3]
  int* o_rid;
  unsigned char* o_ok;
  long long* o_idx;
  int* o_offsets;              // [n_rays + 1]
  float* o_counts;             // [n_rays]
  int* o_local;                // [cap]
  unsigned char* o_first;      // [cap]
  unsigned* counters;          // [1] tiles done, [2] padding blocks finished ([0] unused)
  Tile* tiles;                 // [n_tiles]
  long long n;
  long long cap;
  int n_rays;
  unsigned n_tiles;
  unsigned n_blocks;
};

// Publication between blocks (gpu scope): a release store of a flag after
// what it publishes, an acquire load before that is read
__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
// a wait for a published flag: relaxed loads until it is set, then one
// acquire load
__device__ __forceinline__ int load_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ unsigned load_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
template <typename T, typename Ready>
__device__ __forceinline__ T wait_for(const T* p, Ready ready) {
  while (!ready(load_relaxed(p))) {
  }
  return load_acquire(p);
}
__device__ __forceinline__ void red_release(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ unsigned add_acq_rel(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

// Warp 0 of tile `tile` > 0: K at the tile's first row (excl) and at the
// start of the ray that runs into it (kr0), from the earlier tiles'
// records. Lane l reads tile base - l; the window's lanes up to the
// nearest prefix (stop) count: their cnt, the prefix tile's incl. The
// nearest tile with a ray start gives kr0 = excl - (its tail and the cnt
// of the tiles after it); with none up to the prefix tile, its last_k.
__device__ __forceinline__ void look_back(const Tile* tiles, unsigned tile, int lane, int& excl,
                                          int& kr0) {
  int e = 0, d = 0, abs_k = 0;
  bool found = false, absolute = false;
  for (long long base = (long long)tile - 1;; base -= 32) {
    const long long q = base - lane;
    int flag = 0, c = 0, tl = 0, inc = 0, lk = 0;
    if (q >= 0) {                        // tile 0 publishes its prefix at once
      flag = wait_for(&tiles[q].flag, [](int f) { return f != 0; });
      c = __ldcg(&tiles[q].cnt);
      tl = __ldcg(&tiles[q].tail);
      if (flag & kPrefix) {
        inc = __ldcg(&tiles[q].incl);
        lk = __ldcg(&tiles[q].last_k);
      }
    }
    const unsigned pm = __ballot_sync(kFull, (flag & kPrefix) != 0);
    const int stop = pm ? __ffs(pm) - 1 : 31;
    const bool in = q >= 0 && lane <= stop;
    const int win = __reduce_add_sync(kFull, in ? (pm && lane == stop ? inc : c) : 0);
    if (!found) {
      const unsigned sm = __ballot_sync(kFull, in && (flag & kStart) != 0);
      if (sm) {
        const int j = __ffs(sm) - 1;
        d += __reduce_add_sync(kFull, lane < j ? c : 0) + __shfl_sync(kFull, tl, j);
        found = true;
      } else if (pm) {
        abs_k = __shfl_sync(kFull, lk, stop);
        absolute = found = true;
      } else {
        d += win;
      }
    }
    e += win;
    if (pm) break;
  }
  excl = e;
  kr0 = absolute ? abs_k : e - d;
}

__device__ void tile_body(const Keep& p, unsigned tile) {
  __shared__ unsigned s_mask[kEntries], s_smask[kEntries];   // kept, ray-start ballots
  __shared__ int s_pre[kEntries + 1];     // kept rows of the tile before each entry
  __shared__ int s_lastpre[kEntries];     // the last ray start before each entry (-1: none)
  __shared__ int s_last, s_excl, s_kr0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const unsigned le = lane == 31 ? kFull : (2u << lane) - 1u;
  const long long t0 = (long long)tile * kTileRows;

  // 1. the rows (row t0 + k kThreads + threadIdx.x, the tile's flat index
  // e * 32 + lane with entry e = k kWarps + warp): kept, ray id (clamped to
  // n_rays; the virtual row n and past it n_rays), the previous row's,
  // whether a ray starts here
  bool kept[kRows];
  int cur[kRows], prev[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {                       // every load in flight at once
    const long long i = t0 + k * kThreads + threadIdx.x;
    cur[k] = i < p.n ? min(__ldg(p.rid_src + i), p.n_rays) : p.n_rays;
    kept[k] = i < p.n && __ldg(p.keep + i) != 0;
    prev[k] = lane > 0 || i == 0 ? -1 : i - 1 < p.n ? min(__ldg(p.rid_src + i - 1), p.n_rays)
                                                    : p.n_rays;
  }
  unsigned starts = 0;                                     // bit k: a ray starts at row k
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const long long i = t0 + k * kThreads + threadIdx.x;
    const int pv = __shfl_up_sync(kFull, cur[k], 1);
    if (lane > 0) prev[k] = pv;
    const bool st = i <= p.n && cur[k] != prev[k];
    starts |= (unsigned)st << k;
    const unsigned mk = __ballot_sync(kFull, kept[k]), sm = __ballot_sync(kFull, st);
    if (lane == 0) {
      s_mask[k * kWarps + warp] = mk;
      s_smask[k * kWarps + warp] = sm;
    }
  }
  __syncthreads();
  // warp 0: the kept rows before each entry and the last ray start before
  // it, in row order (entry-major)
  if (warp == 0) {
    constexpr int per = (kEntries + 31) / 32;
    int c[per], ls[per], sum = 0, mx = -1;
#pragma unroll
    for (int j = 0; j < per; ++j) {
      const int e = lane * per + j;
      const unsigned sm = e < kEntries ? s_smask[e] : 0u;
      c[j] = e < kEntries ? __popc(s_mask[e]) : 0;
      ls[j] = sm ? e * 32 + 31 - __clz(sm) : -1;
      sum += c[j];
      mx = max(mx, ls[j]);
    }
    int inc = sum, incm = mx;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(kFull, inc, off), um = __shfl_up_sync(kFull, incm, off);
      if (lane >= off) {
        inc += u;
        incm = max(incm, um);
      }
    }
    int run = inc - sum, runm = __shfl_up_sync(kFull, incm, 1);
    if (lane == 0) runm = -1;
#pragma unroll
    for (int j = 0; j < per; ++j) {
      const int e = lane * per + j;
      if (e < kEntries) {
        s_pre[e] = run;
        s_lastpre[e] = runm;
      }
      run += c[j];
      runm = max(runm, ls[j]);
    }
    if (lane == 31) {
      s_pre[kEntries] = inc;
      s_last = incm;
    }
  }
  __syncthreads();
  // K within the tile before flat row f
  auto k_at = [&](int f) {
    return s_pre[f >> 5] + __popc(s_mask[f >> 5] & ((1u << (f & 31)) - 1u));
  };
  const int cnt = s_pre[kEntries];
  const int last = s_last;
  const bool has_start = last >= 0;
  const int tail = has_start ? cnt - k_at(last) : cnt;

  // 2. the aggregate, the look-back, the prefix (tile 0: its prefix at once)
  Tile* rec = p.tiles + tile;
  if (threadIdx.x == 0) {
    rec->cnt = cnt;
    rec->tail = tail;
    if (tile == 0) {
      rec->incl = cnt;
      rec->last_k = cnt - tail;
      store_release(&rec->flag, kAgg | kPrefix | kStart);
      s_excl = 0;
      s_kr0 = 0;
    } else {
      store_release(&rec->flag, kAgg | (has_start ? kStart : 0));
    }
  }
  if (warp == 0 && tile > 0) {
    int excl, kr0;
    look_back(p.tiles, tile, lane, excl, kr0);
    if (lane == 0) {
      s_excl = excl;
      s_kr0 = kr0;
      rec->incl = excl + cnt;
      rec->last_k = has_start ? excl + cnt - tail : kr0;
      store_release(&rec->flag, kAgg | kPrefix | (has_start ? kStart : 0));
    }
  }
  __syncthreads();
  const int excl = s_excl, kr0 = s_kr0;
  const long long cap = p.cap;

  // 3. each thread's kept rows below cap to their slots, kCopy rows' loads
  // in flight before their stores
  const int n_copy = (int)max(0LL, min((long long)cnt, cap - excl));
#pragma unroll
  for (int j0 = 0; j0 < kRows; j0 += kCopy) {
    float ft[kCopy], fdt[kCopy], fp[kCopy][3], fd[kCopy][3];
    int fn[kCopy], ftr[kCopy], fr[kCopy], slot[kCopy];
    long long row[kCopy];
#pragma unroll
    for (int u = 0; u < kCopy; ++u) {
      const long long i = t0 + (j0 + u) * kThreads + threadIdx.x;
      const int j = kept[j0 + u] ? k_at(((j0 + u) * kWarps + warp) * 32 + lane) : n_copy;
      slot[u] = j;
      if (j < n_copy) {
        row[u] = i;
        ft[u] = __ldg(p.t + i);
        fdt[u] = __ldg(p.dt + i);
        fn[u] = __ldg(p.node + i);
        ftr[u] = __ldg(p.trans + i);
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) {
          fp[u][ax] = __ldg(p.pts01 + 3 * i + ax);
          fd[u][ax] = __ldg(p.dirs + 3 * i + ax);
        }
        fr[u] = __ldg(p.rid_src + i);
      }
    }
#pragma unroll
    for (int u = 0; u < kCopy; ++u) {
      const int j = slot[u];
      if (j < n_copy) {
        const long long q = (long long)excl + j;
        p.o_t[q] = ft[u];
        p.o_dt[q] = fdt[u];
        p.o_node[q] = fn[u];
        p.o_trans[q] = ftr[u];
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) {
          p.o_pts01[3 * q + ax] = fp[u][ax];
          p.o_dirs[3 * q + ax] = fd[u][ax];
        }
        p.o_rid[q] = fr[u];
        p.o_ok[q] = 1;
        p.o_idx[q] = row[u];
      }
    }
  }
  // each row's own: the offsets of a ray that starts here and the count of
  // the ray before it (rays with no row in A count 0), a kept slot's local
  // index and first flag. A ray's first slot is K at its start: the last
  // start at or before the row in the tile, or kr0 for the ray running in.
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int e = k * kWarps + warp;
    const int f = e * 32 + lane;
    const int kk = excl + k_at(f);                         // K(i): the row's slot if kept
    const unsigned sm = s_smask[e];
    if ((starts >> k) & 1u) {
      const int v = (int)min((long long)kk, cap);
      for (int q = prev[k] + 1; q <= cur[k]; ++q) p.o_offsets[q] = v;
      if (prev[k] >= 0) {
        const unsigned m = sm & lt;
        const int b = m ? excl + k_at(e * 32 + 31 - __clz(m))
                        : s_lastpre[e] >= 0 ? excl + k_at(s_lastpre[e]) : kr0;
        p.o_counts[prev[k]] = (float)(v - (int)min((long long)b, cap));
      }
      for (int q = prev[k] + 1; q < cur[k]; ++q) p.o_counts[q] = 0.0f;
    }
    if (kept[k] && kk < cap) {
      const unsigned m = sm & le;
      const int base = m ? excl + k_at(e * 32 + 31 - __clz(m))
                         : s_lastpre[e] >= 0 ? excl + k_at(s_lastpre[e]) : kr0;
      p.o_local[kk] = kk - base;
      p.o_first[kk] = kk == base;
    }
  }

  // 4. done: every write of the block before the count
  __syncthreads();
  if (threadIdx.x == 0) red_release(p.counters + 1, 1u);
}

__device__ void pad_body(const Keep& p, unsigned j) {
  __shared__ int s_m, s_last_start;
  __shared__ bool s_final;
  const long long s0 = (long long)j * kPadSlots;
  const long long s1 = min(p.cap, s0 + kPadSlots);
  if (threadIdx.x == 0) {
    const Tile* last = p.tiles + p.n_tiles - 1;
    wait_for(&last->flag, [](int f) { return (f & kPrefix) != 0; });
    s_m = (int)min((long long)__ldcg(&last->incl), p.cap);
  }
  __syncthreads();
  const long long m = s_m;
  const long long lo = max(s0, m);
  if (lo < s1) {
    for (long long q = lo + threadIdx.x; q < s1; q += kThreads) {
      p.o_t[q] = 0.0f;
      p.o_dt[q] = 0.0f;
      p.o_node[q] = 0;
      p.o_trans[q] = 0;
      p.o_rid[q] = p.n_rays;
      p.o_ok[q] = 0;
      p.o_idx[q] = p.n - 1;
      p.o_first[q] = 0;
    }
    for (long long f = 3 * lo + threadIdx.x; f < 3 * s1; f += kThreads) {
      p.o_pts01[f] = 0.0f;
      p.o_dirs[f] = 0.0f;
    }
  }
  // every tile done: the padding slots continue the last kept slot's ray
  // (ray_offsets' rule); the last padding block to get here puts the
  // counters and flags back to zero for the next call (every tile and
  // every other padding block has done all its reads of them)
  if (threadIdx.x == 0) {
    const unsigned n_tiles = p.n_tiles;
    wait_for(p.counters + 1, [n_tiles](unsigned d) { return d >= n_tiles; });
    int ls = 0;
    if (lo < s1 && m > 0 && p.n_rays > 0)
      ls = __ldcg(p.o_offsets + min(__ldcg(p.o_rid + m - 1), p.n_rays - 1));
    s_last_start = ls;
    s_final = add_acq_rel(p.counters + 2, 1u) == p.n_blocks - p.n_tiles - 1;
  }
  __syncthreads();
  const long long ls = s_last_start;
  for (long long q = lo + threadIdx.x; q < s1; q += kThreads) p.o_local[q] = (int)(q - ls);
  if (s_final) {
    for (unsigned i = threadIdx.x; i < p.n_tiles; i += kThreads) p.tiles[i].flag = 0;
    if (threadIdx.x == 0) {
      p.counters[1] = 0;
      p.counters[2] = 0;
    }
  }
}

__global__ void __launch_bounds__(kThreads) compact_keep_kernel(const Keep p) {
  const unsigned b = blockIdx.x;
  if (b < p.n_tiles)
    tile_body(p, b);
  else
    pad_body(p, b - p.n_tiles);
}

long long tiles_of(long long n) { return n / kTileRows + 1; }

}  // namespace

// Bytes of K13's state for n rows of A: the counters (16 bytes), then a
// 32-byte record a tile; zero between calls.
extern "C" long long f2_compact_keep_state_bytes(long long n) {
  return 16 + (long long)sizeof(Tile) * tiles_of(n);
}

// keep [n] bool; A's t, dt [n] f32, node, trans [n] i32, pts01, dirs
// [n, 3] f32, rid_src [n] i32 (sorted; padding rows n_rays); the B outputs
// [cap] (pts01, dirs [cap, 3]; idx int64), offsets [n_rays + 1] i32, counts
// [n_rays] f32, local [cap] i32, first [cap] bool; state:
// f2_compact_keep_state_bytes(n) bytes, zero (each launch leaves it so).
// 1 <= n, cap < 2^31.
extern "C" int f2_compact_keep(const void* keep, const void* t, const void* dt,
                               const void* node, const void* trans, const void* pts01,
                               const void* dirs, const void* rid_src, void* o_t, void* o_dt,
                               void* o_node, void* o_trans, void* o_pts01, void* o_dirs,
                               void* o_rid, void* o_ok, void* o_idx, void* o_offsets,
                               void* o_counts, void* o_local, void* o_first, void* state,
                               long long n, long long cap, int n_rays, void* stream) {
  if (n <= 0 || cap <= 0 || n_rays < 0 || n >= 0x7fffffffLL || cap >= 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const long long n_tiles = tiles_of(n);
  const long long blocks = n_tiles + (cap + kPadSlots - 1) / kPadSlots;
  Keep p{(const unsigned char*)keep, (const float*)t, (const float*)dt, (const int*)node,
         (const int*)trans, (const float*)pts01, (const float*)dirs, (const int*)rid_src,
         (float*)o_t, (float*)o_dt, (int*)o_node, (int*)o_trans, (float*)o_pts01,
         (float*)o_dirs, (int*)o_rid, (unsigned char*)o_ok, (long long*)o_idx,
         (int*)o_offsets, (float*)o_counts, (int*)o_local, (unsigned char*)o_first,
         (unsigned*)state, (Tile*)((char*)state + 16), n, cap, n_rays, (unsigned)n_tiles,
         (unsigned)blocks};
  compact_keep_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
