"""Multi-resolution anchored hash-grid encoding, the Hash3DAnchored field
(port of ``f2nerf_tpu/fields/hash_encoding.py``; reference
Hash3DAnchored.{h,cpp,cu}): kernels K5 (encode) and K6 (pool-gradient
scatter) with their plain PyTorch versions and autograd wiring. The
constants and prime search here are shared with the HashBlock field.

  * N_LEVELS=16 levels, N_CHANNELS=2 features, per-level grid resolution
    2^3 .. 2^10 geometric (Hash3DAnchored.h:15-20, .cu:28).
  * One flat feature pool [(1 << log2_table_size) * N_LEVELS, 2] split
    evenly per level (Hash3DAnchored.cpp:71-78).
  * Per-(level, volume) random prime hash seeds in [2^28, 2^30) and random
    coordinate bias in [100, 1100) (Hash3DAnchored.cpp:38-69).
  * hash = (x*p_a ^ y*p_b ^ z*p_c) mod local_size in uint32, trilinear
    interpolation of the 8 corners (Hash3DAnchored.cu:44-79).

Index math, the same in the plain version and the kernels: x = p*scale +
bias rounded per operation (no FMA), f = floor(x), a = x - f, corner hash
h(x+1) = h(x) + p, weight (wx*wy)*wz, corners summed c = 0..7 from 0
(``hash_encoding.py:102-131,144-151`` of the JAX package). The uint32
products are taken in int64 and masked to 32 bits.

The plain versions run for CPU tensors only; CUDA tensors launch the
kernels in csrc/hash3d.cu or raise.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels
from ..utils.spans import span

N_CHANNELS = 2
N_LEVELS = 16
RES_BASE_POW_2 = 3.0
RES_FINE_POW_2 = 10.0
_M32 = 0xFFFFFFFF
# K6's order (csrc/hash3d.cu): samples a group of its list, records a
# chunk, and at most so many bits of a level's entry pick its bucket; K6
# sorts levels of at most 2^20 entries
K6_GROUP = 32
K6_CHUNK = 2048
K6_BUCKET_BITS = 10
K6_MAX_LOG2_ENTRIES = 20


def level_scales() -> np.ndarray:
    """Per-level grid resolution multiplier, f32 (Hash3DAnchored.cu:28)."""
    l = np.arange(N_LEVELS, dtype=np.float32)
    return np.exp2((RES_FINE_POW_2 - RES_BASE_POW_2) * l / (N_LEVELS - 1) + RES_BASE_POW_2)


def local_size(log2_table_size: int) -> int:
    """Entries per level: pool/N_LEVELS floored to a multiple of 16
    (Hash3DAnchored.cpp:71-78)."""
    pool = (1 << log2_table_size) * N_LEVELS
    return (pool // N_LEVELS) >> 4 << 4


def _small_primes(limit: int) -> np.ndarray:
    sieve = np.ones(limit, bool)
    sieve[:2] = False
    for p in range(2, int(limit ** 0.5) + 1):
        if sieve[p]:
            sieve[p * p::p] = False
    return np.nonzero(sieve)[0].astype(np.int64)


def _random_primes(seeds: np.ndarray) -> np.ndarray:
    """Advance each seed to the next prime (vectorized; init only).
    Candidates are < 2^30, so trial division by primes <= 2^15 is exact.
    Runs in chunks of 2048 seeds to bound the [seeds, primes] temporary,
    and tests only the candidates still composite."""
    primes = _small_primes(1 << 15)[1:]  # odd primes
    cand = (np.asarray(seeds, np.int64) | 1).copy()
    for lo in range(0, cand.shape[0], 2048):
        part = cand[lo:lo + 2048]
        active = np.arange(part.shape[0])
        for _ in range(200):
            composite = (part[active, None] % primes[None, :] == 0).any(axis=1)
            active = active[composite]
            if not active.size:
                break
            part[active] += 2
    return cand


def init_hash_state(generator: torch.Generator, log2_table_size: int,
                    n_volumes: int, rand_bias: bool = True, device="cpu"):
    """(feat_pool [pool, 2] f32 in U[-1e-4, -0.8e-4), prim_pool [N_LEVELS,
    n_volumes, 3] int32 holding the uint32 primes, bias_pool f32 in
    [100, 1100) or zeros) with the reference's init distribution
    (Hash3DAnchored.cpp:33,38-69)."""
    pool_size = (1 << log2_table_size) * N_LEVELS
    gdev = generator.device
    feat = (torch.rand((pool_size, N_CHANNELS), generator=generator,
                       device=gdev) * 0.2 - 1.0) * 1e-4
    seeds = torch.randint(1 << 28, 1 << 30, (N_LEVELS * n_volumes * 3,),
                          generator=generator, device=gdev)
    prim = _random_primes(seeds.cpu().numpy()).reshape(N_LEVELS, n_volumes, 3)
    if rand_bias:
        bias = torch.rand((N_LEVELS, n_volumes, 3), generator=generator,
                          device=gdev) * 1000.0 + 100.0
    else:
        bias = torch.zeros((N_LEVELS, n_volumes, 3))
    return (feat.to(device), torch.from_numpy(prim.astype(np.int32)).to(device),
            bias.to(device=device, dtype=torch.float32))


@functools.lru_cache(maxsize=None)
def _scales(device: str) -> torch.Tensor:
    return torch.from_numpy(level_scales()).to(device)


# ----------------------------------------------------------- plain version

def _corner_indices_weights(prim, bias, pts, vol, log2_table_size: int):
    """Yields (level, idx [n] int64, w [n] f32) for every (level, corner),
    corners in the order c = 0..7 (bit 2: x, bit 1: y, bit 0: z)."""
    lsz = local_size(log2_table_size)
    scales = level_scales()
    vol = vol.long()
    for lvl in range(N_LEVELS):
        p = prim[lvl, vol].long() & _M32
        x = pts * float(scales[lvl]) + bias[lvl, vol]
        f = torch.floor(x)
        a = x - f
        h0 = ((f.long() & _M32) * p) & _M32
        h1 = (h0 + p) & _M32
        for c in range(8):
            bits = ((c >> 2) & 1, (c >> 1) & 1, c & 1)
            h = [(h1 if b else h0)[:, ax] for ax, b in enumerate(bits)]
            idx = ((h[0] ^ h[1] ^ h[2]) % lsz) + lvl * lsz
            wa = [a[:, ax] if b else 1.0 - a[:, ax] for ax, b in enumerate(bits)]
            yield lvl, idx, (wa[0] * wa[1]) * wa[2]


def hash_encode_fwd_plain(feat_pool, prim, bias, pts, vol, log2_table_size: int):
    """Plain PyTorch version of K5: [n, 32] features, level-major pairs."""
    n = pts.shape[0]
    out = [torch.zeros((n, N_CHANNELS), dtype=torch.float32, device=pts.device)
           for _ in range(N_LEVELS)]
    for lvl, idx, w in _corner_indices_weights(prim, bias, pts, vol,
                                               log2_table_size):
        out[lvl] = out[lvl] + feat_pool[idx] * w[:, None]
    return torch.cat(out, dim=-1)


def _runs(key):
    """(run id of each entry, each run's first entry) of a sorted key."""
    new = torch.ones(key.shape, dtype=torch.bool, device=key.device)
    new[1:] = key[1:] != key[:-1]
    return torch.cumsum(new, 0) - 1, new.nonzero()[:, 0]


def _in_order(rank):
    """Index sets of the entries of rank 0, 1, ... (in entry order)."""
    order = torch.argsort(rank, stable=True)
    return torch.split(order, torch.bincount(rank).tolist())


def k6_buckets(log2_table_size: int) -> tuple[int, int]:
    """(hi, lo): K6 cuts a level's 2^(hi + lo) entries into 2^hi buckets of
    2^lo consecutive entries, hi = min(K6_BUCKET_BITS, log2 local_size)."""
    bits = local_size(log2_table_size).bit_length() - 1
    hi = min(K6_BUCKET_BITS, bits)
    return hi, bits - hi


def _cell_keys(prim, bias, pts, vol, lvl: int):
    """[n, 4] int64 (volume, h0 per axis) at level ``lvl``: two samples of
    one volume share all 8 corners where these are equal (h0 = floor *
    prime is a bijection of the floor in uint32)."""
    vol = vol.long()
    p = prim[lvl, vol].long() & _M32
    f = torch.floor(pts * float(level_scales()[lvl]) + bias[lvl, vol])
    return torch.cat([vol[:, None], ((f.long() & _M32) * p) & _M32], 1)


def _k6_runs(act, key, val):
    """K6's runs within each group of K6_GROUP consecutive samples: a run
    is a maximal stretch of active samples with one cell key. A sample's
    values [n, 8, 2] become the inclusive scan of its run's in doubling
    steps (x_i = x_(i-o) + x_i for o = 1, 2, 4, 8, 16 where sample i - o is
    in i's run, all from the step's inputs), so a run's last sample holds
    the run's value. Returns (last [n] bool: the sample ends a run, the
    scanned values [n, 8, 2])."""
    n, dev = act.numel(), act.device
    groups = -(-n // K6_GROUP)
    lane = torch.arange(K6_GROUP, device=dev)
    a = torch.zeros(groups * K6_GROUP, dtype=torch.bool, device=dev)
    a[:n] = act
    a = a.reshape(groups, K6_GROUP)
    k = torch.zeros((groups * K6_GROUP, key.shape[1]), dtype=key.dtype, device=dev)
    k[:n] = key
    k = k.reshape(groups, K6_GROUP, key.shape[1])
    x = torch.zeros((groups * K6_GROUP,) + tuple(val.shape[1:]), dtype=val.dtype, device=dev)
    x[:n] = val
    x = x.reshape((groups, K6_GROUP) + tuple(val.shape[1:]))
    same = torch.zeros_like(a)
    same[:, 1:] = a[:, 1:] & a[:, :-1] & (k[:, 1:] == k[:, :-1]).all(-1)
    start = torch.where(a & ~same, lane, -1).cummax(1).values
    o = 1
    while o < K6_GROUP:
        y = torch.zeros_like(x)
        y[:, o:] = x[:, :-o]
        x = torch.where((a & (lane - o >= start))[:, :, None, None], y + x, x)
        o *= 2
    last = a.clone()
    last[:, :-1] &= ~same[:, 1:]
    return last.reshape(-1)[:n], x.reshape((groups * K6_GROUP,) + tuple(val.shape[1:]))[:n]


def k6_records(g, prim, bias, pts, vol, log2_table_size: int):
    """Every level's records in K6's list order: level by level, the
    samples in groups of K6_GROUP consecutive ones (0-31, 32-63, ...),
    within a group corner by corner (c = 0..7), within a corner the
    group's runs (``_k6_runs``: active samples, g != 0 at that level, of
    one cell) in sample order, each one record: its cell's corner c and
    its samples' values (g_0 * w_c, g_1 * w_c) summed as ``_k6_runs``
    states. Returns (pool index [m] int64, value [m, 2] f32)."""
    idx = [[] for _ in range(N_LEVELS)]
    w = [[] for _ in range(N_LEVELS)]
    for lvl, i, wc in _corner_indices_weights(prim, bias, pts, vol, log2_table_size):
        idx[lvl].append(i)
        w[lvl].append(wc)
    corner = torch.arange(8, device=g.device)
    entries, values = [], []
    for lvl in range(N_LEVELS):
        gl = g[:, N_CHANNELS * lvl:N_CHANNELS * lvl + N_CHANNELS]
        act = (gl[:, 0] != 0) | (gl[:, 1] != 0)
        last, val = _k6_runs(act, _cell_keys(prim, bias, pts, vol, lvl),
                             gl[:, None, :] * torch.stack(w[lvl], 1)[:, :, None])
        sel = last.nonzero()[:, 0]
        pos = ((sel // K6_GROUP * 8)[:, None] + corner[None, :]) * K6_GROUP \
            + (sel % K6_GROUP)[:, None]
        order = torch.argsort(pos.reshape(-1))
        entries.append(torch.stack(idx[lvl], 1)[sel].reshape(-1)[order])
        values.append(val[sel].reshape(-1, N_CHANNELS)[order])
    return torch.cat(entries), torch.cat(values)


def hash_encode_bwd_plain(g, prim, bias, pts, vol, log2_table_size: int,
                          pool_size: int, chunk: int = K6_CHUNK):
    """Plain PyTorch version of K6: the pool gradient [pool_size, 2],
    summed in K6's order (csrc/hash3d.cu): per level the records in list
    order (``k6_records``) are bucketed by entry (``k6_buckets``: 2^lo
    consecutive entries a bucket), each bucket's list cut into chunks of
    ``chunk`` positions; an entry is the sum from +0, in chunk order, of
    its records in each chunk added to +0 one at a time in list order."""
    entry, val = k6_records(g, prim, bias, pts, vol, log2_table_size)
    d = torch.zeros((pool_size, N_CHANNELS), dtype=torch.float32, device=g.device)
    m = entry.numel()
    if not m:
        return d
    _, lo = k6_buckets(log2_table_size)
    pos = torch.arange(m, device=g.device)
    # each record's position in its bucket's list: the bucket (level
    # included) sorted stably, less the bucket's first position there
    bucket = entry >> lo
    by_bucket = torch.sort(bucket, stable=True).indices
    run, first = _runs(bucket[by_bucket])
    in_bucket = torch.empty_like(pos)
    in_bucket[by_bucket] = pos - first[run]
    key = (entry << 32) | (in_bucket // chunk)
    order = torch.sort(entry, stable=True).indices
    key, val = key[order], val[order]
    run, first = _runs(key)                      # a run: one entry in one chunk
    part = torch.zeros((first.numel(), N_CHANNELS), dtype=torch.float32, device=g.device)
    # the k-th records of all runs at once: no run is added to twice
    for sel in _in_order(pos - first[run]):
        part[run[sel]] = part[run[sel]] + val[sel]
    prow = key[first] >> 32
    prun, pfirst = _runs(prow)
    for sel in _in_order(torch.arange(prow.numel(), device=g.device) - pfirst[prun]):
        d[prow[sel]] = d[prow[sel]] + part[sel]
    return d


# ----------------------------------------------------------- kernel wrappers

def _check_inputs(name, feat_or_g, prim, bias, pts, vol):
    if prim.dtype != torch.int32 or vol.dtype != torch.int32:
        raise ValueError(f"{name}: prim_pool and vol_idx must be int32")
    for t in (feat_or_g, bias, pts):
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32, got {t.dtype}")
    if pts.dim() != 2 or pts.shape[1] != 3 or vol.shape != pts.shape[:1]:
        raise ValueError(f"{name}: pts [n,3] / vol [n] mismatch "
                         f"{tuple(pts.shape)} {tuple(vol.shape)}")
    if prim.dim() != 3 or prim.shape[0] != N_LEVELS or bias.shape != prim.shape:
        raise ValueError(f"{name}: prim/bias must be [{N_LEVELS}, n_volumes, 3]")
    kernels.require_cuda(name, feat_or_g, prim, bias, pts, vol)


def hash_encode_fwd(feat_pool, prim, bias, pts, vol, log2_table_size: int):
    """K5 encode: [n, 32] f32. CPU tensors take the plain version."""
    if pts.device.type == "cpu":
        return hash_encode_fwd_plain(feat_pool, prim, bias, pts, vol,
                                     log2_table_size)
    if pts.device.type != "cuda":
        raise ValueError(f"hash_encode_fwd: unsupported device {pts.device}")
    lsz = local_size(log2_table_size)
    if tuple(feat_pool.shape) != (lsz * N_LEVELS, N_CHANNELS):
        raise ValueError(f"hash_encode_fwd: pool shape {tuple(feat_pool.shape)}")
    pts, vol = pts.contiguous(), vol.contiguous()
    _check_inputs("hash_encode_fwd", feat_pool, prim, bias, pts, vol)
    if feat_pool.data_ptr() % 8:
        raise ValueError("hash_encode_fwd: the pool must be 8-byte aligned "
                         "(the kernel loads a corner's two channels as float2)")
    n = pts.shape[0]
    out = torch.empty((n, N_LEVELS * N_CHANNELS), dtype=torch.float32,
                      device=pts.device)
    if n == 0:
        return out
    code = kernels.library().f2_hash3d_fwd(
        feat_pool.data_ptr(), prim.data_ptr(), bias.data_ptr(),
        _scales(str(pts.device)).data_ptr(), pts.data_ptr(), vol.data_ptr(),
        out.data_ptr(), n, prim.shape[1], lsz, kernels.stream_ptr(pts.device))
    kernels.check(code, "hash_encode_fwd")
    hash_encode_fwd.launches += 1
    return out


hash_encode_fwd.launches = 0


def hash_encode_bwd(g, prim, bias, pts, vol, log2_table_size: int,
                    pool_size: int):
    """K6 pool-gradient scatter: [pool_size, 2] f32, summed in the order
    that ``hash_encode_bwd_plain`` states (the same bits on every run),
    every entry stored once. The arguments are checked on every device;
    CPU tensors take the plain version."""
    lsz = local_size(log2_table_size)
    if pool_size != lsz * N_LEVELS:
        raise ValueError(f"hash_encode_bwd: pool size {pool_size}")
    if log2_table_size > K6_MAX_LOG2_ENTRIES:
        raise ValueError(f"hash_encode_bwd: log2_table_size {log2_table_size}; K6 sorts "
                         f"levels of at most 2^{K6_MAX_LOG2_ENTRIES} entries")
    g, pts, vol = g.contiguous(), pts.contiguous(), vol.contiguous()
    if tuple(g.shape) != (pts.shape[0], N_LEVELS * N_CHANNELS):
        raise ValueError(f"hash_encode_bwd: grad shape {tuple(g.shape)}")
    _check_inputs("hash_encode_bwd", g, prim, bias, pts, vol)
    n = pts.shape[0]
    if 8 * n >= 1 << 31:
        raise ValueError(f"hash_encode_bwd: {n} samples; K6 indexes a level's 8n "
                         f"records in int32")
    if pts.device.type == "cpu":
        return hash_encode_bwd_plain(g, prim, bias, pts, vol, log2_table_size,
                                     pool_size)
    if pts.device.type != "cuda":
        raise ValueError(f"hash_encode_bwd: unsupported device {pts.device}")
    if n == 0:
        return torch.zeros((pool_size, N_CHANNELS), dtype=torch.float32,
                           device=pts.device)
    if g.data_ptr() % 8:               # read as float2: a row view may be off
        g = g.clone()
    d = torch.empty((pool_size, N_CHANNELS), dtype=torch.float32, device=pts.device)
    lib = kernels.library()
    scratch = torch.empty((lib.f2_hash3d_bwd_scratch_bytes(n),), dtype=torch.uint8,
                          device=pts.device)
    code = lib.f2_hash3d_bwd(
        g.data_ptr(), prim.data_ptr(), bias.data_ptr(),
        _scales(str(pts.device)).data_ptr(), pts.data_ptr(), vol.data_ptr(),
        d.data_ptr(), scratch.data_ptr(), n, prim.shape[1], lsz,
        kernels.stream_ptr(pts.device))
    kernels.check(code, "hash_encode_bwd")
    hash_encode_bwd.launches += 1
    return d


hash_encode_bwd.launches = 0


# ----------------------------------------------------------------- autograd

class _HashEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat_pool, prim, bias, pts, vol, log2_table_size):
        ctx.save_for_backward(prim, bias, pts, vol)
        ctx.meta = (log2_table_size, feat_pool.shape[0])
        return hash_encode_fwd(feat_pool.detach(), prim, bias, pts.detach(),
                               vol, log2_table_size)

    @staticmethod
    def backward(ctx, g):
        with span("backward.field"):
            prim, bias, pts, vol = ctx.saved_tensors
            log2t, pool_size = ctx.meta
            d = hash_encode_bwd(g, prim, bias, pts, vol, log2t, pool_size)
        return d, None, None, None, None, None


def hash_encode(feat_pool, prim_pool, bias_pool, points01, vol_idx,
                log2_table_size: int):
    """Anchored multi-res hash lookup: [n, N_LEVELS*N_CHANNELS] f32.

    points01: [n, 3] warp coords mapped from [-1,1] to [0,1]
    (Hash3DAnchored.cpp:93). vol_idx: [n] int32 anchor (octree-leaf warp
    index). Gradient flows to the feature pool only, as in the reference
    kernel (Hash3DAnchored.cu:82-155)."""
    return _HashEncode.apply(feat_pool, prim_pool, bias_pool, points01,
                             vol_idx, log2_table_size)
