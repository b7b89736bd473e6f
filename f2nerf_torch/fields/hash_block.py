"""Block-anchored multi-resolution hash encoding (port of
``f2nerf_tpu/fields/hash_block.py``): kernels K2 (encode) and K3 (table
gradient scatter) with their plain PyTorch versions and autograd wiring.

Layout, as in the JAX package: each level's table is [n_blocks, 128] f32;
a row holds the 4x4x4 corner lattice of one 3x3x3-cell block (+1 halo) x
2 channels, lane = lx*32 + ly*8 + lz*2 + ch. A sample needs one row per
level: hash = (bx*pa ^ by*pb ^ bz*pc) & (n_blocks-1) on block coords with
per-(level, volume) primes and bias (Hash3DAnchored.cpp:38-69).

Index math (``_locate``) is the same in the plain version and the kernels:
x = p*scale + bias rounded per operation (no FMA), floor, block = floor//3,
local corner c = floor - 3*block, and per-axis tent weights
max(0, 1 - |lane - (c + a)|) as the JAX lane weights compute them.

The plain version runs for CPU tensors only; CUDA tensors launch the
kernels in csrc/hash_block.cu or raise.

The training step's grad pass has two table-gradient sources, B's cached
encodings and the edge samples' encode; ``hash_block_grad_pass`` makes
them one autograd node whose backward is one K3 call over both, into one
gradient that K3 stores whole.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..ops.gather import row_gather
from ..utils.spans import span
from .hash_encoding import (N_CHANNELS, N_LEVELS, _check_inputs, _in_order,
                            _random_primes, _runs, _scales, level_scales)

BLOCK_CELLS = 3
BLOCK_LAT = 4
LANES = BLOCK_LAT ** 3 * N_CHANNELS  # = 128
_M32 = 0xFFFFFFFF
K3_WINDOW = 64   # positions a K3 window (csrc/hash_block.cu kWindow): part of its order
K3_MAX_ROWS = 1 << 16   # rows a level K3's two 8-bit sort passes order


def n_blocks(log2_table_size: int) -> int:
    """Blocks per level."""
    return max(16, (1 << log2_table_size) >> 5)


def init_block_state(generator: torch.Generator, log2_table_size: int,
                     n_volumes: int, rand_bias: bool = True, device="cpu"):
    """(feat_tables [N_LEVELS, n_blocks, 128] f32, prim_pool [N_LEVELS,
    n_volumes, 3] int32 holding the uint32 primes, bias_pool f32) with the
    reference's init distribution (Hash3DAnchored.cpp:33,38-69)."""
    nb = n_blocks(log2_table_size)
    gdev = generator.device
    feat = (torch.rand((N_LEVELS, nb, LANES), generator=generator,
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


# ----------------------------------------------------------- plain version

def _locate(pts, prim_l, bias_l, scale: float, nb: int):
    """One level's row index [n] and per-axis (c [n] int64, w0, w1 [n]) for
    the two lattice points a sample interpolates between."""
    x = pts * scale + bias_l
    f = torch.floor(x)
    fi = f.to(torch.int64)
    b = torch.div(fi, BLOCK_CELLS, rounding_mode="floor")
    c = fi - BLOCK_CELLS * b
    t = c.to(torch.float32) + (x - f)
    bu = b & _M32
    p = prim_l.to(torch.int64)
    h = ((bu[:, 0] * p[:, 0]) & _M32) ^ ((bu[:, 1] * p[:, 1]) & _M32) \
        ^ ((bu[:, 2] * p[:, 2]) & _M32)
    row = h & (nb - 1)
    axes = []
    for ax in range(3):
        ca = c[:, ax]
        w = [torch.clamp(1.0 - torch.abs((ca + d).to(torch.float32) - t[:, ax]),
                         min=0.0) for d in range(2)]
        axes.append((ca, w))
    return row, axes


def _corners(axes):
    """(lane offset [n], weight [n]) for the 8 trilerp corners, weights
    multiplied x*y*z in that order."""
    (cx, wx), (cy, wy), (cz, wz) = axes
    for dx in range(2):
        for dy in range(2):
            for dz in range(2):
                lane = (cx + dx) * 32 + (cy + dy) * 8 + (cz + dz) * 2
                yield lane, wx[dx] * wy[dy] * wz[dz]


def hash_block_fwd_plain(feat, prim, bias, pts, vol, log2_table_size: int):
    """Plain PyTorch version of K2: [n, 32] features, level-major pairs."""
    nb = n_blocks(log2_table_size)
    scales = level_scales()
    vol = vol.long()
    flat = feat.reshape(-1)
    out = []
    for l in range(N_LEVELS):
        row, axes = _locate(pts, prim[l, vol], bias[l, vol], float(scales[l]), nb)
        base = (l * nb + row) * LANES
        acc0 = torch.zeros_like(pts[:, 0])
        acc1 = torch.zeros_like(pts[:, 0])
        for lane, w in _corners(axes):
            acc0 = acc0 + flat[base + lane] * w
            acc1 = acc1 + flat[base + lane + 1] * w
        out += [acc0, acc1]
    return torch.stack(out, dim=-1)


def _segments(x) -> list:
    return list(x) if isinstance(x, (tuple, list)) else [x]


def k3_list(g, prim, bias, pts, vol, nb: int, level: int):
    """One level's list in K3's order: the active samples (g != 0 at this
    level) sorted by row, in sample order within a row. Returns (rows,
    sample indices, per-axis (c, (w0, w1)) of those samples)."""
    row, axes = _locate(pts, prim[level, vol], bias[level, vol],
                        float(level_scales()[level]), nb)
    gl = g[:, 2 * level:2 * level + 2]
    act = ((gl[:, 0] != 0) | (gl[:, 1] != 0)).nonzero()[:, 0]
    order = act[torch.sort(row[act], stable=True).indices]
    return row[order], order, [(c[order], [w[order] for w in ws]) for c, ws in axes]


def k3_entries(g, prim, bias, pts, vol, nb: int, window: int = K3_WINDOW):
    """Every level's list (``k3_list``) in level order, as K3 sums it: per
    entry an int64 key (level row << 32 | window), its 16 lanes and the 16
    values g_ch * ((wx * wy) * wz) that it adds there."""
    dev = g.device
    keys, lanes, vals = [], [], []
    for l in range(N_LEVELS):
        row, idx, axes = k3_list(g, prim, bias, pts, vol, nb, l)
        pos = torch.arange(row.numel(), device=dev)
        keys.append(((l * nb + row) << 32) | (pos // window))
        lane, val = [], []
        for ln, w in _corners(axes):
            for ch in range(N_CHANNELS):
                lane.append(ln + ch)
                val.append(g[idx, N_CHANNELS * l + ch] * w)
        lanes.append(torch.stack(lane, 1))
        vals.append(torch.stack(val, 1))
    return torch.cat(keys), torch.cat(lanes), torch.cat(vals)


def hash_block_bwd_plain(g, prim, bias, pts, vol, log2_table_size: int,
                         table_shape, window: int = K3_WINDOW):
    """Plain PyTorch version of K3: table gradient [N_LEVELS, nb, 128],
    summed in K3's order (csrc/hash_block.cu): per level, the active pairs
    listed by row and within a row in sample order (``k3_list``) are cut
    into windows of ``window`` positions; a row's entries are added to +0
    one at a time within each window, and its windows' sums to +0 in
    window order. ``g``, ``pts``, ``vol`` may be sequences of segments, as
    for K3 (their concatenation, in order)."""
    g, pts = torch.cat(_segments(g)), torch.cat(_segments(pts))
    vol = torch.cat(_segments(vol)).long()
    nb = n_blocks(log2_table_size)
    dev = g.device
    key, lane, val = k3_entries(g, prim, bias, pts, vol, nb, window)
    d = torch.zeros((N_LEVELS * nb, LANES), dtype=torch.float32, device=dev)
    if key.numel():
        run, first = _runs(key)                  # a run: one row in one window
        part = torch.zeros(first.numel() * LANES, dtype=torch.float32, device=dev)
        flat = run[:, None] * LANES + lane       # each entry's 16 floats of its run
        # the k-th entries of all runs at once: no float is added twice
        for sel in _in_order(torch.arange(key.numel(), device=dev) - first[run]):
            f = flat[sel].reshape(-1)
            part[f] = part[f] + val[sel].reshape(-1)
        part = part.reshape(-1, LANES)
        prow = key[first] >> 32
        prun, pfirst = _runs(prow)
        for sel in _in_order(torch.arange(prow.numel(), device=dev) - pfirst[prun]):
            d[prow[sel]] = d[prow[sel]] + part[sel]
    return d.reshape(table_shape)


# ----------------------------------------------------------- kernel wrappers

def hash_block_fwd(feat, prim, bias, pts, vol, log2_table_size: int):
    """K2 encode: [n, 32] f32. CPU tensors take the plain version."""
    if pts.device.type == "cpu":
        return hash_block_fwd_plain(feat, prim, bias, pts, vol, log2_table_size)
    if pts.device.type != "cuda":
        raise ValueError(f"hash_block_fwd: unsupported device {pts.device}")
    nb = n_blocks(log2_table_size)
    if tuple(feat.shape) != (N_LEVELS, nb, LANES):
        raise ValueError(f"hash_block_fwd: table shape {tuple(feat.shape)}")
    pts, vol = pts.contiguous(), vol.contiguous()
    _check_inputs("hash_block_fwd", feat, prim, bias, pts, vol)
    if feat.data_ptr() % 16:
        raise ValueError("hash_block_fwd: the table must be 16-byte aligned "
                         "(the kernel loads corner pairs as float4)")
    n = pts.shape[0]
    out = torch.empty((n, N_LEVELS * N_CHANNELS), dtype=torch.float32,
                      device=pts.device)
    if n == 0:
        return out
    code = kernels.library().f2_hash_block_fwd(
        feat.data_ptr(), prim.data_ptr(), bias.data_ptr(),
        _scales(str(pts.device)).data_ptr(), pts.data_ptr(), vol.data_ptr(),
        out.data_ptr(), n, prim.shape[1], nb, kernels.stream_ptr(pts.device))
    kernels.check(code, "hash_block_fwd")
    hash_block_fwd.launches += 1
    return out


hash_block_fwd.launches = 0


def hash_block_bwd(g, prim, bias, pts, vol, log2_table_size: int, table_shape):
    """K3 table-gradient scatter: [N_LEVELS, nb, 128] f32, summed in the
    order that ``hash_block_bwd_plain`` states (the same bits on every
    run). ``g`` [n, 32], ``pts`` [n, 3] and ``vol`` [n] are one tensor
    each, or sequences of one or two segments (the grad pass's B and edge
    samples) scattered by one call into one gradient, which K3 stores
    whole (its rows no sample touches as zeros)."""
    gs, ps, vs = _segments(g), _segments(pts), _segments(vol)
    if ps[0].device.type == "cpu":
        return hash_block_bwd_plain(gs, prim, bias, ps, vs, log2_table_size,
                                    table_shape)
    if ps[0].device.type != "cuda":
        raise ValueError(f"hash_block_bwd: unsupported device {ps[0].device}")
    if not 1 <= len(gs) == len(ps) == len(vs) <= 2:
        raise ValueError(f"hash_block_bwd: one or two segments of g, pts, vol; "
                         f"got {len(gs)}, {len(ps)}, {len(vs)}")
    nb = n_blocks(log2_table_size)
    if tuple(table_shape) != (N_LEVELS, nb, LANES):
        raise ValueError(f"hash_block_bwd: table shape {tuple(table_shape)}")
    if nb > K3_MAX_ROWS:
        raise ValueError(f"hash_block_bwd: {nb} rows a level; K3 sorts rows of "
                         f"at most 16 bits (log2_table_size <= 21)")
    segs = []
    for gk, pk, vk in zip(gs, ps, vs):
        gk, pk, vk = gk.contiguous(), pk.contiguous(), vk.contiguous()
        if tuple(gk.shape) != (pk.shape[0], N_LEVELS * N_CHANNELS):
            raise ValueError(f"hash_block_bwd: grad shape {tuple(gk.shape)}")
        _check_inputs("hash_block_bwd", gk, prim, bias, pk, vk)
        if gk.data_ptr() % 8:          # read as float2: a row view may be off
            gk = gk.clone()
        segs.append((gk, pk, vk))      # held until the launch is queued
    ptrs = [(gk.data_ptr(), pk.data_ptr(), vk.data_ptr(), vk.shape[0])
            for gk, pk, vk in segs] + [(None, None, None, 0)]
    dev = ps[0].device
    n = sum(p[3] for p in ptrs)
    if n == 0:
        return torch.zeros(tuple(table_shape), dtype=torch.float32, device=dev)
    d = torch.empty(tuple(table_shape), dtype=torch.float32, device=dev)
    lib = kernels.library()
    scratch = torch.empty((lib.f2_hash_block_bwd_scratch_bytes(n, nb),),
                          dtype=torch.uint8, device=dev)
    code = lib.f2_hash_block_bwd(
        *ptrs[0], *ptrs[1], prim.data_ptr(), bias.data_ptr(),
        _scales(str(dev)).data_ptr(), d.data_ptr(), scratch.data_ptr(),
        prim.shape[1], nb, kernels.stream_ptr(dev))
    kernels.check(code, "hash_block_bwd")
    hash_block_bwd.launches += 1
    return d


hash_block_bwd.launches = 0


# ----------------------------------------------------------------- autograd

class _HashBlockEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat, prim, bias, pts, vol, log2_table_size):
        ctx.save_for_backward(prim, bias, pts, vol)
        ctx.meta = (log2_table_size, tuple(feat.shape))
        return hash_block_fwd(feat.detach(), prim, bias, pts.detach(), vol,
                              log2_table_size)

    @staticmethod
    def backward(ctx, g):
        with span("backward.field"):
            prim, bias, pts, vol = ctx.saved_tensors
            log2t, shape = ctx.meta
            d = hash_block_bwd(g, prim, bias, pts, vol, log2t, shape)
        return d, None, None, None, None, None


def hash_block_encode(feat_tables, prim_pool, bias_pool, points01, vol_idx,
                      log2_table_size: int):
    """Block-anchored multi-res hash lookup: [n, 32] f32. Gradient flows to
    the tables only (Hash3DAnchored.cu:82-155)."""
    return _HashBlockEncode.apply(feat_tables, prim_pool, bias_pool,
                                  points01, vol_idx, log2_table_size)


class _GradPass(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat, prim, bias, pts, vol, log2_table_size, cached_feat,
                src_idx, edge_pts, edge_vol):
        ctx.save_for_backward(prim, bias, pts, vol, edge_pts, edge_vol)
        ctx.meta = (log2_table_size, tuple(feat.shape))
        return (row_gather(cached_feat.detach(), src_idx),
                hash_block_fwd(feat.detach(), prim, bias, edge_pts.detach(),
                               edge_vol, log2_table_size))

    @staticmethod
    def backward(ctx, g, g_edge):
        with span("backward.field"):
            prim, bias, pts, vol, edge_pts, edge_vol = ctx.saved_tensors
            log2t, shape = ctx.meta
            d = hash_block_bwd((g, g_edge), prim, bias, (pts, edge_pts),
                               (vol, edge_vol), log2t, shape)
        return (d,) + (None,) * 9


def hash_block_grad_pass(feat_tables, prim_pool, bias_pool, points01, vol_idx,
                         log2_table_size: int, cached_feat, src_idx,
                         edge_points01, edge_vol_idx):
    """The training grad pass's two encodings as one autograd node:
    ``(cached_feat[src_idx], hash_block_encode(edge_points01, ...))``, where
    the cache already holds the encodings of ``points01`` (K4 and K2
    forwards). Its backward scatters both table gradients with one K3
    call into one gradient, where two autograd nodes would take two
    calls, two tables and autograd's add of them."""
    return _GradPass.apply(feat_tables, prim_pool, bias_pool, points01,
                           vol_idx, log2_table_size, cached_feat, src_idx,
                           edge_points01, edge_vol_idx)


def hash_block_gather_cached(feat_tables, prim_pool, bias_pool, points01,
                             vol_idx, log2_table_size: int, cached_feat,
                             src_idx):
    """Encode ``points01`` given that ``cached_feat[src_idx]`` already holds
    this exact encoding (the no-grad prefilter pass over the superset A
    buffer). Forward: one row gather of the cache (K4, ops/gather.py).
    Backward: the same table-gradient scatter as ``hash_block_encode``
    (K3). It is ``hash_block_grad_pass`` with no edge samples."""
    return hash_block_grad_pass(feat_tables, prim_pool, bias_pool, points01,
                                vol_idx, log2_table_size, cached_feat, src_idx,
                                points01[:0], vol_idx[:0])[0]
