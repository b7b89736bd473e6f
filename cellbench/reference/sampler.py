"""Frozen plain copy of the port's ``sampler.device``: every kernel dispatch replaced by the plain version it routes CPU tensors to, so this module runs plain torch on any device. It imports nothing of the port; cellbench's reference runs it.

Device-side octree sampling: traversal, ray marching, warping, occupancy
(port of ``f2nerf_tpu/sampler/device.py``).

  * ``traverse`` — the rope traversal (FindRayOctreeIntersectionKernel,
    PersSampler.cu:53-152, redesigned): kernel K8 (csrc/traverse.cu, one
    thread a ray over the packed node records, the tree staged in shared
    memory when it fits) on the card, ``traverse_plain`` (a lockstep torch
    loop over all rays, one host sync an iteration) on the CPU. Both keep the
    JAX package's ulp-floored eps, the no-progress and skip-stall
    escalations and ``trunc`` exactly, and return the loop's iteration
    count as a 0-d device tensor.
  * ``ray_march_parallel`` — entry-point warp Jacobian per (ray, hit),
    jittered-grid samples per hit: kernel K9 (csrc/march_parallel.cu,
    threads a ray sized to the hit cap) on the card, ``ray_march_parallel_plain`` on the CPU,
    where the JAX slot->hit indicator sum over [R, H, S] becomes
    ``searchsorted`` on the per-ray hit ends plus a gather (exactly the
    same values: one hit contributes to each slot).
  * ``ray_march`` — the lockstep EMIT/ADVANCE marcher (RayMarchKernel,
    PersSampler.cu:189-314): kernel K7 (csrc/ray_march.cu, one thread per
    ray) on the card, ``ray_march_plain`` (a torch loop over the batch) on
    the CPU.
  * ``sample_edges`` — the TV loss's edge samples warped into both
    neighbour frames: kernel K12 (csrc/warp.cu, the perspective warp shared
    with the renderer's ``compact_a_warp``) on the card,
    ``sample_edges_plain`` (``apply_warp``'s torch ops) on the CPU.
  * occupancy votes (MarkVistNodeKernel, PersSampler.cu:475-534) and their
    fold into the hysteresis counters: kernel K14 (csrc/occupancy.cu, one
    cooperative launch a ray-sorted buffer for the votes, a thread a node
    for the fold) on the card, ``compute_occupancy_adders_plain`` /
    ``apply_occupancy_adders_plain`` (scatter-max / index_add) on the CPU.

The tree lives on the device as a dataclass of fixed-capacity padded
tensors (``DeviceTree``). Index tensors are int32 as in the JAX package
and widened to int64 where torch indexes with them. ``node_rec`` packs
each node's center, side, children, ropes and is_leaf into one 80-byte
row for K8 (``pack_node_records``); it is built with the tree and never
changes after (``trans_idx``, which culling rewrites, stays out of it)."""
from __future__ import annotations
import dataclasses
from dataclasses import dataclass
import numpy as np
import torch
N_PROS = 12
OCC_WEIGHT_BASE = 512
ABS_WEIGHT_THRES = 0.01
REL_WEIGHT_THRES = 0.1
OCC_ALPHA_BASE = 32
ABS_ALPHA_THRES = 0.02
REL_ALPHA_THRES = 0.1

@dataclass
class DeviceTree:
    """Padded SoA octree + warp table + edge pool on the device."""
    center: torch.Tensor
    side: torch.Tensor
    child: torch.Tensor
    is_leaf: torch.Tensor
    trans_idx: torch.Tensor
    rope: torch.Tensor
    node_rec: torch.Tensor
    weight_stats: torch.Tensor
    alpha_stats: torch.Tensor
    visit_cnt: torch.Tensor
    w2xz: torch.Tensor
    weight: torch.Tensor
    t_center: torch.Tensor
    t_dis: torch.Tensor
    edge_t: torch.Tensor
    edge_center: torch.Tensor
    edge_dir0: torch.Tensor
    edge_dir1: torch.Tensor
    n_edges: int
    n_nodes: int
NODE_REC_W = 20

def pack_node_records(center: np.ndarray, side: np.ndarray, child: np.ndarray, rope: np.ndarray, is_leaf: np.ndarray) -> np.ndarray:
    """K8's node records [N, NODE_REC_W] int32 from the padded node arrays
    (the same rows as the JAX package's traversal pack, ``_pack_nodes``,
    without trans_idx and the children's boxes)."""
    rec = np.zeros((center.shape[0], NODE_REC_W), np.int32)
    rec[:, 0:3] = np.ascontiguousarray(center, np.float32).view(np.int32)
    rec[:, 3] = np.ascontiguousarray(side, np.float32).view(np.int32)
    rec[:, 4:12] = child
    rec[:, 12:18] = rope
    rec[:, 18] = is_leaf
    return rec

def _slab(center, side, o, d, big=1000000.0):
    """Ray-AABB intersection, matching GetIntersection (PersSampler.cu:21-51)
    including the |d| < 1e-6 inside/outside convention. Returns (near, far)."""
    hf = side[..., None] * 0.5
    lo = center - hf
    hi = center + hf
    degenerate = d.abs() < 1e-06
    safe_d = torch.where(degenerate, torch.ones_like(d), d)
    t0 = (lo - o) / safe_d
    t1 = (hi - o) / safe_d
    tn = torch.minimum(t0, t1)
    tf = torch.maximum(t0, t1)
    inside = (o > lo) & (o < hi)
    big_t = torch.full_like(tn, big)
    tn = torch.where(degenerate, torch.where(inside, -big_t, big_t), tn)
    tf = torch.where(degenerate, torch.where(inside, big_t, -big_t), tf)
    return (tn.amax(dim=-1), tf.amin(dim=-1))

def norm3(v: torch.Tensor) -> torch.Tensor:
    """|v| over the last axis of size 3, as elementwise ops (bitwise equal
    on the CPU and the card, unlike a reduction)."""
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2])

def _warp_rows(tree: DeviceTree, trans_idx: torch.Tensor):
    """Per-point warp table rows, as 96 and 36 column vectors [n]."""
    idx = trans_idx.long()
    m = tree.w2xz[idx].t()
    w = tree.weight[idx].t()
    return (m, w)

def apply_warp(tree: DeviceTree, trans_idx: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Warp world points [n, 3] through per-point leaf warps
    (QueryFrameTransform, PersSampler.cu:155-168)."""
    m, w = _warp_rows(tree, trans_idx)
    x, y, z = (pts[:, 0], pts[:, 1], pts[:, 2])
    out = [0.0, 0.0, 0.0]
    for k in range(N_PROS):
        a = m[8 * k] * x + m[8 * k + 1] * y + m[8 * k + 2] * z + m[8 * k + 3]
        b = m[8 * k + 4] * x + m[8 * k + 5] * y + m[8 * k + 6] * z + m[8 * k + 7]
        v = a / b
        for ax in range(3):
            out[ax] = out[ax] + w[12 * ax + k] * v
    return torch.stack(out, dim=-1)

def warp_jac_dir(m, w, pts, dirs):
    """|J(x) @ d| per point, J the warp Jacobian (QueryFrameTransformJac,
    PersSampler.cu:170-187). m: [96, n], w: [36, n] (``_warp_rows``)."""
    x, y, z = (pts[:, 0], pts[:, 1], pts[:, 2])
    dx, dy, dz = (dirs[:, 0], dirs[:, 1], dirs[:, 2])
    jd = [0.0, 0.0, 0.0]
    for k in range(N_PROS):
        a = m[8 * k] * x + m[8 * k + 1] * y + m[8 * k + 2] * z + m[8 * k + 3]
        b = m[8 * k + 4] * x + m[8 * k + 5] * y + m[8 * k + 6] * z + m[8 * k + 7]
        r0d = m[8 * k] * dx + m[8 * k + 1] * dy + m[8 * k + 2] * dz
        r1d = m[8 * k + 4] * dx + m[8 * k + 5] * dy + m[8 * k + 6] * dz
        dvd = r0d / b - a / (b * b) * r1d
        for ax in range(3):
            jd[ax] = jd[ax] + w[12 * ax + k] * dvd
    return torch.sqrt(jd[0] ** 2 + jd[1] ** 2 + jd[2] ** 2)

def traverse_plain(tree: DeviceTree, rays_o: torch.Tensor, rays_d: torch.Tensor, near: torch.Tensor, far: torch.Tensor, max_hits: int, max_iters: int=4096):
    """Plain PyTorch version of K8: the lockstep loop over the whole batch
    (JAX ``traverse``, device.py:231-432), one host sync an iteration to
    test whether every ray is done. Returns what ``traverse`` returns.
    ``traverse_plain.last_iters`` keeps each ray's iterations of the last
    call, [R] int32 (K8's chain bound); their max is ``n_iters``."""
    R = rays_o.shape[0]
    dev = rays_o.device
    H = max_hits
    root_side = tree.side[0]
    eps0 = root_side * 1e-06
    t_root_n, t_root_f = _slab(tree.center[0], root_side, rays_o, rays_d)
    t = torch.maximum(t_root_n, near)
    t_end = torch.minimum(t_root_f, far)
    u = torch.zeros((R,), dtype=torch.int64, device=dev)
    cnt = torch.zeros((R,), dtype=torch.int32, device=dev)
    done = t >= t_end
    eps = torch.maximum(eps0.expand(R), t.abs() * 5e-07)
    last = torch.full((R,), -1, dtype=torch.int64, device=dev)
    trunc = torch.zeros((R,), dtype=torch.bool, device=dev)
    hit_idx = torch.full((R, H), -1, dtype=torch.int32, device=dev)
    hit_near = torch.zeros((R, H), dtype=torch.float32, device=dev)
    hit_far = torch.zeros((R, H), dtype=torch.float32, device=dev)
    rows = torch.arange(R, device=dev)
    degenerate = rays_d.abs() < 1e-06
    safe_d = torch.where(degenerate, torch.ones_like(rays_d), rays_d)
    sgn = torch.sign(safe_d)
    iters = torch.zeros((R,), dtype=torch.int32, device=dev)
    it = 0
    while it < max_iters and (not bool(done.all())):
        it += 1
        iters += (~done).to(torch.int32)
        p = rays_o + rays_d * (t + eps)[:, None]
        c_u = tree.center[u]
        s_u = tree.side[u]
        leaf_u = tree.is_leaf[u]
        tr_u = tree.trans_idx[u]
        outside_u = ((p - c_u).abs().amax(dim=-1) > s_u * 0.5) & (u != 0)
        n_l, f_l = _slab(c_u, s_u, rays_o, rays_d)
        n_l = torch.maximum(n_l, near)
        f_l = torch.minimum(f_l, far)
        leaf_progress = f_l > t
        emit = ~done & ~outside_u & leaf_u & (tr_u >= 0) & (n_l < f_l) & leaf_progress & (cnt < H) & (u != last)
        slot = torch.clamp(cnt, max=H - 1).long()[:, None]
        for buf, val in ((hit_idx, u.to(torch.int32)), (hit_near, n_l), (hit_far, f_l)):
            buf.scatter_(1, slot, torch.where(emit, val, buf.gather(1, slot)[:, 0])[:, None])
        cnt = cnt + emit.to(torch.int32)
        t_ax = (c_u + sgn * s_u[:, None] * 0.5 - rays_o) / safe_d
        t_ax = torch.where(degenerate, torch.full_like(t_ax, 1000000000.0), t_ax)
        face_ax = torch.argmin(t_ax, dim=-1)
        face = face_ax * 2 + (rays_d[rows, face_ax] > 0).to(torch.int64)
        rope_u = tree.rope[u, face].to(torch.int64)
        leaf_t = torch.maximum(f_l, t)
        leaf_eps = torch.maximum(torch.maximum(s_u * 0.0001, eps0), leaf_t.abs() * 5e-07)
        leaf_eps = torch.where(leaf_progress, leaf_eps, torch.maximum(leaf_eps, eps * 4.0))
        ge = (p >= c_u).to(torch.int64)
        st = ge[:, 0] << 2 | ge[:, 1] << 1 | ge[:, 2]
        c = tree.child[u, st].to(torch.int64)
        c_safe = c.clamp(min=0)
        c_center = tree.center[c_safe]
        c_side = tree.side[c_safe]
        inside_c = (c >= 0) & ((p - c_center).abs().amax(dim=-1) <= c_side * 0.5)
        oct_center = c_u + (ge.to(torch.float32) - 0.5) * s_u[:, None] * 0.5
        oct_side = s_u * 0.5
        _, f_o = _slab(oct_center, oct_side, rays_o, rays_d)
        n_c, f_c = _slab(c_center, c_side, rays_o, rays_d)
        hit_ahead = (c >= 0) & (n_c > t) & (n_c < f_o) & (n_c < f_c)
        skip_t = torch.where(hit_ahead, n_c, f_o)
        skip_t = torch.maximum(skip_t, t)
        skip_eps = torch.maximum(torch.maximum(torch.where(hit_ahead, c_side, oct_side) * 0.0001, eps0), skip_t.abs() * 5e-07)
        new_t = torch.where(done | outside_u, t, torch.where(leaf_u, leaf_t, torch.where(inside_c, t, skip_t)))
        new_u = torch.where(done, u, torch.where(outside_u, torch.zeros_like(u), torch.where(leaf_u, rope_u.clamp(min=0), torch.where(inside_c, c, u))))
        new_eps = torch.where(done | outside_u | inside_c, eps, torch.where(leaf_u, leaf_eps, skip_eps))
        skip_stall = ~done & ~outside_u & ~leaf_u & ~inside_c & (new_t <= t)
        new_eps = torch.where(skip_stall, torch.maximum(new_eps, eps * 4.0), new_eps)
        rope_end = ~done & ~outside_u & leaf_u & (rope_u < 0)
        reached_end = ~inside_c & ~outside_u & (new_t + new_eps >= t_end)
        cap_hit = cnt >= H
        new_done = done | rope_end | reached_end | cap_hit
        trunc = trunc | ~done & cap_hit & ~reached_end & ~rope_end
        last = torch.where(emit, u, last)
        t, u, eps, done = (new_t, new_u, new_eps, new_done)
    trunc = trunc | ~done
    traverse_plain.last_iters = iters
    return (hit_idx, hit_near, hit_far, cnt, trunc, torch.tensor(it, dtype=torch.int32, device=dev))
TRAVERSE_NODE_BYTES = 84
TRAVERSE_SMEM_NODES = 232448 // TRAVERSE_NODE_BYTES

def traverse(tree: DeviceTree, rays_o: torch.Tensor, rays_d: torch.Tensor, near: torch.Tensor, far: torch.Tensor, max_hits: int, max_iters: int=4096):
    """Ordered leaf intersections per ray via rope traversal.

    Returns (hit_idx [R, H] i32, hit_near [R, H], hit_far [R, H],
    n_hits [R] i32, trunc [R] bool, n_iters [] i32). Ordering along the ray
    is the reference's direction-ordered DFS order (leaf cells are
    disjoint). Internal nodes point-locate one level down per iteration; on
    leaf exit the ray follows the face-neighbor rope; corner exits that
    land in a diagonal neighbor bounce to a root restart.

    ``trunc`` marks rays whose traversal was cut short (hit buffer full or
    max_iters reached). ``n_iters`` is the loop's iteration count (the
    most iterations any ray took), a 0-d device tensor: no caller has to
    sync. CPU tensors take the plain version; CUDA tensors launch K8 over
    ``tree.node_rec`` and ``tree.trans_idx`` (``traverse.last_iters``:
    each ray's iterations, [R] int32)."""
    return traverse_plain(tree, rays_o, rays_d, near, far, max_hits, max_iters)

def _first_oct(hit_near, n_hits):
    """Distance to each ray's first hit (1e9 for a ray with none)."""
    return torch.where(n_hits > 0, hit_near[:, 0], torch.full_like(hit_near[:, 0], 1000000000.0))

def ray_march_parallel_plain(tree: DeviceTree, rays_o: torch.Tensor, rays_d: torch.Tensor, hit_idx, hit_near, hit_far, n_hits, jitter: torch.Tensor, fineness, sample_l: float, scale_by_dis: bool, max_s: int):
    """Plain PyTorch version of K9 (JAX ``ray_march_parallel``,
    device.py:547-646): ``repeat_interleave`` over the hits, a
    ``searchsorted`` for each slot's hit and gathers. Returns what
    ``ray_march_parallel`` returns."""
    R, H = hit_idx.shape
    dev = rays_o.device
    first_oct = _first_oct(hit_near, n_hits)
    valid_hit = torch.arange(H, device=dev)[None, :] < n_hits[:, None]
    node_c = hit_idx.clamp(min=0).long()
    tr = tree.trans_idx[node_c.reshape(-1)].clamp(min=0)
    o_rep = rays_o.repeat_interleave(H, dim=0)
    d_rep = rays_d.repeat_interleave(H, dim=0)
    xyz = o_rep + d_rep * hit_near.reshape(-1)[:, None]
    m_rows, w_rows = _warp_rows(tree, tr)
    pnorm = warp_jac_dir(m_rows, w_rows, xyz, d_rep) + 1e-06
    dt_warp = sample_l * fineness * torch.ones_like(pnorm)
    if scale_by_dis:
        trl = tr.long()
        radius = norm3(o_rep - tree.t_center[trl]) / tree.t_dis[trl]
        dt_warp = dt_warp * torch.clamp(radius, min=1.0)
    step = (dt_warp / pnorm).reshape(R, H)
    dt_warp = dt_warp.reshape(R, H)
    good = valid_hit & torch.isfinite(step) & (step > 0)
    step = torch.where(good, step, torch.zeros_like(step))
    dt_warp = torch.where(good, dt_warp, torch.zeros_like(dt_warp))
    span = torch.clamp(hit_far - hit_near, min=0.0)
    n_steps = torch.where(good, torch.floor(span / torch.clamp(step, min=1e-12)), torch.zeros_like(span))
    n_steps = torch.clamp(n_steps, max=float(max_s)).to(torch.int64)
    ends = torch.cumsum(n_steps, dim=1)
    starts = ends - n_steps
    total = ends[:, -1]
    n_samples = torch.clamp(total, max=max_s)
    slots = torch.arange(max_s, device=dev)
    h_of = torch.searchsorted(ends.contiguous(), slots[None, :].expand(R, max_s).contiguous(), right=True)
    h_c = h_of.clamp(max=H - 1)
    valid_s = slots[None, :] < n_samples[:, None]

    def slot_field(f):
        return torch.gather(f, 1, h_c)
    near_s = slot_field(hit_near)
    step_s = slot_field(step)
    start_s = slot_field(starts).to(torch.float32)
    dt_s = slot_field(dt_warp)
    node_s = slot_field(hit_idx)
    k_s = slots[None, :].to(torch.float32) - start_s
    out_t = near_s + (k_s + jitter) * step_s
    out_t = torch.where(valid_s, out_t, torch.zeros_like(out_t))
    out_dt = torch.where(valid_s, dt_s, torch.zeros_like(dt_s))
    out_node = torch.where(valid_s, node_s, torch.full_like(node_s, -1))
    return (out_t, out_dt, out_node, n_samples.to(torch.int32), first_oct)
MARCH_RAY_THREADS = 128
MARCH_BLOCK_THREADS = 256
MARCH_RAYS_PER_BLOCK = 4

def ray_march_parallel(tree: DeviceTree, rays_o: torch.Tensor, rays_d: torch.Tensor, hit_idx, hit_near, hit_far, n_hits, jitter: torch.Tensor, fineness, sample_l: float, scale_by_dis: bool, max_s: int):
    """Jittered-grid marcher, no sequential loop:

      per hit h:  step_h = sample_l * fineness / |J(entry) d|
                  n_h    = floor((far_h - near_h) / step_h)
      sample k of hit h:  t = near_h + (k + u) * step_h,  u in (0, 1]

    jitter: [R, max_s] in (0, 1] (all-ones for eval); fineness: a 0-d
    tensor (read on the device: no sync). Returns dense buffers out_t
    [R, max_s], out_dt [R, max_s] (warp-space dt), out_node [R, max_s]
    i32, n_samples [R] i32, first_oct_dis [R]. CPU tensors take the plain
    version; CUDA tensors launch K9 (``ray_march_parallel_geometry``:
    threads a ray sized to H, MARCH_RAYS_PER_BLOCK rays a block)."""
    return ray_march_parallel_plain(tree, rays_o, rays_d, hit_idx, hit_near, hit_far, n_hits, jitter, fineness, sample_l, scale_by_dis, max_s)

def ray_march_plain(tree: DeviceTree, rays_o: torch.Tensor, rays_d: torch.Tensor, hit_idx, hit_near, hit_far, n_hits, noise: torch.Tensor, sample_l: float, scale_by_dis: bool, max_s: int, max_iters: int=0):
    """Plain PyTorch version of K7: the lockstep state machine over the
    whole batch (JAX ``ray_march``, device.py:436-544), one iteration a
    loop pass, at most ``max_iters`` (default max_s + H + 8) passes. It
    stops early once every ray is done: a done row no longer changes.
    ``ray_march_plain.last_iters`` keeps each ray's EMIT and ADVANCE
    iterations of the last call, [R, 2] int32 (K7's chain bound)."""
    R, H = hit_idx.shape
    dev = rays_o.device
    if max_iters == 0:
        max_iters = max_s + H + 8
    rows = torch.arange(R, device=dev)
    ptr = torch.zeros((R,), dtype=torch.int64, device=dev)
    t = hit_near[:, 0].clone()
    exp_step = torch.ones((R,), dtype=torch.float32, device=dev)
    first = torch.ones((R,), dtype=torch.bool, device=dev)
    n_out = torch.zeros((R,), dtype=torch.int64, device=dev)
    adv = torch.zeros((R,), dtype=torch.bool, device=dev)
    done = n_hits <= 0
    out_t = torch.zeros((R, max_s), dtype=torch.float32, device=dev)
    out_dt = torch.zeros((R, max_s), dtype=torch.float32, device=dev)
    out_node = torch.full((R, max_s), -1, dtype=torch.int32, device=dev)
    n_hits = n_hits.to(torch.int64)
    n_emit = torch.zeros((R,), dtype=torch.int32, device=dev)
    n_adv = torch.zeros((R,), dtype=torch.int32, device=dev)
    for _ in range(max_iters):
        if bool(done.all()):
            break
        ptr_c = ptr.clamp(max=H - 1)
        node = hit_idx[rows, ptr_c]
        cur_far = hit_far[rows, ptr_c]
        tr = tree.trans_idx[node.clamp(min=0).long()].clamp(min=0)
        xyz = rays_o + rays_d * t[:, None]
        m_rows, w_rows = _warp_rows(tree, tr)
        pnorm = warp_jac_dir(m_rows, w_rows, xyz, rays_d) + 1e-06
        e = sample_l * noise[rows + n_out] / pnorm
        if scale_by_dis:
            trl = tr.long()
            radius = norm3(rays_o - tree.t_center[trl]) / tree.t_dis[trl]
            e = e * torch.clamp(radius, min=1.0)
        emit = ~done & ~adv & ~first & (n_out < max_s)
        slot = n_out.clamp(max=max_s - 1)[:, None]
        for buf, val in ((out_t, t), (out_dt, e * pnorm), (out_node, node)):
            buf.scatter_(1, slot, torch.where(emit, val, buf.gather(1, slot)[:, 0])[:, None])
        n_out = n_out + emit.to(torch.int64)
        ptr_a = ptr + 1
        ptr_ac = ptr_a.clamp(max=H - 1)
        a_near = hit_near[rows, ptr_ac]
        a_far = hit_far[rows, ptr_ac]
        step = torch.where(adv, exp_step, e)
        ex_steps = torch.ceil(torch.clamp((a_near - t) / step, min=1.0))
        adv_step = step * ex_steps
        in_emit = ~done & ~adv
        in_adv = ~done & adv
        emit_fits = t + e <= cur_far
        adv_exhausted = ptr_a >= n_hits
        adv_fits = t + adv_step <= a_far
        n_emit += in_emit.to(torch.int32)
        n_adv += in_adv.to(torch.int32)
        new_done = done | in_adv & adv_exhausted | in_emit & (n_out >= max_s)
        ptr = torch.where(in_adv, ptr_a, ptr)
        t = torch.where(in_emit & emit_fits, t + e, torch.where(in_adv & ~adv_exhausted & adv_fits, t + adv_step, t))
        adv = torch.where(in_emit, ~emit_fits, torch.where(in_adv, ~adv_exhausted & ~adv_fits, adv))
        exp_step = torch.where(in_emit, e, exp_step)
        first = torch.where(in_emit, torch.zeros_like(first), first)
        done = new_done
    ray_march_plain.last_iters = torch.stack([n_emit, n_adv], dim=1)
    return (out_t, out_dt, out_node, n_out.to(torch.int32), _first_oct(hit_near, n_hits))

def ray_march(tree: DeviceTree, rays_o: torch.Tensor, rays_d: torch.Tensor, hit_idx, hit_near, hit_far, n_hits, noise: torch.Tensor, sample_l: float, scale_by_dis: bool, max_s: int, max_iters: int=0):
    """March rays through their hit lists (RayMarchKernel,
    PersSampler.cu:189-314) as an EMIT/ADVANCE state machine.

    noise: [R + max_s + 16] per-step step-length multipliers (already times
    the fineness; all ones in eval). Returns dense per-ray buffers out_t
    [R, max_s], out_dt [R, max_s] (warp-space dt), out_node [R, max_s] i32,
    n_samples [R] i32, first_oct_dis [R]. CPU tensors take the plain
    version; CUDA tensors launch K7."""
    return ray_march_plain(tree, rays_o, rays_d, hit_idx, hit_near, hit_far, n_hits, noise, sample_l, scale_by_dis, max_s, max_iters)

def sample_edges_plain(tree: DeviceTree, edge_idx: torch.Tensor, coord: torch.Tensor):
    """Plain PyTorch version of K12's ``sample_edges`` (JAX
    ``sample_edges``, device.py:649-664, from its draws): the edge's world
    point, then ``apply_warp`` into each neighbour's frame."""
    e = edge_idx.long()
    world = tree.edge_center[e] + tree.edge_dir0[e] * coord[:, :1] + tree.edge_dir1[e] * coord[:, 1:]
    ta = tree.edge_t[e, 0]
    tb = tree.edge_t[e, 1]
    pa = apply_warp(tree, ta, world)
    pb = apply_warp(tree, tb, world)
    return (torch.stack([pa, pb], dim=1), torch.stack([ta, tb], dim=1))

def sample_edges(tree: DeviceTree, edge_idx: torch.Tensor, coord: torch.Tensor):
    """Points on leaf-face adjacencies, warped into both neighbor frames
    (GetEdgeSamplesKernel, PersSampler.cu:436-473).

    edge_idx: [n] int32 picks in [0, max(n_edges, 1)); coord: [n, 2] in
    [-1, 1). Returns (pts [n, 2, 3] warp coords, trans idx [n, 2] i32).
    CPU tensors take ``sample_edges_plain``; CUDA tensors launch K12's
    ``f2_sample_edges`` (csrc/warp.cu, a thread a (sample, frame)), bit for
    bit the plain version."""
    return sample_edges_plain(tree, edge_idx, coord)

def draw_edges(tree: DeviceTree, generator: torch.Generator, n_pts: int):
    """Random (edge_idx, coord) for ``sample_edges``."""
    dev = generator.device
    e = torch.randint(0, max(tree.n_edges, 1), (n_pts,), generator=generator, device=dev)
    coord = torch.rand((n_pts, 2), generator=generator, device=dev) * 2.0 - 1.0
    return (e.to(torch.int32), coord)

def _scatter_max(base: torch.Tensor, idx: torch.Tensor, src: torch.Tensor):
    return base.scatter_reduce(0, idx.long(), src, 'amax', include_self=True)

def compute_occupancy_adders_plain(tree: DeviceTree, node_idx: torch.Tensor, ray_id: torch.Tensor, weights: torch.Tensor, alphas: torch.Tensor, n_rays: int, offsets: torch.Tensor | None=None) -> dict:
    """Plain PyTorch version of K14's votes (JAX
    ``compute_occupancy_adders``, device.py:667-716): segment maxima,
    scatter-maxes and a run-length cumsum / index_add. ``offsets`` is
    accepted as the kernel's wrapper takes it, and not read."""
    from .segment import segment_max
    n_nodes = tree.trans_idx.shape[0]
    dev = node_idx.device
    valid = (ray_id < n_rays) & (node_idx >= 0)
    rid = torch.where(valid, ray_id, torch.full_like(ray_id, n_rays))
    nid = torch.where(valid, node_idx, torch.full_like(node_idx, n_nodes))
    w = torch.where(valid, weights, torch.zeros_like(weights))
    a = torch.where(valid, alphas, torch.zeros_like(alphas))
    ray_max_w = segment_max(w, rid, n_rays)
    ray_max_a = segment_max(a, rid, n_rays)
    thres_w = torch.clamp(ray_max_w * REL_WEIGHT_THRES, max=ABS_WEIGHT_THRES)
    thres_a = torch.clamp(ray_max_a * REL_ALPHA_THRES, max=ABS_ALPHA_THRES)
    rid_c = torch.clamp(rid, max=n_rays - 1).long()
    vote_w = valid & (w > thres_w[rid_c])
    vote_a = valid & (a > thres_a[rid_c])
    i32 = dict(dtype=torch.int32, device=dev)
    minus1 = torch.full((n_nodes + 1,), -1, **i32)
    adder_w = _scatter_max(minus1, nid, torch.where(vote_w, torch.full_like(nid, OCC_WEIGHT_BASE), torch.full_like(nid, -1)))
    adder_a = _scatter_max(minus1, nid, torch.where(vote_a, torch.full_like(nid, OCC_ALPHA_BASE), torch.full_like(nid, -1)))
    mark = _scatter_max(torch.zeros((n_nodes + 1,), **i32), nid, valid.to(torch.int32))
    prev_n = torch.cat([nid.new_full((1,), -2), nid[:-1]])
    prev_r = torch.cat([rid.new_full((1,), -2), rid[:-1]])
    run_first = (nid != prev_n) | (rid != prev_r)
    run_id = torch.cumsum(run_first.to(torch.int64), dim=0) - 1
    cap = node_idx.shape[0]
    run_len = torch.zeros((cap,), **i32).index_add(0, run_id, valid.to(torch.int32))
    per_sample_len = run_len[run_id]
    visit_max = _scatter_max(torch.zeros((n_nodes + 1,), **i32), torch.where(valid & run_first, nid, torch.full_like(nid, n_nodes)), per_sample_len)
    return dict(adder_w=adder_w[:-1], adder_a=adder_a[:-1], mark=mark[:-1], visit_max=visit_max[:-1])

def compute_occupancy_adders(tree: DeviceTree, node_idx: torch.Tensor, ray_id: torch.Tensor, weights: torch.Tensor, alphas: torch.Tensor, n_rays: int, offsets: torch.Tensor | None=None) -> dict:
    """Per-batch occupancy vote tensors (MarkVistNodeKernel,
    PersSampler.cu:475-534): max-combinable [n_nodes] i32 arrays adder_w,
    adder_a, mark, visit_max. node_idx/ray_id: [cap] int32 flat sample
    buffer, sorted by ray_id (padding: ray_id == n_rays, node_idx == -1);
    weights/alphas [cap] float32. ``offsets``: the buffer's ray offsets
    as ``ray_offsets`` gives them for ray_id (the renderer passes buffer
    A's from ``compact_a_warp``, or B's; computed by ``ray_offsets`` when
    None). CPU tensors take ``compute_occupancy_adders_plain``; CUDA
    tensors launch K14's ``f2_occupancy_votes`` (csrc/occupancy.cu: one
    cooperative launch, a warp a ray over its rows [offsets[r],
    offsets[r + 1]), integer maxima), bit for bit the plain version."""
    return compute_occupancy_adders_plain(tree, node_idx, ray_id, weights, alphas, n_rays, offsets)
OCC_VOTES = ('adder_w', 'adder_a', 'mark', 'visit_max')
OCC_STATS = ('weight_stats', 'alpha_stats', 'visit_cnt', 'trans_idx')

def apply_occupancy_adders_plain(tree: DeviceTree, occ: dict) -> DeviceTree:
    """Plain PyTorch version of K14's fold (JAX ``apply_occupancy_adders``,
    device.py:719-741)."""
    adder_w, adder_a = (occ['adder_w'], occ['adder_a'])
    mark = occ['mark']
    occ_w = (adder_w > 0).to(torch.int32)
    wstats = torch.maximum(tree.weight_stats, occ_w * adder_w)
    wstats = wstats + mark * (1 - occ_w) * adder_w
    wstats = torch.clamp(wstats, -100, 1 << 20)
    occ_a = (adder_a > 0).to(torch.int32)
    astats = torch.maximum(tree.alpha_stats, occ_a * adder_a)
    astats = astats + mark * (1 - occ_a) * adder_a
    astats = torch.clamp(astats, -100, 1 << 20)
    trans_idx = torch.where((wstats < 0) | (astats < 0), torch.full_like(tree.trans_idx, -1), tree.trans_idx)
    visit_cnt = torch.maximum(tree.visit_cnt, occ['visit_max'])
    return dataclasses.replace(tree, weight_stats=wstats, alpha_stats=astats, visit_cnt=visit_cnt, trans_idx=trans_idx)
