"""Adaptive perspective octree: host-side construction (port of
``f2nerf_tpu/sampler/octree.py``).

Semantics of PersOctree (reference PersSampler.cpp): BFS construction with
camera-visibility tests (ctor :70-118, ConstructTreeNode :359-421,
GetVisiCams :27-66), face-neighbor ropes for the device traversal, the
edge pool for the TV loss (ConstructEdgePool :614-659), periodic
maintenance (ProcOctree compact / path-compress / subdivide :120-330) and
visibility culling (MarkInvisibleNodes, PersSampler.cu:618-680). The host
logic is a numpy copy of the JAX package's; the visibility test
(``_make_visi_fn``) runs in torch on the given device.

The edge pool and ProcOctree run in the port's native C++ engine
(``f2nerf_torch/native``, the JAX package's engine with the same C ABI),
so a port build gives the JAX build's edges in the JAX build's order.
Their numpy versions, ``_construct_edge_pool_np`` and ``_proc_octree_np``,
are the plain versions the tests hold the engine against; nothing on the
training path calls them.

Occupancy counters follow PersSampler.cu:11-17: INIT_NODE_STAT=1000.
"""

from __future__ import annotations

import dataclasses
import sys
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import native
from .warp import N_PROS, distance_summary, finish_trans_batch, virtual_cams

INIT_NODE_STAT = 1000


@dataclass
class OctreeHost:
    """Struct-of-arrays octree + warp table + edge pool (host, growable)."""
    center: np.ndarray      # [n, 3] f32
    side: np.ndarray        # [n] f32
    parent: np.ndarray      # [n] i32
    childs: np.ndarray      # [n, 8] i32, -1 = none
    is_leaf: np.ndarray     # [n] bool
    trans_idx: np.ndarray   # [n] i32, -1 = invalid leaf
    weight_stats: np.ndarray  # [n] i32
    alpha_stats: np.ndarray   # [n] i32
    visit_cnt: np.ndarray     # [n] i32
    # warp table (immutable after construction)
    w2xz: np.ndarray        # [m, 12, 2, 4] f32
    weight: np.ndarray      # [m, 3, 12] f32
    t_center: np.ndarray    # [m, 3] f32
    t_dis: np.ndarray       # [m] f32
    # edge pool
    edge_t: np.ndarray      # [e, 2] i32 (trans idx a, b)
    edge_center: np.ndarray  # [e, 3] f32
    edge_dir0: np.ndarray   # [e, 3] f32
    edge_dir1: np.ndarray   # [e, 3] f32
    side_len: float = 0.0
    milestones: list = field(default_factory=list)

    @property
    def n_nodes(self):
        return self.center.shape[0]

    @property
    def n_trans(self):
        return self.w2xz.shape[0]


def _make_visi_fn(rays_o: np.ndarray, rays_d: np.ndarray, bounds: np.ndarray,
                  device="cpu", chunk: int | None = None):
    """Batched camera-visibility test (GetVisiCams, PersSampler.cpp:27-66):
    a slab test of each candidate node against every proxy pixel ray of
    every camera, any-reduced over pixels. Returns run(centers [n,3],
    sides [n]) -> bool [n, cams]. ``chunk`` nodes go through at once
    (default 64 on a GPU, 8 on the CPU to bound the [chunk, cams, pix, 3]
    temporaries)."""
    dev = torch.device(device)
    if chunk is None:
        chunk = 64 if dev.type == "cuda" else 8
    ro = torch.as_tensor(rays_o, dtype=torch.float32, device=dev)   # [cams, 3]
    rd = torch.as_tensor(rays_d, dtype=torch.float32, device=dev)   # [cams, pix, 3]
    bd = torch.as_tensor(bounds, dtype=torch.float32, device=dev)   # [cams, 2]

    def visi(centers, sides):
        hf = sides[:, None, None, None] * 0.5
        c = centers[:, None, None, :]
        o = ro[None, :, None, :]
        d = rd[None]
        a = torch.nan_to_num((c - hf - o) / d, nan=0.0, posinf=1e6, neginf=-1e6)
        b = torch.nan_to_num((c + hf - o) / d, nan=0.0, posinf=1e6, neginf=-1e6)
        far = torch.minimum(torch.maximum(a, b).amin(dim=-1), bd[None, :, None, 1])
        near = torch.maximum(torch.minimum(a, b).amax(dim=-1), bd[None, :, None, 0])
        return (far > near).any(dim=-1)                  # [chunk, cams]

    def run(centers: np.ndarray, sides: np.ndarray) -> np.ndarray:
        n = centers.shape[0]
        out = np.zeros((n, rays_o.shape[0]), bool)
        for i in range(0, n, chunk):
            c = torch.as_tensor(centers[i:i + chunk], dtype=torch.float32, device=dev)
            s = torch.as_tensor(sides[i:i + chunk], dtype=torch.float32, device=dev)
            out[i:i + chunk] = visi(c, s).cpu().numpy()
        return out

    return run


def _proxy_rays(c2w: np.ndarray, intri: np.ndarray):
    """128-px-wide proxy pixel grids through camera 0's intrinsics for every
    camera pose (PersSampler.cpp:32-49 uses intri[0] for the grid)."""
    cx, cy = float(intri[0, 0, 2]), float(intri[0, 1, 2])
    fx, fy = float(intri[0, 0, 0]), float(intri[0, 1, 1])
    res_w = 128
    res_h = int(round(res_w / cx * cy))
    i = np.linspace(0.5, cy * 2.0 - 0.5, res_h)
    j = np.linspace(0.5, cx * 2.0 - 0.5, res_w)
    ii, jj = np.meshgrid(i, j, indexing="ij")
    cam = np.stack([(jj.ravel() - cx) / fx, -(ii.ravel() - cy) / fy,
                    -np.ones(res_h * res_w)], axis=-1)  # [n_pix, 3]
    rays_d = np.einsum("cab,pb->cpa", c2w[:, :3, :3], cam)
    rays_o = c2w[:, :3, 3]
    return rays_o.astype(np.float64), rays_d.astype(np.float64)


def build_octree(c2w: np.ndarray, w2c: np.ndarray, intri: np.ndarray,
                 bounds: np.ndarray, cfg: dict, seed: int = 0,
                 device="cpu") -> OctreeHost:
    """Construct the adaptive octree over train cameras.

    cfg keys: bbox_levels, max_level, split_dist_thres, sub_div_milestones.
    Split criterion (PersSampler.cpp:393-406): subdivide while the node sees
    >= N_PROS/2 cameras AND dis_summary < side_len * split_dist_thres.
    """
    rng = np.random.default_rng(seed)
    side_len = float(1 << (int(cfg["bbox_levels"]) - 1))
    max_depth = int(cfg["max_level"])
    split_thres = float(cfg["split_dist_thres"])

    rays_o, rays_d = _proxy_rays(c2w, intri)
    visi_fn = _make_visi_fn(rays_o, rays_d, bounds, device=device)
    cam_pos = c2w[:, :3, 3].astype(np.float64)

    nodes = {k: [] for k in ("center", "side", "parent", "childs", "is_leaf", "trans_idx")}
    # warp construction is two-phase: the cheap camera-selection half runs
    # inline (host), the per-point PCA/Jacobian half batches over ALL
    # leaves on the device at the end (finish_trans_batch)
    trans_w2xz, trans_center, trans_dis, trans_side = [], [], [], []

    def new_node(parent, center, side):
        nodes["center"].append(np.asarray(center, np.float64))
        nodes["side"].append(side)
        nodes["parent"].append(parent)
        nodes["childs"].append([-1] * 8)
        nodes["is_leaf"].append(False)
        nodes["trans_idx"].append(-1)
        return len(nodes["center"]) - 1

    # BFS level-by-level so the camera-visibility tests batch on the
    # device (the reference recurses with one GPU test per node)
    root = new_node(-1, np.zeros(3), side_len)
    frontier = [(root, 0)]
    while frontier:
        testable = [(u, d) for (u, d) in frontier if d <= max_depth]
        for u, d in frontier:
            if d > max_depth:
                nodes["is_leaf"][u] = True
        if not testable:
            break
        centers = np.stack([nodes["center"][u] for u, _ in testable])
        sides = np.asarray([nodes["side"][u] for u, _ in testable], np.float32)
        hits = visi_fn(centers.astype(np.float32), sides)
        next_frontier = []
        for (u, depth), hit in zip(testable, hits):
            center = nodes["center"][u]
            side = nodes["side"][u]
            visi = np.nonzero(hit)[0]
            dis = np.linalg.norm(cam_pos[visi] - center, axis=-1)
            d_sum = distance_summary(dis)
            if len(visi) >= N_PROS // 2 and d_sum < side * split_thres:
                for st in range(8):
                    off = np.array([(st >> 2) & 1, (st >> 1) & 1, st & 1]) - 0.5
                    v = new_node(u, center + side * 0.5 * off, side * 0.5)
                    nodes["childs"][u][st] = v
                    next_frontier.append((v, depth + 1))
            elif len(visi) < N_PROS // 2:
                nodes["is_leaf"][u] = True
            else:
                nodes["is_leaf"][u] = True
                nodes["trans_idx"][u] = len(trans_w2xz)
                w2xz, d_s = virtual_cams(c2w[visi], intri[0], center, rng)
                trans_w2xz.append(w2xz)
                trans_center.append(center)
                trans_dis.append(d_s)
                trans_side.append(side)
        frontier = next_frontier

    weights_done = finish_trans_batch(
        np.asarray(trans_w2xz, np.float32).reshape(-1, N_PROS, 2, 4),
        centers=np.asarray(trans_center, np.float32).reshape(-1, 3),
        sides=np.asarray(trans_side, np.float32), seed=seed,
        device=device)

    n = len(nodes["center"])
    tree = OctreeHost(
        center=np.asarray(nodes["center"], np.float32),
        side=np.asarray(nodes["side"], np.float32),
        parent=np.asarray(nodes["parent"], np.int32),
        childs=np.asarray(nodes["childs"], np.int32),
        is_leaf=np.asarray(nodes["is_leaf"], bool),
        trans_idx=np.asarray(nodes["trans_idx"], np.int32),
        weight_stats=np.full(n, INIT_NODE_STAT, np.int32),
        alpha_stats=np.full(n, INIT_NODE_STAT, np.int32),
        visit_cnt=np.zeros(n, np.int32),
        w2xz=np.stack(trans_w2xz).astype(np.float32) if trans_w2xz
        else np.zeros((0, N_PROS, 2, 4), np.float32),
        weight=weights_done.astype(np.float32) if len(weights_done)
        else np.zeros((0, 3, N_PROS), np.float32),
        t_center=np.stack(trans_center).astype(np.float32) if trans_center
        else np.zeros((0, 3), np.float32),
        t_dis=np.asarray(trans_dis, np.float32),
        edge_t=np.zeros((0, 2), np.int32),
        edge_center=np.zeros((0, 3), np.float32),
        edge_dir0=np.zeros((0, 3), np.float32),
        edge_dir1=np.zeros((0, 3), np.float32),
        side_len=side_len,
        # reference reverses the list and pops from the back -> process
        # smallest milestone first (PersSampler.cpp:673, .cu:616-622)
        milestones=sorted((int(m) for m in cfg["sub_div_milestones"]), reverse=True),
    )
    construct_edge_pool(tree)
    return tree


def build_ropes(tree: OctreeHost) -> np.ndarray:
    """Per-node face-neighbor links ("ropes", cf. kd-tree rope traversal):
    ropes[u, face] = the same-or-coarser node adjacent to leaf u across
    `face` (axis*2 + (1 if +axis else 0)), or -1 at the domain boundary.

    The device traversal follows a rope on leaf exit and point-locates
    downward inside the target, replacing the reference's per-ray DFS stack
    (PersSampler.cu:53-152) and the round-1 root-restart scheme (~depth
    gathers per leaf) with ~1 gather per leaf plus occasional descents.
    Derived data: rebuilt on every host->device upload, never serialized."""
    n = tree.n_nodes
    ropes = np.full((n, 6), -1, np.int32)
    leaves = np.nonzero(tree.is_leaf[:n])[0]
    if len(leaves) == 0:
        return ropes
    centers = tree.center[leaves].astype(np.float64)
    sides = tree.side[leaves].astype(np.float64)
    # 6 probe points just across each face center
    offs = np.zeros((6, 3))
    for ax in range(3):
        offs[2 * ax, ax] = -1.0
        offs[2 * ax + 1, ax] = 1.0
    probes = (centers[:, None, :]
              + offs[None] * (sides * 0.5 * (1.0 + 1e-4))[:, None, None])
    probes = probes.reshape(-1, 3)                     # [L*6, 3]
    tgt_side = np.repeat(sides, 6)                     # [L*6]

    half_root = tree.side[0] * 0.5 * (1.0 + 1e-9)
    inside_root = (np.abs(probes - tree.center[0]).max(axis=1) <= half_root)
    u = np.zeros(len(probes), np.int64)
    # descend while strictly coarser than the leaf and not itself a leaf
    for _ in range(64):
        can = (~tree.is_leaf[u]) & (tree.side[u] > tgt_side * 1.5)
        if not can.any():
            break
        ge = (probes >= tree.center[u]).astype(np.int64)
        st = (ge[:, 0] << 2) | (ge[:, 1] << 1) | ge[:, 2]
        c = tree.childs[u, st]
        step = can & (c >= 0)
        u = np.where(step, c, u)
        if not step.any():
            break
    u = np.where(inside_root, u, -1)
    ropes[leaves] = u.reshape(-1, 6).astype(np.int32)
    return ropes


def construct_edge_pool(tree: OctreeHost) -> None:
    """Leaf-face adjacency pool for TV-loss edge sampling
    (ConstructEdgePool, PersSampler.cpp:614-659), filled in place by the
    native engine: the JAX package's edges in its order, which the TV
    loss's edge picks (``draw_edges``) index."""
    tree.edge_t, tree.edge_center, tree.edge_dir0, tree.edge_dir1 = \
        native.edge_pool(tree)


def _construct_edge_pool_np(tree: OctreeHost) -> None:
    """Plain numpy version of ``construct_edge_pool``: the same multiset of
    edges, in another order (pairs swept face by face)."""
    valid = np.nonzero(tree.trans_idx >= 0)[0]
    et, ec, e0, e1 = [], [], [], []
    centers = tree.center.astype(np.float64)
    sides = tree.side.astype(np.float64)
    face_axes = [(0, 1, 2), (0, 1, 2), (1, 0, 2), (1, 0, 2), (2, 0, 1), (2, 0, 1)]
    signs = [1, -1, 1, -1, 1, -1]
    for ai, a in enumerate(valid):
        bs = valid[ai + 1:]
        if len(bs) == 0:
            continue
        # u = smaller-side node of each (a, b) pair
        u_is_a = sides[a] <= sides[bs]
        for k, (ax, d0, d1) in enumerate(face_axes):
            sgn = signs[k]
            # face center of u for each pair
            u_center = np.where(u_is_a[:, None], centers[a], centers[bs])
            u_side = np.where(u_is_a, sides[a], sides[bs])
            v_center = np.where(u_is_a[:, None], centers[bs], centers[a])
            v_side = np.where(u_is_a, sides[bs], sides[a])
            len_u = u_side * 0.5
            pt = u_center.copy()
            pt[:, ax] += sgn * len_u
            inside = (np.abs(pt - v_center) / v_side[:, None] * 2.0
                      < 1.0 + 1e-4).all(axis=1)
            for idx in np.nonzero(inside)[0]:
                b = bs[idx]
                et.append((tree.trans_idx[a], tree.trans_idx[b]))
                ec.append(pt[idx])
                dv0 = np.zeros(3)
                dv0[d0] = len_u[idx]
                dv1 = np.zeros(3)
                dv1[d1] = len_u[idx]
                e0.append(dv0)
                e1.append(dv1)
    tree.edge_t = np.asarray(et, np.int32).reshape(-1, 2)
    tree.edge_center = np.asarray(ec, np.float32).reshape(-1, 3)
    tree.edge_dir0 = np.asarray(e0, np.float32).reshape(-1, 3)
    tree.edge_dir1 = np.asarray(e1, np.float32).reshape(-1, 3)


def proc_octree(tree: OctreeHost, compact: bool, subdivide: bool,
                brute_force: bool) -> OctreeHost:
    """Compact dead leaves, path-compress single-child chains, optionally
    subdivide visited leaves 8-ways (ProcOctree, PersSampler.cpp:120-330),
    in the native engine. Visit counts restart at zero; the warp table,
    edge pool and milestones carry over."""
    nodes = native.proc_octree(tree, compact, subdivide, brute_force)
    return dataclasses.replace(
        tree, **nodes, visit_cnt=np.zeros(len(nodes["side"]), np.int32),
        milestones=list(tree.milestones))


def _proc_octree_np(tree: OctreeHost, compact: bool, subdivide: bool,
                    brute_force: bool) -> OctreeHost:
    """Plain numpy version of ``proc_octree``."""
    n = tree.n_nodes
    parent = tree.parent.copy()
    childs = tree.childs.copy()
    is_leaf = tree.is_leaf.copy()
    trans_idx = tree.trans_idx.copy()
    center = tree.center.copy()
    side = tree.side.copy()
    wstat = tree.weight_stats.copy()
    astat = tree.alpha_stats.copy()
    visit = tree.visit_cnt.copy()

    if compact:
        # detach invalid leaves, then cascade: nodes without valid children
        # become (removable) leaves, repeated to fixpoint
        while True:
            for u in range(n):
                if is_leaf[u] and trans_idx[u] < 0 and parent[u] >= 0:
                    v = parent[u]
                    childs[v][childs[v] == u] = -1
            changed = False
            for u in range(1, n):
                if (childs[u] < 0).all():
                    if not is_leaf[u]:
                        changed = True
                    is_leaf[u] = True
            if not changed:
                break

        # path compression: splice single-child chains above valid nodes
        def single_child(v):
            cs = childs[v][childs[v] >= 0]
            return cs[0] if len(cs) == 1 else -1

        for u in range(n):
            if is_leaf[u] and trans_idx[u] < 0:
                continue
            v = parent[u]
            while v >= 0 and parent[v] >= 0 and single_child(v) >= 0:
                vv = parent[v]
                childs[vv][childs[vv] == v] = u
                parent[u] = vv
                trans_idx[v] = -1
                is_leaf[v] = True  # removal flag
                v = vv

    keep = (~is_leaf) | (trans_idx >= 0)
    keep[0] = True
    new_idx = np.full(n, -1, np.int32)
    new_idx[keep] = np.arange(keep.sum(), dtype=np.int32)

    def remap(x):
        return np.where(x >= 0, new_idx[np.clip(x, 0, n - 1)], -1)

    order = np.nonzero(keep)[0]
    center, side = center[order], side[order]
    parent = remap(parent[order])
    childs = remap(childs[order])
    is_leaf, trans_idx = is_leaf[order], trans_idx[order]
    wstat, astat, visit = wstat[order], astat[order], visit[order]

    if subdivide:
        # DFS re-pack with 8-way split of visited valid leaves
        out = {k: [] for k in ("center", "side", "parent", "childs",
                               "is_leaf", "trans_idx", "w", "a")}

        def emit(vals):
            for k, v in vals.items():
                out[k].append(v)
            return len(out["center"]) - 1

        sys.setrecursionlimit(max(sys.getrecursionlimit(), 200000))

        def rec(u, pa):
            nu = emit(dict(center=center[u], side=side[u], parent=pa,
                           childs=list(childs[u]), is_leaf=bool(is_leaf[u]),
                           trans_idx=int(trans_idx[u]),
                           w=int(wstat[u]), a=int(astat[u])))
            if is_leaf[u]:
                assert trans_idx[u] >= 0
                if not brute_force and visit[u] <= 4:
                    return nu
                for st in range(8):
                    off = np.array([(st >> 2) & 1, (st >> 1) & 1, st & 1]) - 0.5
                    nv = emit(dict(center=center[u] + side[u] * 0.5 * off,
                                   side=side[u] * 0.5, parent=nu,
                                   childs=[-1] * 8, is_leaf=True,
                                   trans_idx=int(trans_idx[u]),
                                   w=int(wstat[u]), a=int(astat[u])))
                    out["childs"][nu][st] = nv
                out["is_leaf"][nu] = False
                out["trans_idx"][nu] = -1
                out["w"][nu] = INIT_NODE_STAT
                out["a"][nu] = INIT_NODE_STAT
            else:
                assert trans_idx[u] < 0
                for st in range(8):
                    c = out["childs"][nu][st]
                    if c >= 0:
                        out["childs"][nu][st] = rec(c, nu)
            return nu

        rec(0, -1)
        center = np.asarray(out["center"], np.float32).reshape(-1, 3)
        side = np.asarray(out["side"], np.float32)
        parent = np.asarray(out["parent"], np.int32)
        childs = np.asarray(out["childs"], np.int32).reshape(-1, 8)
        is_leaf = np.asarray(out["is_leaf"], bool)
        trans_idx = np.asarray(out["trans_idx"], np.int32)
        wstat = np.asarray(out["w"], np.int32)
        astat = np.asarray(out["a"], np.int32)

    return OctreeHost(
        center=center, side=side, parent=parent, childs=childs,
        is_leaf=is_leaf, trans_idx=trans_idx,
        weight_stats=wstat, alpha_stats=astat,
        visit_cnt=np.zeros(len(side), np.int32),
        w2xz=tree.w2xz, weight=tree.weight, t_center=tree.t_center,
        t_dis=tree.t_dis, edge_t=tree.edge_t, edge_center=tree.edge_center,
        edge_dir0=tree.edge_dir0, edge_dir1=tree.edge_dir1,
        side_len=tree.side_len, milestones=list(tree.milestones),
    )


def mark_invisible_nodes(tree: OctreeHost, intri: np.ndarray, w2c: np.ndarray,
                         bounds: np.ndarray) -> None:
    """Invalidate nodes seen by < 1 camera (MarkInvisibleNodesKernel,
    PersSampler.cu:618-680). Vectorized over nodes x cams."""
    c = tree.center.astype(np.float64)            # [n, 3]
    radius = tree.side.astype(np.float64) * 0.707  # [n]
    # cam-space points: [n, cams, 3]
    cam_pt = np.einsum("kab,nb->nka", w2c[:, :3, :3].astype(np.float64), c) \
        + w2c[:, :3, 3].astype(np.float64)[None]
    z = -cam_pt[..., 2]
    vis = ~((z < bounds[None, :, 0] - radius[:, None]) |
            (z > bounds[None, :, 1] + radius[:, None]))
    close = np.linalg.norm(cam_pt, axis=-1) < radius[:, None]
    fx, fy = intri[:, 0, 0], intri[:, 1, 1]
    cx, cy = intri[:, 0, 2], intri[:, 1, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        bias_x = radius[:, None] / z * fx[None]
        bias_y = radius[:, None] / z * fy[None]
        ix = cam_pt[..., 0] / z * fx[None]
        iy = cam_pt[..., 1] / z * fy[None]
    in_img = ~((ix + bias_x < -cx[None]) | (ix > cx[None] + bias_x) |
               (iy + bias_y < -cy[None]) | (iy > cy[None] + bias_y))
    visible = (vis & (close | in_img)).sum(axis=1)
    tree.trans_idx[visible < 1] = -1


def maintain(tree: OctreeHost, iter_step: int, compact_freq: int,
             intri: np.ndarray, w2c: np.ndarray, bounds: np.ndarray) -> tuple[OctreeHost, bool]:
    """Milestone subdivision + periodic compaction (UpdateOctNodes tail,
    PersSampler.cu:616-631). Returns (tree, changed)."""
    changed = False
    while tree.milestones and tree.milestones[-1] <= iter_step:
        tree = proc_octree(tree, True, True, tree.milestones[-1] <= 0)
        mark_invisible_nodes(tree, intri, w2c, bounds)
        tree = proc_octree(tree, True, False, False)
        tree.milestones.pop()
        changed = True
    if iter_step % compact_freq == 0:
        tree = proc_octree(tree, True, False, False)
        changed = True
    return tree, changed
