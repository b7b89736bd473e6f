"""The reference's own octree, worked out from the scene's cameras and never
taken from the program: built, subdivided and packed for the device.

A plain copy of the port's host octree (``sampler/octree.py``: the
breadth-first build with its camera-visibility test, visibility culling,
the milestone and compaction rules) with its C++ maintenance engine
(ProcOctree, PersSampler.cpp:120-330, and the edge pool,
PersSampler.cpp:614-659) written out in numpy. Where the engine's order
sets the result, the order is kept: path compression runs node by node,
the re-pack is depth first with children in slot order, the edge pool
walks its pairs (a, b > a) and faces in turn; the steps whose order does
not matter are vectorised. Then the device packing of the port's
``to_device_tree`` (ropes, node records, padding to the capacities).
Imports nothing of the port."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from .sampler import pack_node_records
from .warp import N_PROS, distance_summary, finish_trans_batch, virtual_cams

INIT_NODE_STAT = 1000
# the Trainer's default device capacities (its config's ``capacity`` group)
CAPACITY = dict(max_nodes=393216, max_trans=32768, max_edges=262144)


@dataclass
class HostTree:
    """Struct-of-arrays octree, warp table and edge pool on the host."""
    center: np.ndarray      # [n, 3] f32
    side: np.ndarray        # [n] f32
    parent: np.ndarray      # [n] i32
    childs: np.ndarray      # [n, 8] i32, -1 = none
    is_leaf: np.ndarray     # [n] bool
    trans_idx: np.ndarray   # [n] i32, -1 = invalid leaf
    weight_stats: np.ndarray
    alpha_stats: np.ndarray
    visit_cnt: np.ndarray
    w2xz: np.ndarray        # [m, 12, 2, 4] f32
    weight: np.ndarray      # [m, 3, 12] f32
    t_center: np.ndarray    # [m, 3] f32
    t_dis: np.ndarray       # [m] f32
    edge_t: np.ndarray      # [e, 2] i32
    edge_center: np.ndarray
    edge_dir0: np.ndarray
    edge_dir1: np.ndarray
    milestones: list = field(default_factory=list)

    @property
    def n_nodes(self):
        return self.center.shape[0]


def pow2ceil(x: float) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


# ------------------------------------------------------------------ build

def _make_visi_fn(rays_o: np.ndarray, rays_d: np.ndarray, bounds: np.ndarray, device):
    """Camera visibility of nodes (GetVisiCams, PersSampler.cpp:27-66): a
    slab test of each node against every proxy pixel ray of every camera,
    any-reduced over pixels. run(centers [n, 3], sides [n]) -> bool [n, cams]."""
    dev = torch.device(device)
    chunk = 64 if dev.type == "cuda" else 8
    ro = torch.as_tensor(rays_o, dtype=torch.float32, device=dev)
    rd = torch.as_tensor(rays_d, dtype=torch.float32, device=dev)
    bd = torch.as_tensor(bounds, dtype=torch.float32, device=dev)

    def visi(centers, sides):
        hf = sides[:, None, None, None] * 0.5
        c = centers[:, None, None, :]
        o = ro[None, :, None, :]
        d = rd[None]
        a = torch.nan_to_num((c - hf - o) / d, nan=0.0, posinf=1e6, neginf=-1e6)
        b = torch.nan_to_num((c + hf - o) / d, nan=0.0, posinf=1e6, neginf=-1e6)
        far = torch.minimum(torch.maximum(a, b).amin(dim=-1), bd[None, :, None, 1])
        near = torch.maximum(torch.minimum(a, b).amax(dim=-1), bd[None, :, None, 0])
        return (far > near).any(dim=-1)

    def run(centers: np.ndarray, sides: np.ndarray) -> np.ndarray:
        out = np.zeros((centers.shape[0], rays_o.shape[0]), bool)
        for i in range(0, centers.shape[0], chunk):
            c = torch.as_tensor(centers[i:i + chunk], dtype=torch.float32, device=dev)
            s = torch.as_tensor(sides[i:i + chunk], dtype=torch.float32, device=dev)
            out[i:i + chunk] = visi(c, s).cpu().numpy()
        return out

    return run


def _proxy_rays(c2w: np.ndarray, intri: np.ndarray):
    """128-px-wide proxy pixel grids through camera 0's intrinsics for every
    camera pose (PersSampler.cpp:32-49)."""
    cx, cy = float(intri[0, 0, 2]), float(intri[0, 1, 2])
    fx, fy = float(intri[0, 0, 0]), float(intri[0, 1, 1])
    res_w = 128
    res_h = int(round(res_w / cx * cy))
    i = np.linspace(0.5, cy * 2.0 - 0.5, res_h)
    j = np.linspace(0.5, cx * 2.0 - 0.5, res_w)
    ii, jj = np.meshgrid(i, j, indexing="ij")
    cam = np.stack([(jj.ravel() - cx) / fx, -(ii.ravel() - cy) / fy,
                    -np.ones(res_h * res_w)], axis=-1)
    rays_d = np.einsum("cab,pb->cpa", c2w[:, :3, :3], cam)
    return c2w[:, :3, 3].astype(np.float64), rays_d.astype(np.float64)


def build_octree(c2w, w2c, intri, bounds, cfg: dict, seed: int, device) -> HostTree:
    """The adaptive octree over the train cameras (PersSampler.cpp:70-118,
    359-421), breadth first: a node is split while it sees at least N_PROS/2
    cameras and their distance summary is under side * split_dist_thres;
    a node that sees fewer is an invalid leaf, the rest get a warp."""
    rng = np.random.default_rng(seed)
    side_len = float(1 << (int(cfg["bbox_levels"]) - 1))
    max_depth = int(cfg["max_level"])
    split_thres = float(cfg["split_dist_thres"])
    rays_o, rays_d = _proxy_rays(c2w, intri)
    visi_fn = _make_visi_fn(rays_o, rays_d, bounds, device)
    cam_pos = c2w[:, :3, 3].astype(np.float64)

    nodes = {k: [] for k in ("center", "side", "parent", "childs", "is_leaf", "trans_idx")}
    trans_w2xz, trans_center, trans_dis, trans_side = [], [], [], []

    def new_node(parent, center, side):
        nodes["center"].append(np.asarray(center, np.float64))
        nodes["side"].append(side)
        nodes["parent"].append(parent)
        nodes["childs"].append([-1] * 8)
        nodes["is_leaf"].append(False)
        nodes["trans_idx"].append(-1)
        return len(nodes["center"]) - 1

    frontier = [(new_node(-1, np.zeros(3), side_len), 0)]
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
            center, side = nodes["center"][u], nodes["side"][u]
            visi = np.nonzero(hit)[0]
            d_sum = distance_summary(np.linalg.norm(cam_pos[visi] - center, axis=-1))
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

    weight = finish_trans_batch(
        np.asarray(trans_w2xz, np.float32).reshape(-1, N_PROS, 2, 4),
        centers=np.asarray(trans_center, np.float32).reshape(-1, 3),
        sides=np.asarray(trans_side, np.float32), seed=seed, device=device)
    n = len(nodes["center"])
    tree = HostTree(
        center=np.asarray(nodes["center"], np.float32),
        side=np.asarray(nodes["side"], np.float32),
        parent=np.asarray(nodes["parent"], np.int32),
        childs=np.asarray(nodes["childs"], np.int32),
        is_leaf=np.asarray(nodes["is_leaf"], bool),
        trans_idx=np.asarray(nodes["trans_idx"], np.int32),
        weight_stats=np.full(n, INIT_NODE_STAT, np.int32),
        alpha_stats=np.full(n, INIT_NODE_STAT, np.int32),
        visit_cnt=np.zeros(n, np.int32),
        w2xz=np.asarray(trans_w2xz, np.float32).reshape(-1, N_PROS, 2, 4),
        weight=weight.astype(np.float32).reshape(-1, 3, N_PROS),
        t_center=np.asarray(trans_center, np.float32).reshape(-1, 3),
        t_dis=np.asarray(trans_dis, np.float32),
        edge_t=np.zeros((0, 2), np.int32), edge_center=np.zeros((0, 3), np.float32),
        edge_dir0=np.zeros((0, 3), np.float32), edge_dir1=np.zeros((0, 3), np.float32),
        # smallest milestone first (PersSampler.cpp:673, .cu:616-622)
        milestones=sorted((int(m) for m in cfg["sub_div_milestones"]), reverse=True))
    edge_pool(tree)
    return tree


# face f: (axis crossed, the two axes of the face), sign of the crossing
FACE_AXES = ((0, 1, 2), (0, 1, 2), (1, 0, 2), (1, 0, 2), (2, 0, 1), (2, 0, 1))
FACE_SIGN = (1, -1, 1, -1, 1, -1)


def edge_pool(tree: HostTree) -> None:
    """Leaf-face adjacency pool for the TV loss (ConstructEdgePool), in
    float32: for each pair of valid leaves a < b, and each face of the
    smaller u, the edge (trans a, trans b) when the point just across u's
    face lies in the other, v. Edges in the order (a, b, face)."""
    valid = np.nonzero(tree.trans_idx >= 0)[0]
    c, s = tree.center.astype(np.float32), tree.side.astype(np.float32)
    half, two = np.float32(0.5), np.float32(2.0)
    lim = np.float32(1.0) + np.float32(1e-4)
    et, ec, e0, e1 = [], [], [], []
    for ai in range(len(valid) - 1):
        a, b = valid[ai], valid[ai + 1:]
        a_u = ~(s[a] > s[b])
        u_c = np.where(a_u[:, None], c[a], c[b])
        v_c = np.where(a_u[:, None], c[b], c[a])
        len_u = np.where(a_u, s[a], s[b]) * half
        v_s = np.where(a_u, s[b], s[a])
        pts = np.repeat(u_c[:, None, :], 6, axis=1)
        for f, (ax, _, _) in enumerate(FACE_AXES):
            pts[:, f, ax] += np.float32(FACE_SIGN[f]) * len_u
        inside = (np.abs((pts - v_c[:, None, :]) / v_s[:, None, None] * two)
                  .max(axis=-1) < lim)
        rows, faces = np.nonzero(inside)
        if len(rows) == 0:
            continue
        et.append(np.stack([np.full(len(rows), tree.trans_idx[a]),
                            tree.trans_idx[b[rows]]], axis=1))
        ec.append(pts[rows, faces])
        d0 = np.zeros((len(rows), 3), np.float32)
        d1 = np.zeros((len(rows), 3), np.float32)
        ax0 = np.array([FACE_AXES[f][1] for f in faces])
        ax1 = np.array([FACE_AXES[f][2] for f in faces])
        d0[np.arange(len(rows)), ax0] = len_u[rows]
        d1[np.arange(len(rows)), ax1] = len_u[rows]
        e0.append(d0)
        e1.append(d1)

    def cat(xs, w, dtype):
        return np.concatenate(xs).astype(dtype) if xs else np.zeros((0, w), dtype)

    tree.edge_t = cat(et, 2, np.int32)
    tree.edge_center = cat(ec, 3, np.float32)
    tree.edge_dir0 = cat(e0, 3, np.float32)
    tree.edge_dir1 = cat(e1, 3, np.float32)


# ------------------------------------------------------------ maintenance

def proc_octree(tree: HostTree, compact: bool, subdivide: bool,
                brute_force: bool) -> HostTree:
    """Compact dead leaves, path-compress single-child chains, optionally
    split the visited valid leaves 8 ways (every valid leaf with
    ``brute_force``). Visit counts restart at zero; the warp table, edge
    pool and milestones carry over."""
    n = tree.n_nodes
    center, side = tree.center.copy(), tree.side.copy()
    parent = tree.parent.astype(np.int64)
    childs = tree.childs.astype(np.int64)
    is_leaf, trans = tree.is_leaf.copy(), tree.trans_idx.copy()
    wstat, astat, visit = tree.weight_stats.copy(), tree.alpha_stats.copy(), tree.visit_cnt.copy()

    if compact:
        # detach invalid leaves; childless nodes (not the root) become
        # leaves; to a fixpoint
        while True:
            dead = np.nonzero(is_leaf & (trans < 0) & (parent >= 0))[0]
            v = parent[dead]
            r, col = np.nonzero(childs[v] == dead[:, None])
            childs[v[r], col] = -1
            none = (childs < 0).all(axis=1)
            none[0] = False
            changed = bool((none & ~is_leaf).any())
            is_leaf |= none
            if not changed:
                break
        # path compression, node by node: a node whose parent v has one
        # child is hung from v's parent, and v marked for removal, up the
        # chain. Child counts do not change here, and a node's parent
        # changes only in its own turn, so only these nodes can start one.
        n_child = (childs >= 0).sum(axis=1)
        cand = np.nonzero(parent >= 0)[0]
        cand = cand[n_child[parent[cand]] == 1]
        for u in cand.tolist():
            if is_leaf[u] and trans[u] < 0:
                continue
            v = int(parent[u])
            while v >= 0 and parent[v] >= 0 and n_child[v] == 1:
                vv = int(parent[v])
                row = childs[vv]
                row[row == v] = u
                parent[u] = vv
                trans[v] = -1
                is_leaf[v] = True
                v = vv

    keep = (~is_leaf) | (trans >= 0)
    keep[0] = True
    order = np.nonzero(keep)[0]
    new_idx = np.full(n, -1, np.int64)
    new_idx[order] = np.arange(len(order))

    def remap(x):
        return np.where(x >= 0, new_idx[np.clip(x, 0, n - 1)], -1)

    center, side = center[order], side[order]
    parent, childs = remap(parent[order]), remap(childs[order])
    is_leaf, trans = is_leaf[order], trans[order]
    wstat, astat, visit = wstat[order], astat[order], visit[order]

    if subdivide:
        # depth-first re-pack: a node, then (a split leaf) its 8 children
        # at once, or (an inner node) its children's subtrees in slot order
        ch_l, leaf_l = childs.tolist(), is_leaf.tolist()
        pre, stack = [], [0]
        while stack:
            u = stack.pop()
            pre.append(u)
            if not leaf_l[u]:
                stack.extend(c for c in reversed(ch_l[u]) if c >= 0)
        pre = np.asarray(pre, np.int64)
        split = is_leaf[pre] & (brute_force | (visit[pre] > 4))
        size = np.where(split, 9, 1)
        nid = np.cumsum(size) - size
        new = np.full(len(side), -1, np.int64)
        new[pre] = nid
        m = int(size.sum())
        o_center = np.zeros((m, 3), np.float32)
        o_side = np.zeros(m, np.float32)
        o_parent = np.full(m, -1, np.int64)
        o_childs = np.full((m, 8), -1, np.int64)
        o_leaf = np.ones(m, bool)
        o_trans = np.zeros(m, np.int32)
        o_w = np.zeros(m, np.int32)
        o_a = np.zeros(m, np.int32)
        o_center[nid], o_side[nid] = center[pre], side[pre]
        o_leaf[nid], o_trans[nid] = is_leaf[pre], trans[pre]
        o_w[nid], o_a[nid] = wstat[pre], astat[pre]
        inner = pre[~is_leaf[pre]]
        r, st = np.nonzero(childs[inner] >= 0)
        p, c = new[inner[r]], new[childs[inner[r], st]]
        o_childs[p, st] = c
        o_parent[c] = p
        sp = nid[split]
        for st in range(8):
            off = np.array([(st >> 2) & 1, (st >> 1) & 1, st & 1], np.float32) - np.float32(0.5)
            k = sp + 1 + st
            o_center[k] = o_center[sp] + o_side[sp][:, None] * np.float32(0.5) * off[None]
            o_side[k] = o_side[sp] * np.float32(0.5)
            o_parent[k] = sp
            o_trans[k], o_w[k], o_a[k] = o_trans[sp], o_w[sp], o_a[sp]
            o_childs[sp, st] = k
        o_leaf[sp] = False
        o_trans[sp] = -1
        o_w[sp] = INIT_NODE_STAT
        o_a[sp] = INIT_NODE_STAT
        center, side, parent, childs = o_center, o_side, o_parent, o_childs
        is_leaf, trans, wstat, astat = o_leaf, o_trans, o_w, o_a

    return dataclasses.replace(
        tree, center=center, side=side, parent=parent.astype(np.int32),
        childs=childs.astype(np.int32), is_leaf=is_leaf, trans_idx=trans.astype(np.int32),
        weight_stats=wstat.astype(np.int32), alpha_stats=astat.astype(np.int32),
        visit_cnt=np.zeros(len(side), np.int32), milestones=list(tree.milestones))


def mark_invisible_nodes(tree: HostTree, intri, w2c, bounds) -> None:
    """Invalidate nodes seen by no camera (MarkInvisibleNodesKernel,
    PersSampler.cu:618-680)."""
    c = tree.center.astype(np.float64)
    radius = tree.side.astype(np.float64) * 0.707
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


def maintain(tree: HostTree, iter_step: int, compact_freq: int, intri, w2c,
             bounds) -> tuple[HostTree, bool]:
    """Milestone subdivision and periodic compaction (UpdateOctNodes tail,
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


# ---------------------------------------------------------------- packing

def build_ropes(tree: HostTree) -> np.ndarray:
    """ropes[u, face]: the same-or-coarser node across leaf u's face
    (axis*2 + (1 if +axis)), or -1 at the domain boundary: found by
    descending from the root to a probe point just across the face."""
    n = tree.n_nodes
    ropes = np.full((n, 6), -1, np.int32)
    leaves = np.nonzero(tree.is_leaf[:n])[0]
    if len(leaves) == 0:
        return ropes
    centers = tree.center[leaves].astype(np.float64)
    sides = tree.side[leaves].astype(np.float64)
    offs = np.zeros((6, 3))
    for ax in range(3):
        offs[2 * ax, ax] = -1.0
        offs[2 * ax + 1, ax] = 1.0
    probes = (centers[:, None, :]
              + offs[None] * (sides * 0.5 * (1.0 + 1e-4))[:, None, None]).reshape(-1, 3)
    tgt_side = np.repeat(sides, 6)
    half_root = tree.side[0] * 0.5 * (1.0 + 1e-9)
    inside_root = np.abs(probes - tree.center[0]).max(axis=1) <= half_root
    u = np.zeros(len(probes), np.int64)
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


def _pad(x: np.ndarray, n: int, fill=0):
    out = np.full((n,) + x.shape[1:], fill, x.dtype)
    out[: x.shape[0]] = x
    return out


def device_fields(tree: HostTree, caps: dict, device) -> dict:
    """The device tree's fields, padded to the capacities ``caps``
    (max_nodes, max_trans, max_edges)."""
    mn, mt, me = caps["max_nodes"], caps["max_trans"], caps["max_edges"]

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=device)

    center, side = _pad(tree.center, mn), _pad(tree.side, mn)
    child = _pad(tree.childs, mn, -1)
    is_leaf = _pad(tree.is_leaf.astype(np.int8), mn, 1) > 0
    rope = _pad(build_ropes(tree), mn, -1)
    return dict(
        center=t(center), side=t(side), child=t(child), is_leaf=t(is_leaf),
        trans_idx=t(_pad(tree.trans_idx, mn, -1)), rope=t(rope),
        node_rec=t(pack_node_records(center, side, child, rope, is_leaf)),
        weight_stats=t(_pad(tree.weight_stats, mn)),
        alpha_stats=t(_pad(tree.alpha_stats, mn)),
        visit_cnt=t(_pad(tree.visit_cnt, mn)),
        w2xz=t(_pad(tree.w2xz.reshape(-1, 96), mt)),
        weight=t(_pad(tree.weight.reshape(-1, 36), mt)),
        t_center=t(_pad(tree.t_center, mt)), t_dis=t(_pad(tree.t_dis, mt, 1.0)),
        edge_t=t(_pad(tree.edge_t, me)), edge_center=t(_pad(tree.edge_center, me)),
        edge_dir0=t(_pad(tree.edge_dir0, me)), edge_dir1=t(_pad(tree.edge_dir1, me)),
        n_edges=int(tree.edge_t.shape[0]), n_nodes=int(tree.n_nodes))


def _grow(caps: dict, tree: HostTree) -> dict:
    return dict(max_nodes=max(caps["max_nodes"], pow2ceil(tree.n_nodes)),
                max_trans=max(caps["max_trans"], pow2ceil(tree.w2xz.shape[0])),
                max_edges=max(caps["max_edges"], pow2ceil(tree.edge_t.shape[0])))


def start_tree(cams: tuple, cfg: dict, seed: int, iter_step: int, device) -> dict:
    """The device tree's fields at ``iter_step``, as the Trainer has them
    before its first step there: the tree built over the train cameras
    ``cams`` (c2w, w2c, intri, bounds) with the warps' seed ``seed``, the
    maintenance due at ``iter_step`` applied, padded to the configuration's
    capacities grown to fit both trees."""
    c2w, w2c, intri, bounds = cams
    ps = cfg["pts_sampler"]
    caps = {k: int(cfg.get("capacity", {}).get(k, v)) for k, v in CAPACITY.items()}
    tree = build_octree(c2w, w2c, intri, bounds, ps, seed, device)
    caps = _grow(caps, tree)
    tree, changed = maintain(tree, iter_step, int(ps.get("compact_freq", 1000)),
                             intri, w2c, bounds)
    if changed:
        caps = _grow(caps, tree)
    return device_fields(tree, caps, device)
