"""The port's sampler against the JAX package, on a JAX-built octree
converted to the port (mirrors tests/test_sampler.py:123-411): octree
build structure, finish_trans_batch, traversal (brute force, distant
origins, grazing rays), the parallel marcher, warps, edge samples, the
occupancy votes and the two flat-buffer compactions.

Tolerances: hit lists and sample counts must be equal; hit distances and
sample positions agree to 1e-5 (XLA may contract a multiply-add into one
FMA where torch rounds twice); warps to rtol 1e-5; PCA warp weights to
1e-3 relative up to an eigenvector's sign (f32 covariances summed in
another order). Occupancy counters are integers and must be equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f2nerf_tpu.render import renderer as jren
from f2nerf_tpu.sampler import device as jdv
from f2nerf_tpu.sampler import octree as joc
from f2nerf_tpu.sampler import warp as jwp
from f2nerf_torch.render import renderer as tren
from f2nerf_torch.sampler import device as tdv
from f2nerf_torch.sampler import octree as toc
from f2nerf_torch.sampler import warp as twp
from f2nerf_torch.utils.convert import octree_from_fields
from test_sampler import CFG, _brute_force_hits, synthetic_rig

CAPS = (4096, 512, 65536)


def T(x):
    return torch.from_numpy(np.array(x, copy=True))


@pytest.fixture(scope="module")
def trees():
    c2w, w2c, intri, bounds = synthetic_rig()
    host = joc.build_octree(c2w, w2c, intri, bounds, CFG, seed=0)
    return host, jdv.to_device_tree(host, *CAPS), tdv.to_device_tree(octree_from_fields(host), *CAPS)


def rays(seed, n, spread=2.0):
    rng = np.random.RandomState(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d, np.full(n, 0.05, np.float32), np.full(n, 1e8, np.float32)


def port_traverse(ttree, o, d, near, far, **kw):
    hi, hn, hf, nh, tr, _ = tdv.traverse(ttree, T(o), T(d), T(near), T(far), **kw)
    return hi.numpy(), hn.numpy(), hf.numpy(), nh.numpy(), tr.numpy()


# ------------------------------------------------------------------ build

def test_build_octree_structure_matches_jax(trees):
    jhost = trees[0]
    c2w, w2c, intri, bounds = synthetic_rig()
    thost = toc.build_octree(c2w, w2c, intri, bounds, CFG, seed=0, device="cpu")
    for f in ("center", "side", "parent", "childs", "is_leaf", "trans_idx", "w2xz",
              "t_center", "t_dis", "weight_stats", "alpha_stats"):
        np.testing.assert_array_equal(getattr(thost, f), getattr(jhost, f), err_msg=f)
    assert thost.milestones == jhost.milestones and thost.side_len == jhost.side_len
    # both builds take the native C++ edge pool: the same edges in the
    # same order (the TV loss picks edges by index)
    assert len(thost.edge_t) > 0
    for f in ("edge_t", "edge_center", "edge_dir0", "edge_dir1"):
        np.testing.assert_array_equal(getattr(thost, f), getattr(jhost, f), err_msg=f)
    np.testing.assert_array_equal(toc.build_ropes(thost), joc.build_ropes(jhost))


def test_finish_trans_batch_matches_jax():
    c2w, _, intri, _ = synthetic_rig(n_cams=12)
    rng = np.random.default_rng(5)
    w2xz, pts = [], []
    for center, side in (((0.0, 0.0, 0.0), 0.8), ((0.3, -0.2, 0.1), 0.5),
                         ((-0.4, 0.4, 0.0), 0.6)):
        center = np.asarray(center)
        w2xz.append(twp.virtual_cams(c2w, intri[0], center, rng)[0])
        pts.append((rng.random((4096, 3)) - 0.5) * side + center)
    w2xz = np.asarray(w2xz, np.float32)
    pts = np.asarray(pts, np.float32)
    got = twp.finish_trans_batch(w2xz, pts, chunk=2)
    want = jwp.finish_trans_batch(w2xz, pts, chunk=2)
    for g, w in zip(got, want):
        for r in range(3):
            d = min(np.abs(g[r] - w[r]).max(), np.abs(g[r] + w[r]).max())
            assert d <= 1e-3 * np.abs(w[r]).max(), (r, g[r], w[r])


def test_virtual_cams_and_distance_summary_match_jax():
    c2w, _, intri, _ = synthetic_rig()
    for seed in range(3):
        a = twp.virtual_cams(c2w, intri[0], np.array([0.1, -0.2, 0.3]),
                             np.random.default_rng(seed))
        b = jwp.virtual_cams(c2w, intri[0], np.array([0.1, -0.2, 0.3]),
                             np.random.default_rng(seed))
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1] == b[1]
    d = np.random.RandomState(0).uniform(0.1, 10, 50)
    assert twp.distance_summary(d) == jwp.distance_summary(d)
    assert twp.distance_summary(np.array([])) == 1e8


def test_device_tree_roundtrip(trees):
    host, jtree, ttree = trees
    for f in ("center", "side", "child", "is_leaf", "trans_idx", "rope",
              "w2xz", "weight", "t_center", "t_dis", "edge_t", "edge_center"):
        np.testing.assert_array_equal(getattr(ttree, f).numpy(), np.asarray(getattr(jtree, f)),
                                      err_msg=f)
    assert ttree.n_edges == int(jtree.n_edges)
    back = tdv.sync_host_tree(octree_from_fields(host), ttree)
    np.testing.assert_array_equal(back.trans_idx, host.trans_idx)


# -------------------------------------------------------------- traversal

def test_traversal_matches_brute_force_and_jax(trees):
    host, jtree, ttree = trees
    o, d, near, far = rays(2, 64, spread=3.0)
    hi, hn, hf, nh, trunc = port_traverse(ttree, o, d, near, far, max_hits=64)
    assert not trunc.any()
    for r in range(len(o)):
        bf = _brute_force_hits(host, o[r], d[r], near[r], far[r])
        got = [(hn[r, k], hf[r, k], hi[r, k]) for k in range(nh[r])]
        assert len(got) == len(bf), f"ray {r}: {len(got)} vs {len(bf)}"
        for (gn, gf, gu), (bn, bfar, bu) in zip(got, bf):
            assert gu == bu, f"ray {r}"
            np.testing.assert_allclose([gn, gf], [bn, bfar], atol=1e-3)
    jhi, jhn, jhf, jnh, _ = map(np.asarray, jdv.traverse(
        jtree, *map(jnp.asarray, (o, d, near, far)), max_hits=64))
    np.testing.assert_array_equal(nh, jnh)
    np.testing.assert_array_equal(hi, jhi)
    np.testing.assert_allclose(hn, jhn, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(hf, jhf, rtol=1e-5, atol=1e-5)


def test_traversal_distant_origin_no_eps_stall(trees):
    """Origins ~4000 units away: ulp(t) exceeds leaf_side * 1e-4; the ulp
    floored eps must keep the hit lists exact, without duplicates."""
    host, _, ttree = trees
    rng = np.random.RandomState(7)
    aim = rng.uniform(-2, 2, (32, 3)).astype(np.float32)
    d = rng.randn(32, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = (aim - 4000.0 * d).astype(np.float32)
    near, far = np.full(32, 0.05, np.float32), np.full(32, 1e8, np.float32)
    hi, _, _, nh, trunc = port_traverse(ttree, o, d, near, far, max_hits=64)
    assert not trunc.any()
    for r in range(32):
        got = [hi[r, k] for k in range(nh[r])]
        assert len(got) == len(set(got)), f"ray {r}: duplicate emits {got}"
        bf = [u for (_, _, u) in _brute_force_hits(host, o[r], d[r], near[r], far[r])]
        assert got == bf, f"ray {r}: {got} vs brute-force {bf}"


def test_traversal_grazing_ray_stalls_escalate(trees):
    """Rays nearly parallel to a face of a culled leaf (tests/test_sampler.py
    grazing-ray regression): the no-progress escalation must finish every
    ray within 600 iterations, without duplicate emits, in brute-force
    order."""
    host = trees[0]
    culled = dataclasses.replace(host)
    culled.trans_idx = host.trans_idx.copy()
    rng = np.random.RandomState(11)
    valid = np.nonzero(culled.trans_idx >= 0)[0]
    kill = rng.choice(valid, size=int(0.6 * len(valid)), replace=False)
    culled.trans_idx[kill] = -1
    ttree = tdv.to_device_tree(octree_from_fields(culled), *CAPS)
    os_, ds_ = [], []
    for u in [u for u in kill if culled.is_leaf[u]][:256]:
        c = culled.center[u].astype(np.float64)
        s = float(culled.side[u])
        for dz in (1e-6, 1e-5, 1e-4, -1e-6, -1e-5):
            dd = np.array([1.0, 0.0, dz])
            dd /= np.linalg.norm(dd)
            face = c[2] + s / 2 if dz > 0 else c[2] - s / 2
            os_.append(np.array([c[0] - 5.0, c[1], face - np.sign(dz) * 3e-6 - dd[2] * 5.0]))
            ds_.append(dd)
    o, d = np.asarray(os_, np.float32), np.asarray(ds_, np.float32)
    n = len(o)
    near, far = np.full(n, 0.05, np.float32), np.full(n, 1e8, np.float32)
    hi, _, _, nh, trunc = port_traverse(ttree, o, d, near, far, max_hits=64, max_iters=600)
    assert not trunc.any(), f"{int(trunc.sum())}/{n} grazing rays stalled"
    for r in range(n):
        got = [hi[r, k] for k in range(nh[r])]
        assert len(got) == len(set(got)), f"ray {r}: duplicate emits {got}"
        it = iter(u for (_, _, u) in _brute_force_hits(culled, o[r], d[r], near[r], far[r]))
        assert all(g in it for g in got), f"ray {r}"


# ---------------------------------------------------------------- marching

@pytest.mark.parametrize("scale_by_dis", [False, True])
def test_ray_march_parallel_matches_jax(trees, scale_by_dis):
    _, jtree, ttree = trees
    o, d, near, far = rays(4, 48)
    hits = jdv.traverse(jtree, *map(jnp.asarray, (o, d, near, far)), max_hits=64)[:4]
    max_s = 256
    jit = np.random.RandomState(5).uniform(1e-4, 1.0, (48, max_s)).astype(np.float32)
    want = list(map(np.asarray, jdv.ray_march_parallel(
        jtree, jnp.asarray(o), jnp.asarray(d), *hits, jnp.asarray(jit), jnp.asarray(2.0),
        1.0 / 64, scale_by_dis, max_s)))
    got = [t.numpy() for t in tdv.ray_march_parallel(
        ttree, T(o), T(d), *(T(np.asarray(h)) for h in hits), T(jit), torch.tensor(2.0),
        1.0 / 64, scale_by_dis, max_s)]
    assert (want[3] > 0).any()
    np.testing.assert_array_equal(got[3], want[3])          # n_samples
    np.testing.assert_array_equal(got[2], want[2])          # out_node
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)   # out_t
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-7)   # out_dt
    np.testing.assert_allclose(got[4], want[4], rtol=1e-6)             # first_oct


def test_ray_march_parallel_reference_density(trees):
    """jitter == 1: samples at near_h + (k+1)*step_h inside their hit, and
    warp-space dt == sample_l exactly."""
    _, _, ttree = trees
    o, d, near, far = rays(4, 16)
    hi, hn, hf, nh, _, _ = tdv.traverse(ttree, T(o), T(d), T(near), T(far), max_hits=64)
    max_s, sample_l = 256, 1.0 / 64
    out_t, out_dt, out_node, n_s, _ = (x.numpy() for x in tdv.ray_march_parallel(
        ttree, T(o), T(d), hi, hn, hf, nh, torch.ones((16, max_s)), torch.tensor(1.0),
        sample_l, False, max_s))
    hi, hn, hf, nh = hi.numpy(), hn.numpy(), hf.numpy(), nh.numpy()
    assert (n_s > 0).any()
    for r in range(16):
        k = n_s[r]
        if k == 0:
            continue
        np.testing.assert_allclose(out_dt[r, :k], sample_l, rtol=1e-4)
        assert (np.diff(out_t[r, :k]) > 0).all()
        for s in range(k):
            j = list(hi[r, :nh[r]]).index(out_node[r, s])
            assert hn[r, j] - 1e-4 <= out_t[r, s] <= hf[r, j] + 1e-4


def test_ray_march_parallel_degenerate_invalid_hits_stay_finite():
    """Hit slots past n_hits evaluate a degenerate warp (b == 0) at the
    origin; the nan must not reach the valid samples."""
    w2xz = np.zeros((1, 12, 2, 4), np.float32)
    w2xz[0, :, 0, :3] = [1.0, 0.0, 0.0]
    w2xz[0, :, 1, :3] = [0.0, 0.0, 1.0]
    weight = np.zeros((1, 3, 12), np.float32)
    weight[0, 0, 0] = weight[0, 1, 1] = weight[0, 2, 2] = 1.0
    host = toc.OctreeHost(
        center=np.array([[0.0, 0.0, -2.0]], np.float32), side=np.array([1.0], np.float32),
        parent=np.array([-1], np.int32), childs=np.full((1, 8), -1, np.int32),
        is_leaf=np.array([True]), trans_idx=np.array([0], np.int32),
        weight_stats=np.full(1, 1000, np.int32), alpha_stats=np.full(1, 1000, np.int32),
        visit_cnt=np.zeros(1, np.int32), w2xz=w2xz, weight=weight,
        t_center=np.array([[0.0, 0.0, -2.0]], np.float32), t_dis=np.array([1.0], np.float32),
        edge_t=np.zeros((0, 2), np.int32), edge_center=np.zeros((0, 3), np.float32),
        edge_dir0=np.zeros((0, 3), np.float32), edge_dir1=np.zeros((0, 3), np.float32),
        side_len=1.0)
    ttree = tdv.to_device_tree(host, 8, 8, 8)
    o = torch.tensor([[0.3, 0.0, 0.0]])
    dnp = np.array([[-0.05, 0.0, -1.0]], np.float32)
    d = T(dnp / np.linalg.norm(dnp))
    hi, hn, hf, nh, _, _ = tdv.traverse(ttree, o, d, torch.tensor([0.01]),
                                        torch.tensor([1e8]), max_hits=4)
    assert int(nh[0]) == 1
    out_t, out_dt, _, n_s, _ = tdv.ray_march_parallel(
        ttree, o, d, hi, hn, hf, nh, torch.ones((1, 64)), torch.tensor(1.0),
        1.0 / 16, False, 64)
    assert int(n_s[0]) > 0
    assert torch.isfinite(out_t).all() and torch.isfinite(out_dt).all()
    np.testing.assert_allclose(out_dt[0, :int(n_s[0])].numpy(), 1.0 / 16, rtol=1e-4)


# ------------------------------------------------------------ warps, edges

def test_apply_warp_and_jacobian_match_jax(trees):
    _, jtree, ttree = trees
    rng = np.random.RandomState(8)
    valid = np.nonzero(np.asarray(jtree.trans_idx) >= 0)[0]
    nodes = rng.choice(valid, 256)
    tr = np.asarray(jtree.trans_idx)[nodes].astype(np.int32)
    pts = (np.asarray(jtree.center)[nodes]
           + (rng.rand(256, 3) - 0.5) * np.asarray(jtree.side)[nodes][:, None]).astype(np.float32)
    dirs = rng.randn(256, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    np.testing.assert_allclose(tdv.apply_warp(ttree, T(tr), T(pts)).numpy(),
                               np.asarray(jdv.apply_warp(jtree, jnp.asarray(tr), jnp.asarray(pts))),
                               rtol=1e-5, atol=1e-5)
    m_j, w_j = jdv._warp_rows(jtree, jnp.asarray(tr))
    m_t, w_t = tdv._warp_rows(ttree, T(tr))
    np.testing.assert_allclose(
        tdv.warp_jac_dir(m_t, w_t, T(pts), T(dirs)).numpy(),
        np.asarray(jdv.warp_jac_dir(m_j, w_j, jnp.asarray(pts), jnp.asarray(dirs))),
        rtol=1e-5)


def test_sample_edges_matches_jax(trees):
    _, jtree, ttree = trees
    key = jax.random.PRNGKey(3)
    k1, k2 = jax.random.split(key)
    e = jax.random.randint(k1, (128,), 0, jnp.maximum(jtree.n_edges, 1))
    coord = jax.random.uniform(k2, (128, 2)) * 2.0 - 1.0
    pts_j, idx_j = jdv.sample_edges(jtree, key, 128)
    pts_t, idx_t = tdv.sample_edges(ttree, T(np.asarray(e)), T(np.asarray(coord)))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(pts_t.numpy(), np.asarray(pts_j), rtol=1e-5, atol=1e-5)
    g = torch.Generator().manual_seed(0)
    e2, c2 = tdv.draw_edges(ttree, g, 64)
    assert int(e2.max()) < ttree.n_edges and float(c2.abs().max()) <= 1.0


# ---------------------------------------------------------------- occupancy

def test_occupancy_adders_match_jax(trees):
    _, jtree, ttree = trees
    rng = np.random.RandomState(9)
    n_rays, cap = 32, 1024
    counts = rng.randint(0, 40, n_rays)
    rid = np.repeat(np.arange(n_rays), counts)[:cap]
    valid_nodes = np.nonzero(np.asarray(jtree.trans_idx) >= 0)[0]
    node = np.sort(rng.choice(valid_nodes, len(rid))).astype(np.int32)
    node[rng.rand(len(rid)) < 0.05] = -1
    pad = cap - len(rid)
    rid = np.concatenate([rid, np.full(pad, n_rays)]).astype(np.int32)
    node = np.concatenate([node, np.full(pad, -1)]).astype(np.int32)
    w = rng.uniform(0, 0.05, cap).astype(np.float32)
    a = rng.uniform(0, 0.1, cap).astype(np.float32)
    occ_j = jdv.compute_occupancy_adders(jtree, *map(jnp.asarray, (node, rid, w, a)), n_rays)
    occ_t = tdv.compute_occupancy_adders(ttree, *map(T, (node, rid, w, a)), n_rays)
    for k in occ_j:
        np.testing.assert_array_equal(occ_t[k].numpy(), np.asarray(occ_j[k]), err_msg=k)
    tj = jdv.apply_occupancy_adders(jtree, occ_j)
    tt = tdv.apply_occupancy_adders(ttree, occ_t)
    for k in ("weight_stats", "alpha_stats", "visit_cnt", "trans_idx"):
        np.testing.assert_array_equal(getattr(tt, k).numpy(), np.asarray(getattr(tj, k)), err_msg=k)


def test_update_occupancy_invalidates_dead_nodes(trees):
    _, _, ttree = trees
    valid = np.nonzero(ttree.trans_idx.numpy() >= 0)[0]
    u_dead, u_live = int(valid[0]), int(valid[1])
    n_rays, cap = 4, 64
    node = np.full(cap, -1, np.int32)
    rid = np.full(cap, n_rays, np.int32)
    w = np.zeros(cap, np.float32)
    node[:8], node[8:16], rid[:16] = u_dead, u_live, 0
    w[:8], w[8:16] = 1e-6, 0.5
    args = (T(node), T(rid), T(w), T(w.copy()))
    t2 = ttree
    for _ in range(1200):  # INIT_NODE_STAT = 1000 decrements of -1
        t2 = tdv.apply_occupancy_adders(t2, tdv.compute_occupancy_adders(t2, *args, n_rays))
        if int(t2.trans_idx[u_dead]) < 0:
            break
    assert int(t2.trans_idx[u_dead]) == -1 and int(t2.trans_idx[u_live]) >= 0
    assert int(t2.weight_stats[u_live]) >= toc.INIT_NODE_STAT
    assert int(t2.visit_cnt[u_dead]) == 8


# ---------------------------------------------------------------- compaction

@pytest.mark.parametrize("n_rays,max_s,cap", [(8, 16, 64), (100, 32, 512), (100, 32, 128),
                                              (130, 8, 1024), (64, 4, 16)])
def test_compactions_match_jax(n_rays, max_s, cap):
    rng = np.random.default_rng(7 + n_rays + cap)
    n_s = rng.integers(0, max_s + 1, n_rays).astype(np.int32)
    n_s[rng.integers(0, n_rays, 3)] = 0
    n_s[-2:] = 0
    t = rng.random((n_rays, max_s)).astype(np.float32).reshape(-1)
    node = rng.integers(0, 999, (n_rays, max_s)).astype(np.int32).reshape(-1)
    pos = np.arange(max_s, dtype=np.int32)
    valid = (pos[None, :] < n_s[:, None]).reshape(-1)
    ref, rid_ref, ok_ref, idx_ref = jren._compact(
        jnp.asarray(valid), cap, dict(t=jnp.asarray(t), node=jnp.asarray(node)), n_rays,
        max_s=max_s)
    fields = dict(t=T(t), node=T(node))
    for out, rid, ok, _ in (tren._compact(T(valid), cap, fields, n_rays, max_s=max_s),
                            tren._compact_rowpacked(T(n_s), cap, fields, n_rays, max_s)):
        np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_ref))
        np.testing.assert_array_equal(rid.numpy(), np.asarray(rid_ref))
        for k in fields:
            np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))
    # the fill index the cached-B gather relies on (padding -> n - 1)
    _, _, _, idx = tren._compact(T(valid), cap, fields, n_rays, max_s=max_s)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_ref))
    # keep-set compaction with a ray-id source (A -> B)
    keep = rng.random(len(valid)) < 0.5
    rid_src = (np.arange(len(valid)) // max_s).astype(np.int32)
    jb = jren._compact(jnp.asarray(keep), cap, dict(t=jnp.asarray(t)), n_rays,
                       ray_id_src=jnp.asarray(rid_src))
    tb = tren._compact(T(keep), cap, dict(t=T(t)), n_rays, ray_id_src=T(rid_src))
    np.testing.assert_array_equal(tb[1].numpy(), np.asarray(jb[1]))
    np.testing.assert_array_equal(tb[3].numpy(), np.asarray(jb[3]))
    np.testing.assert_array_equal(tb[0]["t"].numpy(), np.asarray(jb[0]["t"]))
