"""Kernels K12 (``compact_a_warp``, ``sample_edges``) and K13
(``compact_keep``) of the port: their plain versions against the JAX
package on the CPU, buffer A's ray offsets (``compact_a_warp``'s fourth
output) against ``ray_offsets_plain`` of A's ray ids, buffer B's segments
(``compact_keep``'s fifth output) against JAX's ``local_index``,
``segment_sum`` of ones and ``first_flags_from_ray_id`` of B's ray ids,
the wrappers' routing and refusals, and on the card (``cuda`` marker,
skipped without one) each kernel against its plain version, A's offsets
against the offsets launch and the given-offsets launch on them.

Inputs come from numpy seeds on a JAX-built octree converted to the port
(tests/test_sampler.py's synthetic rig): dense marcher buffers with empty
rays, padding past the total and a total past the capacity; nodes whose
leaf row is -1 (the root, culled leaves); rays that start at or past the
capacity; keep flags with nothing kept, everything kept and an overflow
past cap2, no padding row in A, rays with no row, one ray, B exactly
full.

Tolerances:
  * compactions, ray ids, ray offsets, nodes, leaf rows and directions
    (copies and integers): exact;
  * the warped points against JAX: rtol 1e-5, atol 1e-5 (XLA may contract
    a multiply-add into one FMA where torch rounds twice, as
    tests/test_torch_sampler.py's warp test);
  * on the card, every kernel output against its plain version on the
    card: bit for bit (the floats compared as their int32 bits, so a NaN
    of the degenerate warp must be the same NaN), and a repeated launch
    the same bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f2nerf_tpu.render import renderer as jren
from f2nerf_tpu.sampler import device as jdv
from f2nerf_tpu.sampler import octree as joc
from f2nerf_torch.ops.segment import ray_offsets, ray_offsets_plain
from f2nerf_torch.render import renderer as tren
from f2nerf_torch.sampler import device as tdv
from f2nerf_torch.sampler.octree import OctreeHost
from f2nerf_torch.utils.convert import octree_from_fields
from test_sampler import CFG, synthetic_rig

CAPS = (4096, 512, 65536)
WARP_RTOL = WARP_ATOL = 1e-5
A_FIELDS = ("t", "dt", "node", "trans", "pts01", "dirs")


def T(x):
    return torch.from_numpy(np.array(x, copy=True))


def bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(bits(a), bits(b))


@pytest.fixture(scope="module")
def trees():
    c2w, w2c, intri, bounds = synthetic_rig()
    host = joc.build_octree(c2w, w2c, intri, bounds, CFG, seed=0)
    return host, jdv.to_device_tree(host, *CAPS), tdv.to_device_tree(octree_from_fields(host), *CAPS)


def dense_case(jtree, seed: int, n_rays: int, max_s: int):
    """A marcher's dense output: n_s (three empty rays and the last two),
    out_t / out_dt / out_node [R, max_s] (samples in each row's first
    n_s slots; the rest as the marcher leaves it, 0 / 0 / -1), rays from
    valid leaves' centers (t within half a root side), a tenth of the
    samples at nodes whose leaf row is -1."""
    rng = np.random.RandomState(seed)
    trans = np.asarray(jtree.trans_idx)
    leaves = np.nonzero(trans >= 0)[0]
    dead = np.nonzero(trans < 0)[0][:64]
    n_s = rng.randint(0, max_s + 1, n_rays).astype(np.int32)
    n_s[rng.randint(0, n_rays, 3)] = 0
    n_s[-2:] = 0
    pos = np.arange(max_s)[None, :]
    live = pos < n_s[:, None]
    node = rng.choice(leaves, (n_rays, max_s)).astype(np.int32)
    node[rng.rand(n_rays, max_s) < 0.1] = rng.choice(dead)
    side0 = float(np.asarray(jtree.side)[0])
    out_t = np.where(live, rng.uniform(0, 0.5 * side0, (n_rays, max_s)), 0).astype(np.float32)
    out_dt = np.where(live, rng.uniform(0, 0.05, (n_rays, max_s)), 0).astype(np.float32)
    out_node = np.where(live, node, -1).astype(np.int32)
    o = np.asarray(jtree.center)[rng.choice(leaves, n_rays)].astype(np.float32)
    d = rng.randn(n_rays, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return n_s, out_t, out_dt, out_node, o, d


def jax_compact_a_warp(jtree, n_s, out_t, out_dt, out_node, o, d, cap):
    """The JAX renderer's A side, renderer.py:223-240, op by op."""
    R, max_s = out_t.shape
    a, rid_a, ok_a, _ = jren._compact_rowpacked(
        jnp.asarray(n_s), cap, dict(t=jnp.asarray(out_t).reshape(-1),
                                    dt=jnp.asarray(out_dt).reshape(-1),
                                    node=jnp.asarray(out_node).reshape(-1)), R, max_s=max_s)
    o, d = jnp.asarray(o), jnp.asarray(d)
    rid_ac = jnp.minimum(rid_a, R - 1)
    node_a = jnp.where(ok_a, a["node"], 0)
    trans_a = jnp.maximum(jtree.trans_idx[node_a], 0)
    xyz_a = o[rid_ac] + d[rid_ac] * a["t"][:, None]
    warp_a = jdv.apply_warp(jtree, trans_a, xyz_a)
    pts01_a = jnp.where(ok_a[:, None], (warp_a + 1.0) * 0.5, 0.5)
    return (dict(t=a["t"], dt=a["dt"], node=a["node"], trans=trans_a, pts01=pts01_a,
                 dirs=d[rid_ac]), rid_a, ok_a)


A_CASES = [(8, 16, 64), (100, 32, 1024), (100, 32, 256), (130, 8, 2048), (64, 4, 16)]


def offsets_want(n_s: np.ndarray, cap: int) -> np.ndarray:
    """Ray r's first slot of A: the samples before it, at most cap (a ray
    that starts at or past cap has none), and the first padding slot."""
    return np.minimum(np.concatenate([[0], np.cumsum(n_s)]), cap).astype(np.int32)


def offsets_case(jtree, mode: str, n_rays: int, max_s: int, cap: int):
    """dense_case with n_s by ``mode``: 'step' (U[0, 143), the slice
    step's mean of ~71 samples a ray, under cap), 'zeros' (a fifth of the
    rays with samples, the first and last empty), 'overflow' (U[0, max_s],
    past cap: the later rays start past it), 'exact' (the total is cap),
    'first_past' (the first ray alone fills cap)."""
    case = list(dense_case(jtree, 23 + n_rays, n_rays, max_s))
    rng = np.random.RandomState(n_rays + cap)
    n_s = case[0]
    if mode == "step":
        n_s = rng.randint(0, min(143, max_s + 1), n_rays)
    elif mode == "zeros":
        n_s = np.where(rng.rand(n_rays) < 0.2, rng.randint(1, max_s + 1, n_rays), 0)
        n_s[[0, -1]] = 0
    elif mode == "overflow":
        n_s = rng.randint(0, max_s + 1, n_rays)
    elif mode == "exact":
        n_s = np.full(n_rays, cap // n_rays)
        n_s[: cap % n_rays] += 1
    elif mode == "first_past":
        n_s = np.full(n_rays, max_s)
    n_s = n_s.astype(np.int32)
    live = np.arange(max_s)[None, :] < n_s[:, None]
    case[0] = n_s
    case[1] = np.where(live, case[1], 0).astype(np.float32)
    case[2] = np.where(live, case[2], 0).astype(np.float32)
    case[3] = np.where(live, case[3], -1).astype(np.int32)
    return tuple(case)


OFFSET_CASES = [("step", 2048, 512, 262144), ("zeros", 64, 16, 512),
                ("overflow", 2048, 512, 262144), ("exact", 100, 32, 1600),
                ("first_past", 8, 64, 16)]


# ------------------------------------------------------------------ K12 (CPU)

@pytest.mark.parametrize("n_rays,max_s,cap", A_CASES)
def test_compact_a_warp_plain_matches_jax(trees, n_rays, max_s, cap):
    _, jtree, ttree = trees
    case = dense_case(jtree, 11 + n_rays + cap, n_rays, max_s)
    want, rid_j, ok_j = jax_compact_a_warp(jtree, *case, cap)
    got, rid_t, ok_t, off_t = tren.compact_a_warp_plain(ttree, *map(T, case), cap)
    total = int(case[0].sum())
    assert int(ok_t.sum()) == min(total, cap)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(rid_t.numpy(), np.asarray(rid_j))
    np.testing.assert_array_equal(off_t.numpy(), offsets_want(case[0], cap))
    for k in A_FIELDS:
        if k == "pts01":
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=WARP_RTOL, atol=WARP_ATOL, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    # the padding slots as the cached-B fill index reads them
    pad = ~ok_t
    if bool(pad.any()):
        assert bool((got["pts01"][pad] == 0.5).all())
        assert bool((rid_t[pad] == n_rays).all()) and bool((got["node"][pad] == 0).all())
        assert bool((got["dirs"][pad] == T(case[5][-1])).all())


@pytest.mark.parametrize("mode,n_rays,max_s,cap", OFFSET_CASES)
def test_compact_a_warp_offsets(trees, mode, n_rays, max_s, cap):
    """A's offsets equal ray_offsets_plain of A's ray ids (the offsets
    launch's plain version), with empty rays and rays that start at or past
    the capacity."""
    _, jtree, ttree = trees
    case = offsets_case(jtree, mode, n_rays, max_s, cap)
    _, rid, ok, off = tren.compact_a_warp_plain(ttree, *map(T, case), cap)
    assert off.dtype == torch.int32 and tuple(off.shape) == (n_rays + 1,)
    assert torch.equal(off, ray_offsets_plain(rid, n_rays)[0])
    np.testing.assert_array_equal(off.numpy(), offsets_want(case[0], cap))
    assert int(off[-1]) == int(ok.sum())
    starts = np.concatenate([[0], np.cumsum(case[0])])[:-1]
    if mode in ("overflow", "first_past"):
        assert (starts >= cap).any() and bool((off[:-1][T(starts >= cap)] == cap).all())
    if mode == "zeros":
        assert (case[0] == 0).sum() > n_rays // 2


def test_compact_a_warp_routes_cpu_to_plain(trees):
    _, jtree, ttree = trees
    case = tuple(map(T, dense_case(jtree, 3, 40, 16)))
    got = tren.compact_a_warp(ttree, *case, 512)
    want = tren.compact_a_warp_plain(ttree, *case, 512)
    for k in A_FIELDS:
        assert same_bits(got[0][k], want[0][k]), k
    assert all(torch.equal(g, w) for g, w in zip(got[1:], want[1:]))


@pytest.mark.parametrize("bad", ["n_s_int64", "rays_f64", "node_shape", "n_s_shape", "meta"])
def test_compact_a_warp_refuses(trees, bad):
    _, jtree, ttree = trees
    n_s, out_t, out_dt, out_node, o, d = map(T, dense_case(jtree, 4, 16, 8))
    if bad == "n_s_int64":
        n_s = n_s.long()
    elif bad == "rays_f64":
        o = o.double()
    elif bad == "node_shape":
        out_node = out_node[:, :4].contiguous()
    elif bad == "n_s_shape":
        n_s = n_s[:8]
    else:
        n_s, out_t, out_dt, out_node, o, d = (x.to("meta") for x in (n_s, out_t, out_dt,
                                                                      out_node, o, d))
    with pytest.raises(ValueError):
        tren.compact_a_warp(ttree, n_s, out_t, out_dt, out_node, o, d, 64)


def test_sample_edges_plain_matches_jax(trees):
    """From the draws JAX's sample_edges makes (its key split and draws,
    device.py:654-656), with picks at both ends of the edge range."""
    import jax
    _, jtree, ttree = trees
    key = jax.random.PRNGKey(17)
    k1, k2 = jax.random.split(key)
    n = 512
    e = jax.random.randint(k1, (n,), 0, jnp.maximum(jtree.n_edges, 1))
    coord = jax.random.uniform(k2, (n, 2)) * 2.0 - 1.0
    pts_j, idx_j = jdv.sample_edges(jtree, key, n)
    e, coord = T(np.asarray(e)), T(np.asarray(coord))
    pts_t, idx_t = tdv.sample_edges_plain(ttree, e, coord)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(pts_t.numpy(), np.asarray(pts_j), rtol=WARP_RTOL, atol=WARP_ATOL)
    got = tdv.sample_edges(ttree, e, coord)
    assert same_bits(got[0], pts_t) and torch.equal(got[1], idx_t)


@pytest.mark.parametrize("bad", ["idx_int64", "coord_shape", "coord_f64", "meta"])
def test_sample_edges_refuses(trees, bad):
    _, _, ttree = trees
    e = torch.zeros((8,), dtype=torch.int32)
    coord = torch.zeros((8, 2))
    if bad == "idx_int64":
        e = e.long()
    elif bad == "coord_shape":
        coord = torch.zeros((8, 3))
    elif bad == "coord_f64":
        coord = coord.double()
    else:
        e, coord = e.to("meta"), coord.to("meta")
    with pytest.raises(ValueError):
        tdv.sample_edges(ttree, e, coord)


# ------------------------------------------------------------------ K13 (CPU)

def keep_case(seed: int, n: int, mode: str):
    """A's fields over n rows (ray-sorted ray ids with padding past the
    last sample) and keep flags: 'half' (a random half), 'none', 'all';
    with a random half kept: 'nopad' (no padding row in A), 'gaps' (rays
    with no row: only every third ray has rows), 'one_ray' (n_rays 1),
    'step' (2,048 rays of U[0, 192) rows, as the slice's buffer A)."""
    rng = np.random.RandomState(seed)
    n_rays = {"one_ray": 1, "step": 2048}.get(mode, 37)
    if mode == "step":
        rid = np.repeat(np.arange(n_rays), rng.randint(0, 192, n_rays))[:n]
        rid = np.concatenate([rid, np.full(n - rid.shape[0], n_rays)]).astype(np.int32)
    elif mode == "gaps":
        rid = np.sort(rng.choice(np.arange(0, n_rays, 3), n)).astype(np.int32)
    else:
        rid = np.sort(rng.randint(0, n_rays, n)).astype(np.int32)
    if mode not in ("nopad", "step"):
        rid[-n // 5:] = n_rays
    fields = dict(t=rng.rand(n).astype(np.float32), dt=rng.rand(n).astype(np.float32),
                  node=rng.randint(0, 999, n).astype(np.int32),
                  trans=rng.randint(0, 50, n).astype(np.int32),
                  pts01=rng.rand(n, 3).astype(np.float32),
                  dirs=rng.randn(n, 3).astype(np.float32))
    keep = {"none": np.zeros(n, bool), "all": np.ones(n, bool)}.get(
        mode, rng.rand(n) < 0.5) & (rid < n_rays)
    return keep, fields, rid, n_rays


KEEP_CASES = [(1000, 700, "half"), (1000, 200, "half"), (1000, 300, "none"),
              (1000, 300, "all"), (1000, 900, "all"), (1, 4, "all")]
# B's segments also at: no padding in A, rays with no row, n_rays 1, and B
# exactly full (cap None: the kept count)
SEG_CASES = KEEP_CASES + [(1000, 700, "nopad"), (1000, 200, "nopad"), (1000, None, "nopad"),
                          (1000, 700, "gaps"), (1000, None, "half"), (1000, 300, "one_ray"),
                          (1000, 1000, "step")]


def keep_args(n: int, cap, mode: str, dev=None):
    """keep_case as compact_keep's arguments (cap None: the kept count)."""
    keep, fields, rid, n_rays = keep_case(n + (cap or 0), n, mode)
    cap = cap or int(keep.sum())
    return (T(keep).to(dev), cap, {k: T(v).to(dev) for k, v in fields.items()},
            T(rid).to(dev), n_rays)


@pytest.mark.parametrize("n,cap,mode", KEEP_CASES)
def test_compact_keep_plain_matches_jax(n, cap, mode):
    keep, fields, rid, n_rays = keep_case(n + cap, n, mode)
    jb, rid_j, ok_j, idx_j = jren._compact(
        jnp.asarray(keep), cap, {k: jnp.asarray(v) for k, v in fields.items()}, n_rays,
        ray_id_src=jnp.asarray(rid))
    tb, rid_t, ok_t, idx_t, seg_t = tren.compact_keep_plain(
        T(keep), cap, {k: T(v) for k, v in fields.items()}, T(rid), n_rays)
    assert int(ok_t.sum()) == min(int(keep.sum()), cap)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(rid_t.numpy(), np.asarray(rid_j))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    for k in fields:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]), err_msg=k)
    got = tren.compact_keep(T(keep), cap, {k: T(v) for k, v in fields.items()}, T(rid), n_rays)
    assert all(same_bits(got[0][k], tb[k]) for k in fields)
    assert all(torch.equal(g, w) for g, w in zip(got[1:4], (rid_t, ok_t, idx_t)))
    assert all(torch.equal(g, w) for g, w in zip(got[4], seg_t))


@pytest.mark.parametrize("n,cap,mode", SEG_CASES)
def test_compact_keep_segments_match_jax(n, cap, mode):
    """B's segments from compact_keep_plain against the JAX package on the
    same inputs: ``_compact``, then ``local_index``, ``segment_sum`` of ones
    and ``first_flags_from_ray_id`` of B's ray ids (and the offsets as a
    searchsorted over them, each ray's first slot)."""
    from f2nerf_tpu.ops import segment as jseg
    keep, cap, fields, rid, n_rays = keep_args(n, cap, mode)
    _, rid_j, _, _ = jren._compact(jnp.asarray(keep.numpy()), cap,
                                   {k: jnp.asarray(v.numpy()) for k, v in fields.items()},
                                   n_rays, ray_id_src=jnp.asarray(rid.numpy()))
    _, rid_t, ok_t, _, (offsets, counts, local, first) = tren.compact_keep_plain(
        keep, cap, fields, rid, n_rays)
    assert (offsets.dtype, counts.dtype, local.dtype, first.dtype) == \
        (torch.int32, torch.float32, torch.int32, torch.bool)
    assert tuple(offsets.shape) == (n_rays + 1,) and tuple(local.shape) == (cap,)
    np.testing.assert_array_equal(rid_t.numpy(), np.asarray(rid_j))
    np.testing.assert_array_equal(local.numpy(), np.asarray(jseg.local_index(rid_j, n_rays)))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jseg.segment_sum(
        jnp.ones(rid_j.shape, jnp.float32), rid_j, n_rays)))
    np.testing.assert_array_equal(first.numpy(),
                                  np.asarray(jseg.first_flags_from_ray_id(rid_j, n_rays)))
    np.testing.assert_array_equal(offsets.numpy(),
                                  np.searchsorted(np.asarray(rid_j), np.arange(n_rays + 1)))
    m = int(ok_t.sum())
    assert int(offsets[-1]) == m == min(int(keep.sum()), cap)
    if mode == "gaps":
        assert bool((counts == 0).any())
    if cap == m:                                   # B exactly full: no padding slot
        assert bool(ok_t.all())


@pytest.mark.parametrize("bad", ["keep_int", "rid_int64", "missing_field", "pts_shape", "meta"])
def test_compact_keep_refuses(bad):
    keep, fields, rid, n_rays = keep_case(5, 64, "half")
    keep, rid = T(keep), T(rid)
    fields = {k: T(v) for k, v in fields.items()}
    if bad == "keep_int":
        keep = keep.to(torch.int32)
    elif bad == "rid_int64":
        rid = rid.long()
    elif bad == "missing_field":
        del fields["dirs"]
    elif bad == "pts_shape":
        fields["pts01"] = fields["pts01"][:, :2].contiguous()
    else:
        keep, rid = keep.to("meta"), rid.to("meta")
        fields = {k: v.to("meta") for k, v in fields.items()}
    with pytest.raises(ValueError):
        tren.compact_keep(keep, 32, fields, rid, n_rays)


# ------------------------------------------------------------------ the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def tree_on(tree: tdv.DeviceTree, dev) -> tdv.DeviceTree:
    import dataclasses
    return dataclasses.replace(tree, **{f.name: getattr(tree, f.name).to(dev)
                                        for f in dataclasses.fields(tree)
                                        if torch.is_tensor(getattr(tree, f.name))})


def degenerate_tree(dev) -> tdv.DeviceTree:
    """One leaf whose warp is degenerate: projection 0 is x / z and the
    others x / 1, and every axis is projection 0 (the others weigh 0), so a
    point at z = 0 warps to +-inf (x != 0) or NaN (x = 0) on every axis."""
    w2xz = np.zeros((1, 12, 2, 4), np.float32)
    w2xz[0, :, 0, :3] = [1.0, 0.0, 0.0]
    w2xz[0, 0, 1, :3] = [0.0, 0.0, 1.0]
    w2xz[0, 1:, 1, 3] = 1.0
    weight = np.zeros((1, 3, 12), np.float32)
    weight[0, :, 0] = 1.0
    f32 = np.float32
    host = OctreeHost(
        center=np.array([[0.0, 0.0, 0.0]], f32), side=np.array([2.0], f32),
        parent=np.array([-1], np.int32), childs=np.full((1, 8), -1, np.int32),
        is_leaf=np.array([True]), trans_idx=np.array([0], np.int32),
        weight_stats=np.full(1, 1000, np.int32), alpha_stats=np.full(1, 1000, np.int32),
        visit_cnt=np.zeros(1, np.int32), w2xz=w2xz, weight=weight,
        t_center=np.zeros((1, 3), f32), t_dis=np.array([1.0], f32),
        edge_t=np.zeros((1, 2), np.int32), edge_center=np.zeros((1, 3), f32),
        edge_dir0=np.array([[1.0, 0.0, 0.0]], f32), edge_dir1=np.array([[0.0, 1.0, 0.0]], f32),
        side_len=2.0)
    return tdv.to_device_tree(host, 8, 8, 8, device=dev)


def _a_on_card(tree, case, cap):
    """K12's compact_a_warp twice and its plain version, on the card: the
    same bits; A's offsets also those of the offsets launch."""
    got = tren.compact_a_warp(tree, *case, cap)
    again = tren.compact_a_warp(tree, *case, cap)
    want = tren.compact_a_warp_plain(tree, *case, cap)
    R = case[0].shape[0]
    launch = ray_offsets(got[1], R)
    given = ray_offsets(got[1], R, got[3])
    torch.cuda.synchronize()
    for k in A_FIELDS:
        assert same_bits(got[0][k], want[0][k]), k
        assert same_bits(got[0][k], again[0][k]), k
    for i in (1, 2, 3):
        assert torch.equal(got[i], want[i]) and torch.equal(got[i], again[i])
    assert torch.equal(got[3], launch[0])
    # the given-offsets launch (the single-pass step's) on A's offsets
    for g, w in zip(given, ray_offsets_plain(want[1], R)):
        assert torch.equal(g, w)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("n_rays,max_s,cap", A_CASES + [(2048, 512, 393216), (3000, 64, 65536)])
def test_compact_a_warp_on_card(trees, cuda, n_rays, max_s, cap):
    _, jtree, ttree = trees
    case = tuple(T(x).to(cuda) for x in dense_case(jtree, 5 + n_rays, n_rays, max_s))
    _a_on_card(tree_on(ttree, cuda), case, cap)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,n_rays,max_s,cap", OFFSET_CASES + [("overflow", 4096, 512, 65536)])
def test_compact_a_warp_offsets_on_card(trees, cuda, mode, n_rays, max_s, cap):
    _, jtree, ttree = trees
    case = tuple(T(x).to(cuda) for x in offsets_case(jtree, mode, n_rays, max_s, cap))
    _, _, _, off = _a_on_card(tree_on(ttree, cuda), case, cap)
    np.testing.assert_array_equal(off.cpu().numpy(), offsets_want(case[0].cpu().numpy(), cap))


@pytest.mark.cuda
def test_compact_a_warp_degenerate_on_card(cuda):
    """Valid slots whose warp divides by zero (inf and NaN, kept as the
    plain version gives them) and padding slots pinned to 0.5."""
    tree = degenerate_tree(cuda)
    R, max_s = 6, 8
    n_s = torch.tensor([3, 0, 8, 1, 2, 0], dtype=torch.int32, device=cuda)
    out_t = torch.zeros((R, max_s), device=cuda)
    out_t[2, 1:] = torch.linspace(0.1, 0.7, 7, device=cuda)
    out_dt = torch.full((R, max_s), 0.01, device=cuda)
    out_node = torch.zeros((R, max_s), dtype=torch.int32, device=cuda)
    o = torch.tensor([[0.0, 0.0, 0.0], [0.3, 0.0, 0.0], [0.2, 0.1, 0.0], [0.0, 0.5, 0.0],
                      [-0.4, 0.0, 0.0], [0.1, 0.1, 0.1]], device=cuda)
    d = torch.tensor([[1.0, 0.0, 0.0]] * R, device=cuda)
    a, _, ok, _ = _a_on_card(tree, (n_s, out_t, out_dt, out_node, o, d), 32)
    p = a["pts01"][ok]
    assert bool(torch.isnan(p).any()) and bool(torch.isinf(p).any())
    assert bool((a["pts01"][~ok] == 0.5).all())


@pytest.mark.cuda
def test_sample_edges_on_card(trees, cuda):
    _, _, ttree = trees
    tree = tree_on(ttree, cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    e, coord = tdv.draw_edges(tree, g, 8192)
    got, again = tdv.sample_edges(tree, e, coord), tdv.sample_edges(tree, e, coord)
    want = tdv.sample_edges_plain(tree, e, coord)
    torch.cuda.synchronize()
    assert same_bits(got[0], want[0]) and torch.equal(got[1], want[1])
    assert same_bits(got[0], again[0])
    # the degenerate warp: edge points at z = 0
    dtree = degenerate_tree(cuda)
    e = torch.zeros((64,), dtype=torch.int32, device=cuda)
    coord = torch.rand((64, 2), generator=g, device=cuda) * 2.0 - 1.0
    coord[0] = 0.0
    got, want = tdv.sample_edges(dtree, e, coord), tdv.sample_edges_plain(dtree, e, coord)
    assert bool(torch.isnan(got[0]).any())
    assert same_bits(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("n,cap,mode", SEG_CASES + [(393216, 262144, "half"),
                                                    (393216, 100000, "half"),
                                                    (393216, 262144, "none"),
                                                    (393216, 262144, "step"),
                                                    (393216, 100000, "step"),
                                                    (393216, None, "step"),
                                                    (393216, 262144, "nopad"),
                                                    (393216, 262144, "gaps"),
                                                    (393216, 262144, "one_ray"),
                                                    (1 << 23, 1 << 22, "half")])
def test_compact_keep_on_card(cuda, n, cap, mode):
    """K13 against its plain version, B's segments included; each launch
    (three in a row) the same bits. At 2^23 rows the grid (8,193 tiles and
    2,048 padding blocks) is many times what the card holds at once: the
    tiles' look-back and the padding blocks' waits rest on blocks being
    dispatched in index order."""
    args = keep_args(n, cap, mode, cuda)
    runs = [tren.compact_keep(*args) for _ in range(3)]
    want = tren.compact_keep_plain(*args)
    torch.cuda.synchronize()
    for got in runs:
        for k in want[0]:
            assert same_bits(got[0][k], want[0][k]), k
        for i in (1, 2, 3):
            assert torch.equal(got[i], want[i]), i
        for g, w in zip(got[4], want[4]):
            assert g.dtype == w.dtype and torch.equal(g, w)
