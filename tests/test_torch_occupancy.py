"""Kernel K14 of the port, the occupancy votes (``compute_occupancy_adders``)
and their fold (``apply_occupancy_adders``): the plain versions against the
JAX package and against a loop over the rays in numpy, the votes with the
buffer's ray offsets given and without, the wrappers' routing and
refusals on the CPU, and on the card (``cuda`` marker, skipped without
one) each kernel against its plain version, the votes with the offsets
given and computed.

Inputs come from numpy seeds: ray-sorted buffers with empty rays, rows of
a ray whose node is -1, trailing padding (ray id == n_rays), runs that
revisit a node (the same node twice in one ray with another between, and
in many rays), and on the numpy loop and the card weights that hold NaN,
+-inf and -0.0 (a density overflow gives such weights).

Tolerances: none. Every output is an integer, and the thresholds are one
f32 product and a min, so every output must be equal: to JAX's, to the
numpy loop's and, on the card, the kernels' to the plain versions' (a
repeated launch too).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f2nerf_tpu.sampler import device as jdv
from f2nerf_tpu.sampler import octree as joc
from f2nerf_torch.ops.segment import ray_offsets, ray_offsets_plain
from f2nerf_torch.sampler import device as tdv
from f2nerf_torch.utils.convert import octree_from_fields
from test_sampler import CFG, synthetic_rig

CAPS = (4096, 512, 65536)
VOTES = ("adder_w", "adder_a", "mark", "visit_max")
STATS = ("weight_stats", "alpha_stats", "visit_cnt", "trans_idx")


def T(x):
    return torch.from_numpy(np.array(x, copy=True))


@pytest.fixture(scope="module")
def trees():
    c2w, w2c, intri, bounds = synthetic_rig()
    host = joc.build_octree(c2w, w2c, intri, bounds, CFG, seed=0)
    return jdv.to_device_tree(host, *CAPS), tdv.to_device_tree(octree_from_fields(host), *CAPS)


def buffer(seed: int, n_rays: int, cap: int, n_nodes: int, special: bool = False):
    """(node, rid, w, a) over a ray-sorted cap buffer: ray r's rows walk
    runs of nodes (a node may come back later in the ray, and the same
    nodes serve many rays), a twentieth of the rows at node -1, a quarter
    of the rays empty, padding past the last ray. ``special``: a few
    weights and alphas NaN, +-inf and -0.0, some rays all -0.0."""
    rng = np.random.RandomState(seed)
    counts = rng.randint(0, 40, n_rays)
    counts[rng.rand(n_rays) < 0.25] = 0
    rid = np.repeat(np.arange(n_rays), counts)[:cap]
    pool = rng.choice(n_nodes, min(64, n_nodes), replace=False)
    node = np.empty(len(rid), np.int64)
    i = 0
    while i < len(rid):
        run = rng.randint(1, 9)
        node[i:i + run] = rng.choice(pool)
        i += run
    node[rng.rand(len(rid)) < 0.05] = -1
    pad = cap - len(rid)
    rid = np.concatenate([rid, np.full(pad, n_rays)]).astype(np.int32)
    node = np.concatenate([node, np.full(pad, -1)]).astype(np.int32)
    w = rng.uniform(0, 0.05, cap).astype(np.float32)
    a = rng.uniform(0, 0.1, cap).astype(np.float32)
    if special:
        for x in (w, a):
            pick = rng.rand(cap)
            x[pick < 0.01] = np.nan
            x[(pick >= 0.01) & (pick < 0.02)] = np.inf
            x[(pick >= 0.02) & (pick < 0.03)] = -np.inf
            x[(pick >= 0.03) & (pick < 0.06)] = -0.0
        zero_rays = rng.choice(n_rays, 4)
        for x in (w, a):
            x[np.isin(rid, zero_rays)] = -0.0
    return node, rid, w, a


def votes_loop(node, rid, w, a, n_rays: int, n_nodes: int) -> dict:
    """The votes as MarkVistNodeKernel states them, a ray at a time in
    numpy: a ray's thresholds min(max * 0.1, 0.01) / min(max * 0.1, 0.02)
    in f32 (NaN if a valid row's value is NaN, so nothing exceeds it), then
    each valid row's votes, and the runs of one node within a ray."""
    valid = (rid < n_rays) & (node >= 0)
    out = dict(adder_w=np.full(n_nodes, -1, np.int32), adder_a=np.full(n_nodes, -1, np.int32),
               mark=np.zeros(n_nodes, np.int32), visit_max=np.zeros(n_nodes, np.int32))

    def thres(x, rel, abs_):
        if np.isnan(x).any():
            return np.float32(np.nan)
        return min(np.float32(x.max()) * np.float32(rel), np.float32(abs_))

    for r in range(n_rays):
        rows = np.nonzero(valid & (rid == r))[0]
        if len(rows) == 0:
            continue
        tw, ta = thres(w[rows], 0.1, 0.01), thres(a[rows], 0.1, 0.02)
        for i in rows:
            out["mark"][node[i]] = 1
            if w[i] > tw:
                out["adder_w"][node[i]] = 512
            if a[i] > ta:
                out["adder_a"][node[i]] = 32
    i = 0
    while i < len(rid):
        if not valid[i]:
            i += 1
            continue
        j = i
        while j + 1 < len(rid) and valid[j + 1] and rid[j + 1] == rid[i] \
                and node[j + 1] == node[i]:
            j += 1
        out["visit_max"][node[i]] = max(out["visit_max"][node[i]], j - i + 1)
        i = j + 1
    return out


# ---------------------------------------------------------------- the CPU

@pytest.mark.parametrize("seed,n_rays,cap", [(0, 32, 1024), (1, 64, 512), (2, 7, 256),
                                             (3, 40, 2048)])
def test_votes_and_fold_plain_match_jax(trees, seed, n_rays, cap):
    jtree, ttree = trees
    node, rid, w, a = buffer(seed, n_rays, cap, CAPS[0])
    occ_j = jdv.compute_occupancy_adders(jtree, *map(jnp.asarray, (node, rid, w, a)), n_rays)
    occ_t = tdv.compute_occupancy_adders_plain(ttree, *map(T, (node, rid, w, a)), n_rays)
    for k in VOTES:
        np.testing.assert_array_equal(occ_t[k].numpy(), np.asarray(occ_j[k]), err_msg=k)
    # the buffer revisits nodes: some node has two runs in one ray
    assert int(occ_t["visit_max"].max()) > 1
    tj = jdv.apply_occupancy_adders(jtree, occ_j)
    tt = tdv.apply_occupancy_adders_plain(ttree, occ_t)
    for k in STATS:
        np.testing.assert_array_equal(getattr(tt, k).numpy(), np.asarray(getattr(tj, k)),
                                      err_msg=k)


@pytest.mark.parametrize("special", [False, True])
def test_votes_plain_match_the_loop(trees, special):
    """NaN, +-inf and -0.0 weights: a NaN in a ray silences its votes, inf
    sets the threshold to the absolute one, -0.0 is 0."""
    _, ttree = trees
    node, rid, w, a = buffer(7, 48, 2048, CAPS[0], special)
    want = votes_loop(node, rid, w, a, 48, CAPS[0])
    got = tdv.compute_occupancy_adders_plain(ttree, *map(T, (node, rid, w, a)), 48)
    for k in VOTES:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert (want["adder_w"] == 512).any() and (want["mark"] == 1).any()


@pytest.mark.parametrize("seed,n_rays,cap,special", [(8, 32, 1024, False), (9, 7, 256, True),
                                                     (10, 64, 512, True)])
def test_votes_with_offsets(trees, seed, n_rays, cap, special):
    """The buffer's offsets given (as the renderer passes A's or B's) or
    not: the same votes, JAX's and the numpy loop's."""
    jtree, ttree = trees
    node, rid, w, a = buffer(seed, n_rays, cap, CAPS[0], special)
    args = tuple(map(T, (node, rid, w, a)))
    offsets = ray_offsets_plain(args[1], n_rays)[0]
    given = tdv.compute_occupancy_adders(ttree, *args, n_rays, offsets)
    plain = tdv.compute_occupancy_adders_plain(ttree, *args, n_rays, offsets)
    without = tdv.compute_occupancy_adders(ttree, *args, n_rays)
    want = votes_loop(node, rid, w, a, n_rays, CAPS[0])
    occ_j = jdv.compute_occupancy_adders(jtree, *map(jnp.asarray, (node, rid, w, a)), n_rays)
    for k in VOTES:
        assert torch.equal(given[k], without[k]) and torch.equal(plain[k], without[k]), k
        np.testing.assert_array_equal(given[k].numpy(), want[k], err_msg=k)
        if not special:
            np.testing.assert_array_equal(given[k].numpy(), np.asarray(occ_j[k]), err_msg=k)


@pytest.mark.parametrize("bad", ["int64", "short", "long", "meta", "list"])
def test_votes_refuse_bad_offsets(trees, bad):
    _, ttree = trees
    node, rid, w, a = map(T, buffer(6, 16, 256, CAPS[0]))
    offsets = ray_offsets_plain(rid, 16)[0]
    offsets = {"int64": offsets.long(), "short": offsets[:16], "long": torch.cat([offsets] * 2),
               "meta": offsets.to("meta"), "list": offsets.tolist()}[bad]
    with pytest.raises(ValueError):
        tdv.compute_occupancy_adders(ttree, node, rid, w, a, 16, offsets)


def test_wrappers_route_cpu_to_plain(trees):
    _, ttree = trees
    args = tuple(map(T, buffer(5, 32, 1024, CAPS[0])))
    got = tdv.compute_occupancy_adders(ttree, *args, 32)
    want = tdv.compute_occupancy_adders_plain(ttree, *args, 32)
    assert all(torch.equal(got[k], want[k]) for k in VOTES)
    a, b = tdv.apply_occupancy_adders(ttree, got), tdv.apply_occupancy_adders_plain(ttree, want)
    assert all(torch.equal(getattr(a, k), getattr(b, k)) for k in STATS)


@pytest.mark.parametrize("bad", ["node_int64", "rid_int64", "w_f64", "a_shape", "meta"])
def test_votes_refuse(trees, bad):
    _, ttree = trees
    node, rid, w, a = map(T, buffer(6, 16, 256, CAPS[0]))
    if bad == "node_int64":
        node = node.long()
    elif bad == "rid_int64":
        rid = rid.long()
    elif bad == "w_f64":
        w = w.double()
    elif bad == "a_shape":
        a = a[:100]
    else:
        node, rid, w, a = (x.to("meta") for x in (node, rid, w, a))
    with pytest.raises(ValueError):
        tdv.compute_occupancy_adders(ttree, node, rid, w, a, 16)


@pytest.mark.parametrize("bad", ["votes_int64", "votes_short", "stats_int64", "meta"])
def test_fold_refuses(trees, bad):
    _, ttree = trees
    occ = tdv.compute_occupancy_adders_plain(ttree, *map(T, buffer(6, 16, 256, CAPS[0])), 16)
    tree = ttree
    if bad == "votes_int64":
        occ = dict(occ, mark=occ["mark"].long())
    elif bad == "votes_short":
        occ = dict(occ, adder_w=occ["adder_w"][:10])
    elif bad == "stats_int64":
        tree = dataclasses.replace(ttree, visit_cnt=ttree.visit_cnt.long())
    else:
        occ = {k: v.to("meta") for k, v in occ.items()}
        tree = dataclasses.replace(ttree, **{k: getattr(ttree, k).to("meta") for k in STATS})
    with pytest.raises(ValueError):
        tdv.apply_occupancy_adders(tree, occ)


# ---------------------------------------------------------------- the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def card_tree(ttree, n_nodes: int, dev, seed: int = 0):
    """The tree's counters at n_nodes entries on the card: stats around
    the clamps and the cull, a fifth of the leaf rows -1."""
    rng = np.random.RandomState(seed)
    return dataclasses.replace(
        ttree,
        weight_stats=T(rng.randint(-120, 2000, n_nodes).astype(np.int32)).to(dev),
        alpha_stats=T(rng.choice([-101, -1, 0, 5, 1000, (1 << 20) + 3], n_nodes)
                      .astype(np.int32)).to(dev),
        visit_cnt=T(rng.randint(0, 20, n_nodes).astype(np.int32)).to(dev),
        trans_idx=T(np.where(rng.rand(n_nodes) < 0.2, -1, rng.randint(0, 400, n_nodes))
                    .astype(np.int32)).to(dev))


def _votes_on_card(tree, args, n_rays):
    """The votes with the offsets launch's offsets given, twice, and
    without them (the wrapper computes them): the plain version's."""
    offsets = ray_offsets(args[1], n_rays)[0]
    got = tdv.compute_occupancy_adders(tree, *args, n_rays, offsets)
    again = tdv.compute_occupancy_adders(tree, *args, n_rays, offsets)
    without = tdv.compute_occupancy_adders(tree, *args, n_rays)
    want = tdv.compute_occupancy_adders_plain(tree, *args, n_rays)
    torch.cuda.synchronize()
    for k in VOTES:
        assert torch.equal(got[k], want[k]) and torch.equal(got[k], again[k]), k
        assert torch.equal(without[k], want[k]), k
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("special", [False, True])
@pytest.mark.parametrize("n_rays,cap,n_nodes", [(32, 1024, 4096), (7, 256, 4096),
                                                (2048, 393216, 393216), (1, 64, 8)])
def test_votes_on_card(trees, cuda, special, n_rays, cap, n_nodes):
    _, ttree = trees
    tree = card_tree(ttree, n_nodes, cuda)
    node, rid, w, a = buffer(n_rays + cap, n_rays, cap, n_nodes, special)
    got = _votes_on_card(tree, tuple(T(x).to(cuda) for x in (node, rid, w, a)), n_rays)
    want = votes_loop(node, rid, w, a, n_rays, n_nodes) if cap <= 4096 else None
    if want is not None:
        for k in VOTES:
            np.testing.assert_array_equal(got[k].cpu().numpy(), want[k], err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("per_ray", [512, 700])
def test_votes_long_rays_on_card(trees, cuda, per_ray):
    """Rays of 512 rows (the register window's end) and 700 (past it: rows
    read a second time), runs across the window's edge."""
    _, ttree = trees
    tree = card_tree(ttree, 4096, cuda)
    rng = np.random.RandomState(per_ray)
    n_rays, cap = 9, 9 * per_ray + 100
    rid = np.concatenate([np.repeat(np.arange(n_rays), per_ray), np.full(100, n_rays)])
    node = np.repeat(rng.randint(0, 4096, cap), 5)[:cap]
    node[rng.rand(cap) < 0.03] = -1
    w = rng.uniform(0, 0.05, cap).astype(np.float32)
    a = rng.uniform(0, 0.1, cap).astype(np.float32)
    args = tuple(T(x).to(cuda) for x in (node.astype(np.int32), rid.astype(np.int32), w, a))
    got = _votes_on_card(tree, args, n_rays)
    want = votes_loop(node, rid, w, a, n_rays, 4096)
    for k in VOTES:
        np.testing.assert_array_equal(got[k].cpu().numpy(), want[k], err_msg=k)


@pytest.mark.cuda
def test_votes_a_offsets_on_card(trees, cuda):
    """The votes over buffer A with compact_a_warp's offsets, as the
    renderer calls them: the plain version's."""
    from f2nerf_torch.render import renderer as tren
    from test_torch_compact_warp import offsets_case, tree_on
    jtree, ttree = trees
    tree = tree_on(ttree, cuda)
    case = tuple(T(x).to(cuda) for x in offsets_case(jtree, "step", 2048, 512, 262144))
    a, rid, _, offsets = tren.compact_a_warp(tree, *case, 262144)
    rng = np.random.RandomState(2)
    w = T(rng.uniform(0, 0.05, 262144).astype(np.float32)).to(cuda)
    al = T(rng.uniform(0, 0.1, 262144).astype(np.float32)).to(cuda)
    got = tdv.compute_occupancy_adders(tree, a["node"], rid, w, al, 2048, offsets)
    want = tdv.compute_occupancy_adders_plain(tree, a["node"], rid, w, al, 2048)
    torch.cuda.synchronize()
    for k in VOTES:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
def test_votes_all_padding_on_card(trees, cuda):
    _, ttree = trees
    tree = card_tree(ttree, 4096, cuda)
    cap = 5000
    args = (torch.full((cap,), -1, dtype=torch.int32, device=cuda),
            torch.full((cap,), 16, dtype=torch.int32, device=cuda),
            torch.ones((cap,), device=cuda), torch.ones((cap,), device=cuda))
    got = _votes_on_card(tree, args, 16)
    assert bool((got["adder_w"] == -1).all()) and bool((got["visit_max"] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n_nodes", [4096, 393216, 1])
def test_fold_on_card(trees, cuda, n_nodes):
    _, ttree = trees
    tree = card_tree(ttree, n_nodes, cuda, seed=n_nodes)
    rng = np.random.RandomState(n_nodes + 1)
    occ = dict(adder_w=rng.choice([-1, 512], n_nodes), adder_a=rng.choice([-1, 32], n_nodes),
               mark=rng.randint(0, 2, n_nodes), visit_max=rng.randint(0, 30, n_nodes))
    occ = {k: T(v.astype(np.int32)).to(cuda) for k, v in occ.items()}
    got = tdv.apply_occupancy_adders(tree, occ)
    want = tdv.apply_occupancy_adders_plain(tree, occ)
    torch.cuda.synchronize()
    for k in STATS:
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    if n_nodes > 1:                       # some node is culled
        assert bool((want.trans_idx == -1).any())
