"""The port's device sampler loops, K8 (the rope traversal) and K9 (the
parallel marcher), and the plain versions they are held to.

On the CPU (the plain versions): a batch traversed at once equals each of
its rays traversed alone (hit rows, counts, ``trunc``, each ray's
iterations), on the rig's tree and on a subdivided one, with the hit cap
and the iteration cut reached; the batch's ``n_iters`` is the largest
per-ray count, a 0-d int32 tensor; a batch through
``ray_march_parallel_plain`` equals its rays marched alone. These are the
properties that let K8 run a thread a ray and K9 a group of threads a
ray, several rays a block. The
wrappers dispatch by device (CPU: the plain version; any other device but
CUDA raises), and the Trainer's metrics carry ``trav_iters`` as an int.

K8's node records (``DeviceTree.node_rec``) hold exactly the center,
side, child, rope and is_leaf columns of the JAX package's traversal pack
(``_pack_nodes``) of the same host tree; the Trainer keeps them through
occupancy culling, rebuilds them after maintenance and on load, and
never writes them to a checkpoint. Which trees K8 stages in shared memory
follows its cap (``TRAVERSE_SMEM_NODES``).

On the card (``cuda`` marker, skipped without one): K8 against
``traverse_plain`` on uniform rays, the subdivided tree, the JAX suite's
brute-force, distant-origin and grazing cases, and trees just under and
just over the shared-memory cap, with hit_idx, n_hits, trunc, n_iters and
each ray's iterations equal and hit_near / hit_far bitwise equal; K9
against ``ray_march_parallel_plain`` with scale_by_dis on and off, eval's
all-ones jitter, the degenerate-hit tree and hit caps 8, 20, 40, 64, 96
and 256 with 1, 2 or 4 rays a block (a batch also equal to its rays
alone), every output bitwise equal. Each wrapper launches its kernel once
a call. On the CPU, K9's launch geometry (``ray_march_parallel_geometry``)
at hit caps 16, 64, 96 and 256.
"""

import copy
import dataclasses
import os

import numpy as np
import pytest
import torch

from f2nerf_tpu.sampler import device as jdv
from f2nerf_tpu.sampler import octree as joc
from f2nerf_torch.sampler import device as tdv
from f2nerf_torch.sampler import octree as toc
from f2nerf_torch.utils.convert import octree_from_fields
from test_sampler import CFG, synthetic_rig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAPS = (4096, 512, 65536)
SUB_CAPS = (16384, 512, 65536)
SAMPLE_L = 1.0 / 64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in parallel worker processes; torch's own intra-op
    pool would oversubscribe the cores, and these are small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(x):
    return torch.from_numpy(np.array(x, copy=True))


@pytest.fixture(scope="module")
def rig_host():
    c2w, w2c, intri, bounds = synthetic_rig()
    return joc.build_octree(c2w, w2c, intri, bounds, CFG, seed=0)


@pytest.fixture(scope="module")
def jax_hosts(rig_host):
    """The rig's JAX host tree and the same tree after two brute-force
    subdivisions (10,545 nodes, as tests/test_torch_march.py builds it)."""
    sub = copy.deepcopy(rig_host)
    for _ in range(2):
        sub = joc._proc_octree_np(sub, True, True, True)
    return {"rig": rig_host, "subdivided": sub}


@pytest.fixture(scope="module")
def hosts(jax_hosts):
    """The trees of ``jax_hosts`` as the port's host trees, each with its
    capacities."""
    return {"rig": (octree_from_fields(jax_hosts["rig"]), CAPS),
            "subdivided": (octree_from_fields(jax_hosts["subdivided"]), SUB_CAPS)}


def tree_near_cap(host, over: bool):
    """A copy of the host tree split (the port's proc_octree, no
    compaction) until its node count lies just under K8's shared-memory cap
    (over=False) or just over it: every valid leaf split 8 ways while that
    stays under the cap, then the first k valid leaves, marked as visited
    (chip_smoke.py's case of the same name)."""
    cap = tdv.TRAVERSE_SMEM_NODES
    base = toc.proc_octree(host, False, False, False)

    def valid_leaves(t):
        return np.nonzero(t.is_leaf & (t.trans_idx >= 0))[0]
    while base.n_nodes + 8 * len(valid_leaves(base)) <= cap:
        base = toc.proc_octree(base, False, True, True)
    k = (cap - base.n_nodes) // 8 + (1 if over else 0)
    base.visit_cnt[valid_leaves(base)[:k]] = 5
    return toc.proc_octree(base, False, True, False)


def jax_pack(host, max_nodes):
    """The JAX package's traversal pack of the same host tree
    (``_pack_nodes``, with the JAX package's own ropes)."""
    jh = joc.OctreeHost(**copy.deepcopy(vars(host)))
    return jdv._pack_nodes(jh, jdv._pad(joc.build_ropes(jh), max_nodes, -1), max_nodes)


def assert_records_match_pack(rec: torch.Tensor, pack: np.ndarray):
    """Center and side bit for bit, children, ropes and is_leaf exactly;
    the pad column zero."""
    rec = rec.numpy()
    assert rec.shape == (pack.shape[0], tdv.NODE_REC_W) and rec.dtype == np.int32
    np.testing.assert_array_equal(rec[:, 0:4], np.ascontiguousarray(pack[:, 0:4]).view(np.int32))
    np.testing.assert_array_equal(rec[:, 4:12], pack[:, 12:20].astype(np.int32))
    np.testing.assert_array_equal(rec[:, 12:18], pack[:, 6:12].astype(np.int32))
    np.testing.assert_array_equal(rec[:, 18], pack[:, 4].astype(np.int32))
    assert not rec[:, 19].any()


def rays(seed, n, spread=2.0):
    rng = np.random.RandomState(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d, np.full(n, 0.05, np.float32), np.full(n, 1e8, np.float32)


def distant_rays(n=32, seed=7):
    """Origins ~4000 units away, aimed at the tree (ulp(t) exceeds a
    leaf's eps; tests/test_torch_sampler.py's distant-origin case)."""
    rng = np.random.RandomState(seed)
    aim = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = (aim - 4000.0 * d).astype(np.float32)
    return o, d, np.full(n, 0.05, np.float32), np.full(n, 1e8, np.float32)


def grazing_case(host, n_leaves=64):
    """tests/test_torch_sampler.py's grazing case: 60% of the valid leaves
    culled, rays nearly parallel to a face of a culled leaf. Returns the
    culled host tree and the rays."""
    culled = dataclasses.replace(host)
    culled.trans_idx = host.trans_idx.copy()
    rng = np.random.RandomState(11)
    valid = np.nonzero(culled.trans_idx >= 0)[0]
    kill = rng.choice(valid, size=int(0.6 * len(valid)), replace=False)
    culled.trans_idx[kill] = -1
    os_, ds_ = [], []
    for u in [u for u in kill if culled.is_leaf[u]][:n_leaves]:
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
    return culled, (o, d, np.full(n, 0.05, np.float32), np.full(n, 1e8, np.float32))


def degenerate_host():
    """tests/test_torch_sampler.py's one-leaf tree whose warp is degenerate
    (b == 0) at the camera origin, with a ray that hits the leaf."""
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
    d = np.array([[-0.05, 0.0, -1.0]], np.float32)
    d /= np.linalg.norm(d)
    return host, (np.array([[0.3, 0.0, 0.0]], np.float32), d,
                  np.array([0.01], np.float32), np.array([1e8], np.float32))


def jitter_of(n, max_s, seed=5):
    """A training jitter draw, U[1e-4, 1)."""
    return np.random.RandomState(seed).uniform(1e-4, 1.0, (n, max_s)).astype(np.float32)


# ------------------------------------------------------------ CPU: K8's plain

@pytest.mark.parametrize("kind,n,max_hits,max_iters", [
    ("rig", 24, 64, 4096), ("rig", 24, 3, 4096), ("rig", 24, 64, 9),
    ("subdivided", 12, 64, 4096), ("subdivided", 12, 16, 4096)])
def test_traverse_batch_equals_rays_alone(hosts, kind, n, max_hits, max_iters):
    """A batch through ``traverse_plain`` equals each ray traversed alone:
    hit rows, n_hits, trunc and each ray's iterations; the batch's
    ``n_iters`` is the largest of them. Small hit caps and iteration cuts
    make ``trunc`` rays (the cap and the cut)."""
    host, caps = hosts[kind]
    tree = tdv.to_device_tree(host, *caps)
    o, d, near, far = rays(3, n)
    o[5] = [50.0, 50.0, 50.0]            # a ray that misses the tree: done at entry
    whole = tdv.traverse_plain(tree, T(o), T(d), T(near), T(far), max_hits, max_iters)
    iters = tdv.traverse_plain.last_iters.clone()
    assert tuple(iters.shape) == (n,) and iters.dtype == torch.int32
    assert int(iters[5]) == 0 and int(whole[3][5]) == 0
    assert int(whole[5]) == int(iters.max())
    for r in range(n):
        sl = slice(r, r + 1)
        alone = tdv.traverse_plain(tree, T(o[sl]), T(d[sl]), T(near[sl]), T(far[sl]),
                                   max_hits, max_iters)
        for k in range(5):
            assert torch.equal(whole[k][r], alone[k][0]), (r, k)
        assert int(tdv.traverse_plain.last_iters[0]) == int(iters[r]) == int(alone[5])
    assert int(whole[3].sum()) > 0
    if max_hits < 8 or max_iters < 100:
        assert bool(whole[4].any())      # the cut or the cap was reached
    if max_iters < 100:
        assert int(whole[5]) == max_iters


def test_traverse_n_iters_is_a_0d_int32_tensor(hosts):
    host, caps = hosts["rig"]
    tree = tdv.to_device_tree(host, *caps)
    o, d, near, far = rays(4, 16)
    out = tdv.traverse(tree, T(o), T(d), T(near), T(far), max_hits=64)
    n_iters = out[5]
    assert torch.is_tensor(n_iters) and n_iters.dtype == torch.int32 and n_iters.dim() == 0
    assert int(n_iters) == int(tdv.traverse_plain.last_iters.max()) > 0
    # every ray done at entry: no iteration
    miss = np.full_like(o, 50.0)
    out = tdv.traverse(tree, T(miss), T(d), T(near), T(far), max_hits=64)
    assert out[5].dim() == 0 and int(out[5]) == 0 and int(out[3].sum()) == 0
    assert torch.equal(out[0], torch.full((16, 64), -1, dtype=torch.int32))


def test_traverse_wrapper_takes_the_plain_version_on_the_cpu(hosts):
    host, caps = hosts["rig"]
    tree = tdv.to_device_tree(host, *caps)
    o, d, near, far = rays(6, 20)
    args = (tree, T(o), T(d), T(near), T(far), 32)
    before = tdv.traverse.launches
    got, want = tdv.traverse(*args), tdv.traverse_plain(*args)
    assert tdv.traverse.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_wrappers_refuse_other_devices(hosts):
    """Neither wrapper moves work to the CPU: a tensor on another device
    than the CPU or a card raises."""
    host, caps = hosts["rig"]
    tree = tdv.to_device_tree(host, *caps)
    meta = dict(device="meta")
    o = torch.empty((4, 3), **meta)
    with pytest.raises(ValueError, match="unsupported device"):
        tdv.traverse(tree, o, o, torch.empty((4,), **meta), torch.empty((4,), **meta), 8)
    hi = torch.empty((4, 8), dtype=torch.int32, **meta)
    hn = torch.empty((4, 8), **meta)
    with pytest.raises(ValueError, match="unsupported device"):
        tdv.ray_march_parallel(tree, o, o, hi, hn, hn, torch.empty((4,), dtype=torch.int32, **meta),
                               torch.empty((4, 16), **meta), torch.ones((), **meta),
                               SAMPLE_L, False, 16)


# ------------------------------------------------------- CPU: K8's records

@pytest.mark.parametrize("kind", ["rig", "subdivided"])
def test_node_records_match_jax_pack(jax_hosts, hosts, kind):
    host, caps = hosts[kind]
    tree = tdv.to_device_tree(host, *caps)
    assert tree.n_nodes == host.n_nodes
    assert_records_match_pack(tree.node_rec, jax_pack(jax_hosts[kind], caps[0]))


def test_shared_memory_cap_sides(hosts):
    """The rig's tree is staged in shared memory whole, the subdivided one
    is read from global memory; trees split to just under and just over
    the cap fall on their sides."""
    rig, sub = (tdv.to_device_tree(hosts[k][0], *hosts[k][1]) for k in ("rig", "subdivided"))
    assert tdv.traverse_smem_nodes(rig) == rig.n_nodes > 0
    assert sub.n_nodes > tdv.TRAVERSE_SMEM_NODES and tdv.traverse_smem_nodes(sub) == 0
    under, over = (tree_near_cap(hosts["rig"][0], o) for o in (False, True))
    assert tdv.TRAVERSE_SMEM_NODES - 8 < under.n_nodes <= tdv.TRAVERSE_SMEM_NODES
    assert tdv.TRAVERSE_SMEM_NODES < over.n_nodes <= tdv.TRAVERSE_SMEM_NODES + 8
    assert tdv.TRAVERSE_SMEM_NODES * tdv.TRAVERSE_NODE_BYTES <= 232448


def test_trainer_keeps_node_records_current(tmp_path):
    """The records ride unchanged through the steps' occupancy culling
    (the same tensor), are rebuilt when maintenance changes the tree and
    when a checkpoint is loaded, and are not in the checkpoint."""
    from f2nerf_torch.train.trainer import Trainer
    from f2nerf_torch.utils.config import compose
    from f2nerf_torch.utils.synthetic import TINY_OVERRIDES, write_ball_dataset

    cfg = compose(os.path.join(REPO, "confs"), "wanjinyou",
                  list(TINY_OVERRIDES) + ["+train.data_parallel=off",
                                          "pts_sampler.compact_freq=100",
                                          "pts_sampler.sub_div_milestones=[2]"])
    data = write_ball_dataset(str(tmp_path / "ball"))
    tr = Trainer(cfg, str(tmp_path / "exp"), data, seed=2022, device="cpu")

    def current(t):
        assert t.tree.n_nodes == t.tree_host.n_nodes
        assert_records_match_pack(t.tree.node_rec, jax_pack(t.tree_host, t.max_nodes))

    current(tr)
    rec, trans = tr.tree.node_rec, tr.tree.trans_idx
    tr.train_one()                       # no maintenance: culling only
    assert tr.tree.node_rec is rec and tr.tree.trans_idx is not trans
    n0 = tr.tree.n_nodes
    tr.train_one()                       # the milestone subdivides
    assert tr.tree.n_nodes > n0 and tr.tree.node_rec is not rec
    current(tr)
    tr.save_checkpoint()
    with np.load(os.path.join(tr.base_exp_dir, "checkpoints", "latest", "state.npz")) as z:
        assert not [k for k in z.files if "rec" in k]
    back = Trainer(cfg, str(tmp_path / "exp2"), data, seed=7, device="cpu")
    back.load_checkpoint(os.path.join(tr.base_exp_dir, "checkpoints", "latest"))
    current(back)
    assert torch.equal(back.tree.node_rec, tr.tree.node_rec)


# ------------------------------------------------------------ CPU: K9's plain

@pytest.mark.parametrize("kind,scale_by_dis,ones", [
    ("rig", False, False), ("rig", True, False), ("rig", False, True),
    ("subdivided", True, False)])
def test_march_parallel_batch_equals_rays_alone(hosts, kind, scale_by_dis, ones):
    """A batch through ``ray_march_parallel_plain`` equals each ray marched
    alone (its hit row, its jitter row): all five outputs."""
    host, caps = hosts[kind]
    tree = tdv.to_device_tree(host, *caps)
    n, max_s = 12, 48
    o, d, near, far = rays(8, n)
    hits = tdv.traverse_plain(tree, T(o), T(d), T(near), T(far), 64)[:4]
    jit = np.ones((n, max_s), np.float32) if ones else jitter_of(n, max_s)
    fineness = torch.tensor(2.0)
    whole = tdv.ray_march_parallel_plain(tree, T(o), T(d), *hits, T(jit), fineness,
                                         SAMPLE_L, scale_by_dis, max_s)
    assert int(whole[3].sum()) > 0
    assert int(whole[3].max()) == max_s          # a ray is cut at max_s
    for r in range(n):
        sl = slice(r, r + 1)
        alone = tdv.ray_march_parallel_plain(
            tree, T(o[sl]), T(d[sl]), *(h[sl] for h in hits), T(jit[sl]), fineness,
            SAMPLE_L, scale_by_dis, max_s)
        for k in range(5):
            assert torch.equal(whole[k][r], alone[k][0]), (r, k)


@pytest.mark.parametrize("H,want", [
    (16, (32, 1, 4, 128, 1280)), (64, (64, 1, 4, 256, 5120)),
    (96, (96, 1, 2, 192, 3840)), (256, (128, 2, 2, 256, 10240))])
def test_march_parallel_geometry(H, want):
    """K9's launch: a thread a hit in whole warps (at most 128 a ray, two
    hits a thread at H 256), MARCH_RAYS_PER_BLOCK rays a block where 256
    threads hold them, and 20 bytes of shared memory a hit of the block."""
    assert tdv.MARCH_RAYS_PER_BLOCK == 4
    geo = tdv.ray_march_parallel_geometry(H)
    assert tuple(geo[k] for k in ("ray_threads", "hits_per_thread", "rays_per_block",
                                  "block_threads", "smem_bytes")) == want
    with pytest.raises(ValueError):
        tdv.ray_march_parallel_geometry(0)


def test_trainer_reports_trav_iters_as_an_int(tmp_path):
    """The traversal's count rides in the step's one f32 metric row and
    comes back from the drain as an int, the loop's count of that step."""
    from f2nerf_torch.train.trainer import Trainer
    from f2nerf_torch.utils.config import compose
    from f2nerf_torch.utils.synthetic import TINY_OVERRIDES, write_ball_dataset

    cfg = compose(os.path.join(REPO, "confs"), "wanjinyou",
                  list(TINY_OVERRIDES) + ["+train.data_parallel=off"])
    tr = Trainer(cfg, str(tmp_path / "exp"), write_ball_dataset(str(tmp_path / "ball")),
                 seed=2022, device="cpu")
    seen = []
    real = tdv.traverse

    def spy(*a, **kw):
        out = real(*a, **kw)
        seen.append(int(out[5]))
        return out
    tdv.traverse = spy
    try:
        m = tr.train_one()
    finally:
        tdv.traverse = real
    assert type(m["trav_iters"]) is int and [m["trav_iters"]] == seen and seen[0] > 0


# ------------------------------------------------------------------- the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def k8_against_plain(host, caps, case, dev, max_hits=64, max_iters=4096):
    """K8 and traverse_plain on the card from one input: every output
    equal, the floats bitwise, each ray's iterations equal, one launch."""
    tree = tdv.to_device_tree(host, *caps, device=dev)
    args = (tree, *(T(x).to(dev) for x in case), max_hits, max_iters)
    before = tdv.traverse.launches
    got = tdv.traverse(*args)
    iters = tdv.traverse.last_iters
    want = tdv.traverse_plain(*args)
    torch.cuda.synchronize()
    assert tdv.traverse.launches == before + 1
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and torch.equal(bits(g), bits(w)), k
    assert torch.equal(iters, tdv.traverse_plain.last_iters)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("kind,seed,n,max_hits", [
    ("rig", 9, 2048, 64), ("rig", 10, 300, 4), ("subdivided", 9, 1024, 64)])
def test_k8_uniform_rays_on_card(cuda, hosts, kind, seed, n, max_hits):
    host, caps = hosts[kind]
    got = k8_against_plain(host, caps, rays(seed, n), cuda, max_hits)
    assert int(got[3].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("over", [False, True])
def test_k8_either_side_of_the_shared_memory_cap(cuda, hosts, over):
    """Trees split to just under the cap (staged in shared memory) and just
    over it (read from global memory)."""
    host = tree_near_cap(hosts["rig"][0], over)
    got = k8_against_plain(host, SUB_CAPS, rays(13, 2048), cuda)
    assert int(got[3].sum()) > 0


@pytest.mark.cuda
def test_k8_brute_force_distant_and_grazing_on_card(cuda, rig_host, hosts):
    host, caps = hosts["rig"]
    k8_against_plain(host, caps, rays(2, 64, spread=3.0), cuda)   # the brute-force case
    k8_against_plain(host, caps, distant_rays(), cuda)
    culled, case = grazing_case(rig_host, n_leaves=256)
    k8_against_plain(octree_from_fields(culled), caps, case, cuda, max_iters=600)
    k8_against_plain(host, caps, rays(4, 256), cuda, max_iters=9)  # the cut


def k9_against_plain(host, caps, case, dev, jit, fineness, scale_by_dis, max_s,
                     max_hits=64):
    tree = tdv.to_device_tree(host, *caps, device=dev)
    o, d = (T(x).to(dev) for x in case[:2])
    hits = tdv.traverse(tree, o, d, *(T(x).to(dev) for x in case[2:]), max_hits)[:4]
    args = (tree, o, d, *hits, T(jit).to(dev), torch.tensor(fineness, device=dev),
            SAMPLE_L, scale_by_dis, max_s)
    before = tdv.ray_march_parallel.launches
    got = tdv.ray_march_parallel(*args)
    want = tdv.ray_march_parallel_plain(*args)
    torch.cuda.synchronize()
    assert tdv.ray_march_parallel.launches == before + 1
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and torch.equal(bits(g), bits(w)), k
    return got, args


@pytest.mark.cuda
@pytest.mark.parametrize("kind,scale_by_dis,ones,max_s", [
    ("rig", False, False, 512), ("rig", True, False, 512), ("rig", False, True, 512),
    ("rig", True, False, 33), ("subdivided", True, False, 1024)])
def test_k9_on_card(cuda, hosts, kind, scale_by_dis, ones, max_s):
    host, caps = hosts[kind]
    n = 1024
    jit = np.ones((n, max_s), np.float32) if ones else jitter_of(n, max_s)
    got = k9_against_plain(host, caps, rays(12, n), cuda, jit, 16.0, scale_by_dis, max_s)[0]
    assert int(got[3].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind,H", [
    ("rig", 8), ("rig", 20), ("rig", 40), ("rig", 64), ("rig", 96), ("subdivided", 256)])
def test_k9_hit_caps_on_card(cuda, hosts, kind, H):
    """K9 at hit caps below 32, not a multiple of 32, 64 (the slice's) and
    256 (two hits a thread); four rays a block up to H 64, two at H 96 and
    256: bit for bit the plain version, and a batch row for row each of its
    rays alone."""
    host, caps = hosts[kind]
    n, max_s = 600, 512
    got, args = k9_against_plain(host, caps, rays(14, n), cuda, jitter_of(n, max_s), 16.0,
                                 True, max_s, H)
    assert int(got[3].sum()) > 0
    tree, rest = args[0], args[1:9]
    for r in (0, 1, 2, n // 2, n - 1):
        alone = tdv.ray_march_parallel(tree, *(a[r:r + 1] for a in rest[:7]), rest[7],
                                       *args[9:])
        for k in range(5):
            assert torch.equal(bits(alone[k][0]), bits(got[k][r])), (r, k)


@pytest.mark.cuda
def test_k9_degenerate_hits_on_card(cuda):
    host, case = degenerate_host()
    got = k9_against_plain(host, (8, 8, 8), case, cuda, np.ones((1, 64), np.float32),
                           1.0, False, 64)[0]
    assert int(got[3][0]) > 0 and bool(torch.isfinite(got[0]).all())
