"""Octree maintenance in the port against the JAX package, on the CPU.

Inputs: tests/test_sampler.py's synthetic rig (a JAX-built octree
converted to the port) and the tiny ball Trainer (TINY_OVERRIDES).
Compared:
  * ProcOctree: the port's native engine, the port's numpy version and
    the JAX package's numpy version, for compaction, compaction with
    subdivision (seeded visit counts), brute-force subdivision and
    compaction after culling half of the valid leaves;
  * mark_invisible_nodes and maintain, at a milestone iteration, at a
    compaction-only iteration and at an iteration with nothing due;
  * the edge pool: a port build gives the JAX build's edge arrays in the
    JAX build's order (the TV loss picks edges by index), and the native
    and numpy pools give the same multiset;
  * the port's Trainer through a milestone (compact_freq 3, milestone 4,
    6 iterations): each maintenance equals JAX ``maintain`` applied to the
    synced tree before it, with JAX's capacity and hit-cap rules;
  * one step of the port against the JAX step on a subdivided tree,
    within STEP_TOL, and a port checkpoint written after the milestone
    resumed by the JAX Trainer with an equal tree.

Tolerances: node centers to 1e-6 (as tests/test_native.py: the native
engine computes child centers in f32 where numpy may round the offset
once more); every integer and boolean array, sides and milestones exactly.
"""

import copy

import numpy as np
import pytest
import torch

from f2nerf_tpu.sampler import octree as joc
from f2nerf_torch import native
from f2nerf_torch.sampler import octree as toc
from f2nerf_torch.train import trainer as ttr
from f2nerf_torch.utils.convert import octree_from_fields
from f2nerf_torch.utils.parity import step_agrees, step_errors
from test_sampler import CFG, synthetic_rig
from test_torch_train_step import OVERRIDES, one_step_both

MAINT_OVERRIDES = OVERRIDES + ["pts_sampler.compact_freq=3",
                               "pts_sampler.sub_div_milestones=[4]"]
NODE_INT = ("parent", "childs", "is_leaf", "trans_idx", "weight_stats",
            "alpha_stats", "visit_cnt")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in parallel worker processes; torch's own intra-op
    pool would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rig():
    c2w, w2c, intri, bounds = synthetic_rig()
    jhost = joc.build_octree(c2w, w2c, intri, bounds, CFG, seed=0)
    return jhost, (intri, w2c, bounds)


def assert_trees_equal(a, b):
    assert a.n_nodes == b.n_nodes
    np.testing.assert_array_equal(a.side, b.side)
    np.testing.assert_allclose(a.center, b.center, atol=1e-6)
    for f in NODE_INT:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert list(a.milestones) == list(b.milestones)
    for f in ("w2xz", "edge_t", "edge_center"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def case_tree(jhost, case):
    """A JAX host tree prepared for one ProcOctree case, and its flags."""
    t = copy.deepcopy(jhost)
    if case == "compact":
        return t, (True, False, False)
    t = joc._proc_octree_np(t, True, False, False)
    rng = np.random.RandomState(3)
    if case == "culled":
        valid = np.nonzero(t.trans_idx >= 0)[0]
        t.trans_idx[rng.choice(valid, len(valid) // 2, replace=False)] = -1
        return t, (True, False, False)
    t.visit_cnt[:] = rng.randint(0, 10, t.n_nodes)
    return t, (True, True, case == "brute")


@pytest.mark.parametrize("case", ["compact", "subdivide", "brute", "culled"])
def test_proc_octree_native_numpy_and_jax_agree(rig, case):
    jt, flags = case_tree(rig[0], case)
    want = joc._proc_octree_np(copy.deepcopy(jt), *flags)
    got_native = toc.proc_octree(octree_from_fields(jt), *flags)
    got_np = toc._proc_octree_np(octree_from_fields(jt), *flags)
    assert_trees_equal(got_native, want)
    assert_trees_equal(got_np, want)
    if flags[1]:
        assert want.n_nodes > jt.n_nodes
    elif case == "culled":
        assert want.n_nodes < jt.n_nodes


def test_mark_invisible_nodes_matches_jax(rig):
    jhost, cams = rig
    jt, flags = case_tree(jhost, "brute")
    jt = joc._proc_octree_np(jt, *flags)
    tt = octree_from_fields(jt)
    before = int((jt.trans_idx >= 0).sum())
    joc.mark_invisible_nodes(jt, *cams)
    toc.mark_invisible_nodes(tt, *cams)
    np.testing.assert_array_equal(tt.trans_idx, jt.trans_idx)
    assert tt.trans_idx.dtype == jt.trans_idx.dtype == np.int32
    assert 0 < int((jt.trans_idx >= 0).sum()) < before


@pytest.mark.parametrize("iter_step,want_changed", [(2000, True), (1000, True),
                                                    (1500, False)])
def test_maintain_matches_jax(rig, iter_step, want_changed):
    """Milestones [4000, 2000] (popped from the back), compact_freq 1000:
    iteration 2000 is a milestone and a compaction, 1000 a compaction
    only, 1500 neither."""
    jhost, cams = rig
    jt = copy.deepcopy(jhost)
    jt.milestones = [4000, 2000]
    jt.visit_cnt[:] = np.random.RandomState(5).randint(0, 10, jt.n_nodes)
    tt = octree_from_fields(jt)
    want, changed_j = joc.maintain(jt, iter_step, 1000, *cams)
    got, changed_t = toc.maintain(tt, iter_step, 1000, *cams)
    assert changed_t == changed_j == want_changed
    assert_trees_equal(got, want)
    assert got.milestones == ([4000] if iter_step >= 2000 else [4000, 2000])


def test_port_build_has_jax_edges_in_jax_order(rig):
    """The port's build takes the native edge pool, as the JAX build does,
    so edge i is the same leaf pair in both (the TV loss picks by index)."""
    jhost = rig[0]
    c2w, w2c, intri, bounds = synthetic_rig()
    thost = toc.build_octree(c2w, w2c, intri, bounds, CFG, seed=0, device="cpu")
    assert len(thost.edge_t) > 0
    for f in ("edge_t", "edge_center", "edge_dir0", "edge_dir1"):
        np.testing.assert_array_equal(getattr(thost, f), getattr(jhost, f), err_msg=f)


def test_native_and_numpy_edge_pools_same_multiset(rig):
    t1 = octree_from_fields(rig[0])
    t2 = octree_from_fields(rig[0])
    toc.construct_edge_pool(t1)
    toc._construct_edge_pool_np(t2)
    assert t1.edge_t.shape == t2.edge_t.shape and len(t1.edge_t) > 0

    def key(t):
        arr = np.concatenate([t.edge_t.astype(np.float32), t.edge_center,
                              t.edge_dir0, t.edge_dir1], axis=1)
        return arr[np.lexsort(arr.T)]
    np.testing.assert_allclose(key(t1), key(t2), atol=1e-6)


def test_native_build_is_named_by_its_source():
    path = native.build()
    assert path.exists() and path == native.library_path()
    assert path.parent == native.BUILD_DIR


# ------------------------------------------------------------- the Trainer

@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The JAX Trainer past its milestone, then one step of each package."""
    return one_step_both(tmp_path_factory, MAINT_OVERRIDES, n_steps=4)


@pytest.fixture(scope="module")
def port_run(both, tmp_path_factory):
    """The port's own Trainer on the CPU for 6 iterations, each
    maintenance recorded: the synced tree before it (a copy), the
    maintained tree, and the trainer's capacities, hit cap and oct_max
    before and after ``maybe_maintain_tree``."""
    pt = ttr.Trainer(both["cfg"], str(tmp_path_factory.mktemp("maint")),
                     both["data_dir"], device="cpu", seed=2022)
    events, real = [], toc.maintain

    def spy(tree, iter_step, compact_freq, intri, w2c, bounds):
        before = copy.deepcopy(tree)
        out, changed = real(tree, iter_step, compact_freq, intri, w2c, bounds)
        # copies: the trainer syncs its host tree in place later
        events.append(dict(iter=iter_step, before=before, after=copy.deepcopy(out),
                           changed=changed, cams=(intri, w2c, bounds)))
        return out, changed

    real_mm = pt.maybe_maintain_tree

    def caps():
        return (pt.max_nodes, pt.hit_cap, pt.oct_max)

    def maybe_maintain_tree():
        before, n = caps(), len(events)
        real_mm()
        if len(events) > n:
            events[-1].update(caps_before=before, caps_after=caps())

    pt.maybe_maintain_tree = maybe_maintain_tree
    toc.maintain = spy
    try:
        metrics = [pt.train_one() for _ in range(6)]
    finally:
        toc.maintain = real
    pt.save_checkpoint()
    return pt, events, metrics


def test_port_trainer_maintains_through_a_milestone(port_run):
    pt, events, metrics = port_run
    assert pt.iter_step == 6
    for m in metrics:
        assert np.isfinite(m["loss"]) and m["grads_finite"] == 1.0, m
    assert [e["iter"] for e in events] == [3, 4, 6]
    assert pt.tree_host.milestones == []
    # the milestone subdivides: more nodes after iteration 4
    assert events[1]["after"].n_nodes > events[1]["before"].n_nodes
    for e in events:
        jt = joc.OctreeHost(**copy.deepcopy(vars(e["before"])))
        want, changed = joc.maintain(jt, e["iter"], 3, *e["cams"])
        assert changed and e["changed"]
        assert_trees_equal(e["after"], want)
    assert_trees_equal(pt.tree_host, events[-1]["after"])


def test_port_trainer_capacities_follow_jax_rule(port_run):
    pt, events, _ = port_run
    for e in events:
        nodes0, hit0, oct0 = e["caps_before"]
        nodes1, hit1, oct1 = e["caps_after"]
        assert nodes1 == max(nodes0, ttr.pow2ceil(e["after"].n_nodes))
        if e["iter"] == 4:      # the milestone pre-sizes the hit buffer
            assert oct0 > 0
            assert hit1 == min(max(hit0, ttr.pow2ceil(2.0 * oct0)),
                               pt.hit_cap_limit)
            assert oct1 == 0.5 * oct0
        else:
            assert (hit1, oct1) == (hit0, oct0)
    # the device tree was rebuilt from the last maintained tree
    n, host = pt.tree_host.n_nodes, pt.tree_host
    assert pt.tree.center.shape[0] == pt.max_nodes >= n
    np.testing.assert_array_equal(pt.tree.child[:n].numpy(), host.childs)
    np.testing.assert_array_equal(pt.tree.trans_idx[:n].numpy(), host.trans_idx)
    np.testing.assert_array_equal(pt.tree.is_leaf[:n].numpy(), host.is_leaf)


def test_one_step_on_a_subdivided_tree_matches_jax(both):
    j, p = both["jax"], both["port"]
    jt = both["jax_trainer"]
    assert jt.tree_host.milestones == [] and jt.iter_step == 4
    assert p["stats"]["n_meaningful"] == j["stats"]["n_meaningful"] > 0
    err = step_errors(p["loss"], j["loss"], p["grads"], j["grads"], p["params"],
                      j["params"], p["occ"], j["occ"], both["lr"])
    assert step_agrees(err), err


def test_port_checkpoint_after_milestone_resumes_in_jax(both, port_run):
    pt = port_run[0]
    jt = both["jax_trainer"]
    jt.load_checkpoint(f"{pt.base_exp_dir}/checkpoints/latest")
    assert jt.iter_step == 6 and jt.tree_host.milestones == []
    assert_trees_equal(jt.tree_host, pt.tree_host)
    assert jt.max_nodes >= pt.tree_host.n_nodes
