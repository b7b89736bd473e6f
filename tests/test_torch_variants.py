"""The reference-semantics configuration against the JAX package:
``field.type=Hash3DAnchored`` with ``+pts_sampler.march_mode=lockstep``.

A tiny JAX Trainer (TINY_OVERRIDES, one device) takes two steps and saves
its state; the port loads that state.npz and runs one step with the draws
the JAX step makes from its key (the lockstep marcher's noise among them),
with the JAX step's static shapes (``one_step_both`` of
tests/test_torch_train_step.py). Then eval: ``render_image`` and one
two-pass eval ``render`` (prefilter, compaction to B, a full field query
on B) from one state with a seeded N(0, 3^2) feature pool.

Tolerances: the step within ``STEP_TOL``, the images within ``EVAL_TOL``
(f2nerf_torch/utils/parity.py, which states their reasons); the JAX side
runs compiled, as in production, so the outlier form of ``EVAL_TOL``
applies. Sample counts must be equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f2nerf_tpu.data import dataset as jds
from f2nerf_tpu.render.renderer import render as jrender
from f2nerf_tpu.train import trainer as jtr
from f2nerf_tpu.utils.synthetic import TINY_OVERRIDES
from f2nerf_torch.render.renderer import RenderStatics
from f2nerf_torch.render.renderer import render as trender
from f2nerf_torch.train import trainer as ttr
from f2nerf_torch.utils.parity import (EVAL_TOL, eval_agrees, image_errors,
                                       step_agrees, step_errors)
from f2nerf_torch.utils.tree import named_leaves
from test_torch_train_step import one_step_both

OVERRIDES = list(TINY_OVERRIDES) + [
    "+train.fused_adam=true", "+train.data_parallel=off", "+eval.chunk=256",
    "field.type=Hash3DAnchored", "+pts_sampler.march_mode=lockstep"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops (the plain marcher's loop) that gain nothing from
    torch's intra-op pool, which would oversubscribe the tier-1 workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    return one_step_both(tmp_path_factory, OVERRIDES, n_steps=2)


def test_step_statics_are_reference_semantics(steps):
    st = steps["statics"]
    assert (st.field_type, st.march_mode, st.single_pass) == \
        ("Hash3DAnchored", "lockstep", False)
    pool = steps["port"]["params"]["['feat_pool']"]
    assert pool.shape == ((1 << 12) * 16, 2)


def test_step_matches_jax(steps):
    j, p = steps["jax"], steps["port"]
    for k in ("n_sampled", "n_meaningful", "n_oct_hits", "overflow_a",
              "overflow_b", "n_saturated", "n_trav_truncated"):
        assert p["stats"][k] == j["stats"][k], k
    assert p["finite"] and j["finite"] and p["stats"]["n_meaningful"] > 0
    err = step_errors(p["loss"], j["loss"], p["grads"], j["grads"], p["params"],
                      j["params"], p["occ"], j["occ"], steps["lr"])
    assert step_agrees(err), err
    assert np.linalg.norm(j["grads"]["['feat_pool']"]) > 0


def test_hash3d_checkpoint_roundtrip(steps):
    """The JAX Hash3DAnchored state.npz ([pool, 2] feature pool, uint32
    primes) loaded into the port (the fixture's step ran from it), and the
    port's written back and resumed by the JAX Trainer."""
    jt, pt = steps["jax_trainer"], steps["port_trainer"]
    assert pt.consts["prim_pool"].dtype == torch.int32
    jt.load_checkpoint(steps["port_ckpt"])
    got = dict(named_leaves(jax.tree_util.tree_map(np.asarray, jt.params)))
    for k, v in steps["port"]["params"].items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert jt.consts["prim_pool"].dtype == jnp.uint32
    np.testing.assert_array_equal(np.asarray(jt.consts["prim_pool"]).astype(np.int64),
                                  pt.consts["prim_pool"].numpy().astype(np.int64))
    assert int(jt.opt_state[1].count) == 3


@pytest.fixture(scope="module")
def eval_pair(steps):
    """Both trainers at one state: the port's post-step checkpoint with the
    feature pool replaced by a seeded N(0, 3^2) draw (density that varies
    across the image)."""
    jt, pt = steps["jax_trainer"], steps["port_trainer"]
    jt.load_checkpoint(steps["port_ckpt"])
    feat = np.random.RandomState(0).randn(*jt.params["feat_pool"].shape) * 3.0
    jt.params["feat_pool"] = jnp.asarray(feat.astype(np.float32))
    jt.save_checkpoint()
    pt.load_checkpoint(os.path.join(jt.base_exp_dir, "checkpoints", "latest"))
    pt.hit_cap = jt.hit_cap
    cam = int(jt.dataset.test_set[1])
    ro, rd = jds.camera_rays(jt.data, cam, jt.dataset.height, jt.dataset.width)
    return jt, pt, np.asarray(ro)[900:1412], np.asarray(rd)[900:1412]


def test_render_image_matches_jax(eval_pair):
    jt, pt, ro, rd = eval_pair
    cj, dj, oj = jt.render_image(ro, rd)
    ct, dt, ot = pt.render_image(ro, rd)
    assert ct.shape == (ro.shape[0], 3) and np.isfinite(ct).all()
    assert ct.max() - ct.min() > 0.3          # density varies across the rays
    err = image_errors(ct, dt, cj, dj)
    assert eval_agrees(err, exact=False), err
    np.testing.assert_allclose(ot, oj, atol=EVAL_TOL["oct_atol"])


def test_two_pass_eval_render_matches_jax(eval_pair):
    """``render`` with eval statics and single_pass=False: the prefilter
    and the A -> B compaction, then a full Hash3DAnchored query on B."""
    jt, pt, ro, rd = eval_pair
    ro, rd = ro[:128], rd[:128]
    n, max_s = ro.shape[0], 128
    st = jtr.render_statics(jt.cfg, n, jt.dataset.near, train=False, max_s=max_s,
                            cap1=n * max_s, cap2=n * 48, max_hits=jt.hit_cap)
    assert not st.single_pass and st.field_type == "Hash3DAnchored"
    want, occ_j = jax.jit(lambda *a: jrender(*a, st))(
        jt.params, jt.consts, jt.tree, jnp.asarray(ro), jnp.asarray(rd),
        jnp.zeros((n,), jnp.int32), jax.random.PRNGKey(0),
        jnp.asarray(1.0, jnp.float32), jnp.asarray(1.0))
    with torch.no_grad():
        got, occ_t = trender(pt.params, pt.consts, pt.tree, torch.from_numpy(ro.copy()),
                             torch.from_numpy(rd.copy()), torch.zeros(n, dtype=torch.int32),
                             None, torch.tensor(1.0), torch.tensor(1.0),
                             RenderStatics(**st._asdict()))
    assert occ_j is None and occ_t is None
    for k in ("n_sampled", "n_oct_hits", "overflow_a", "n_saturated"):
        assert float(got["stats"][k]) == float(want["stats"][k]), k
    # B held every sample the prefilter kept
    assert 0 < float(got["stats"]["n_meaningful"]) <= float(got["stats"]["n_sampled"])
    assert float(got["stats"]["overflow_b"]) == 0.0
    assert float(got["stats"]["n_meaningful"]) == float(want["stats"]["n_meaningful"])
    err = image_errors(got["colors"], got["disparity"], want["colors"], want["disparity"])
    assert eval_agrees(err, exact=False), err


def test_config_selects_the_variant(steps, tmp_path):
    """The port's own Trainer builds the Hash3DAnchored pool and runs the
    lockstep marcher from the config."""
    pt = ttr.Trainer(steps["cfg"], str(tmp_path / "own"), steps["data_dir"],
                     device="cpu", seed=7, tree_host=steps["port_trainer"].tree_host)
    assert tuple(pt.params["feat_pool"].shape) == ((1 << 12) * 16, 2)
    m = pt.train_one()
    assert np.isfinite(m["loss"]) and m["grads_finite"] == 1.0
    _, st = pt._get_step(m["n_rays"])
    assert (st.field_type, st.march_mode) == ("Hash3DAnchored", "lockstep")
