"""Single-pass training (``+train.single_pass=true``) and the HashBlock
two-pass eval render against the JAX package.

Single pass: while the early stop would cull almost nothing (meaningful >
0.9 sampled) the step skips the prefilter, queries the field once over
all of A and the edge samples with gradients, and votes occupancy from
the composite weights (JAX renderer.py:245-252,362-368, trainer.py:702-719).
One step of the port from a tiny JAX Trainer's state, with the JAX step's
draws and statics (``one_step_both``), within ``STEP_TOL``.

Two-pass eval: ``render`` with eval statics and single_pass=False, whose
HashBlock field query on B is the cached gather of the prefilter's
encodings (K4's forward), within ``EVAL_TOL`` of JAX compiled (outlier
form; f2nerf_torch/utils/parity.py states the reasons).
"""

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
from f2nerf_torch.utils.parity import (eval_agrees, image_errors, step_agrees,
                                       step_errors)
from test_torch_train_step import one_step_both

OVERRIDES = list(TINY_OVERRIDES) + ["+train.fused_adam=true",
                                    "+train.data_parallel=off",
                                    "+train.single_pass=true"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    return one_step_both(tmp_path_factory, OVERRIDES, n_steps=2)


def test_step_statics_are_single_pass(steps):
    st = steps["statics"]
    assert st.single_pass and st.field_type == "HashBlock"
    assert st.cap2 == st.cap1


def test_single_pass_step_matches_jax(steps):
    j, p = steps["jax"], steps["port"]
    for k in ("n_sampled", "n_meaningful", "n_oct_hits", "overflow_a",
              "overflow_b", "n_saturated", "n_trav_truncated"):
        assert p["stats"][k] == j["stats"][k], k
    assert p["stats"]["overflow_b"] == 0.0
    err = step_errors(p["loss"], j["loss"], p["grads"], j["grads"], p["params"],
                      j["params"], p["occ"], j["occ"], steps["lr"])
    assert step_agrees(err), err
    # the occupancy votes came from the composite: counters moved
    assert (p["occ"]["visit_cnt"] > 0).any()


def test_port_trainer_picks_single_pass(steps, tmp_path):
    """The port's Trainer chooses single pass while meaningful > 0.9
    sampled, two passes otherwise, as the JAX Trainer does."""
    from f2nerf_torch.train import trainer as ttr
    pt = ttr.Trainer(steps["cfg"], str(tmp_path / "own"), steps["data_dir"],
                     device="cpu", seed=7, tree_host=steps["port_trainer"].tree_host)
    m = pt.train_one()
    assert m["single_pass"] and m["cap2"] == m["cap1"]
    assert np.isfinite(m["loss"]) and m["grads_finite"] == 1.0
    pt.ema_meaningful = 0.5 * pt.ema_sampled
    _, st = pt._get_step(pt.cur_batch_size())
    assert not st.single_pass


def test_hash_block_two_pass_eval_render_matches_jax(steps):
    jt, pt = steps["jax_trainer"], steps["port_trainer"]
    jt.load_checkpoint(steps["port_ckpt"])
    feat = np.random.RandomState(1).randn(*jt.params["feat_pool"].shape) * 3.0
    jt.params["feat_pool"] = jnp.asarray(feat.astype(np.float32))
    with torch.no_grad():
        pt.params["feat_pool"].copy_(torch.from_numpy(feat.astype(np.float32)))
    cam = int(jt.dataset.test_set[1])
    ro, rd = (np.array(x)[1000:1128] for x in jds.camera_rays(
        jt.data, cam, jt.dataset.height, jt.dataset.width))
    n, max_s = ro.shape[0], 128
    st = jtr.render_statics(jt.cfg, n, jt.dataset.near, train=False, max_s=max_s,
                            cap1=n * max_s, cap2=n * 48, max_hits=pt.hit_cap)
    assert not st.single_pass and st.field_type == "HashBlock"
    want, occ_j = jax.jit(lambda *a: jrender(*a, st))(
        jt.params, jt.consts, jt.tree, jnp.asarray(ro), jnp.asarray(rd),
        jnp.zeros((n,), jnp.int32), jax.random.PRNGKey(0),
        jnp.asarray(1.0, jnp.float32), jnp.asarray(1.0))
    with torch.no_grad():
        got, occ_t = trender(pt.params, pt.consts, pt.tree, torch.from_numpy(ro),
                             torch.from_numpy(rd), torch.zeros(n, dtype=torch.int32),
                             None, torch.tensor(1.0), torch.tensor(1.0),
                             RenderStatics(**st._asdict()))
    assert occ_j is None and occ_t is None
    for k in ("n_sampled", "n_meaningful", "n_oct_hits", "overflow_a",
              "overflow_b", "n_saturated"):
        assert float(got["stats"][k]) == float(want["stats"][k]), k
    np.testing.assert_array_equal(got["ray_id"].numpy(), np.asarray(want["ray_id"]))
    err = image_errors(got["colors"], got["disparity"], want["colors"], want["disparity"])
    assert eval_agrees(err, exact=False), err
