"""One training step of the port against the JAX package for the repo's
configurations beside ``wanjinyou``, at TINY_OVERRIDES on the ball scene
(``one_step_both`` of tests/test_torch_train_step.py: a tiny JAX Trainer
takes two steps and saves, then one step of each package from that state
with the same draws and static shapes):

  * ``llff``: the appearance embedding off (confs/renderer/default.yaml),
    scale_by_dis off, disp_loss_weight 5e-2, bounds_factor [0.25, 4.0],
    dataset.factor 4 (the ball scene lists its images, so the config's
    own factor serves: it scales the intrinsics);
  * ``nerf-360``: the appearance embedding and scale_by_dis off; it stands
    for ``free`` too, which differs from it only in dataset_name and
    case_name (the ball scene replaces both).

Held with the tolerances of f2nerf_torch/utils/parity.py: the loss and
each of its terms (color, disparity, TV, variance) within loss_rtol, the
sample counts equal, each gradient leaf within grad_rel, the step within
``step_agrees``, the Adam first moments within grad_rel and the occupancy
counters equal. The JAX side runs compiled, as in production.
"""

import numpy as np
import pytest
import torch

from f2nerf_tpu.utils.synthetic import TINY_OVERRIDES
from f2nerf_torch.utils.parity import STEP_TOL, step_agrees, step_errors
from test_torch_train_step import LOSS_TERMS, OCC, one_step_both

OVERRIDES = list(TINY_OVERRIDES) + ["+train.fused_adam=true", "+train.data_parallel=off"]
CONFIGS = ["llff", "nerf-360"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's step is many small ops that gain nothing from torch's
    intra-op pool, which would oversubscribe the tier-1 workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=CONFIGS)
def steps(request, tmp_path_factory):
    return one_step_both(tmp_path_factory, OVERRIDES, n_steps=2, config_name=request.param)


def test_config_composes_its_own_settings(steps):
    cfg, st = steps["cfg"], steps["statics"]
    assert cfg["renderer"]["use_app_emb"] is False and not st.use_app_emb
    assert cfg["pts_sampler"]["scale_by_dis"] is False and not st.scale_by_dis
    if cfg["dataset_name"] == "nerf_llff_data":
        assert float(cfg["train"]["disp_loss_weight"]) == 5e-2
        assert list(cfg["dataset"]["bounds_factor"]) == [0.25, 4.0]
        assert float(cfg["dataset"]["factor"]) == 4
    else:
        assert float(cfg["train"]["disp_loss_weight"]) == 0.0


def test_loss_terms_and_sample_counts_match(steps):
    j, p = steps["jax"], steps["port"]
    assert j["loss"] == pytest.approx(steps["grad_loss"], rel=1e-6)
    assert p["loss"] == pytest.approx(j["loss"], rel=STEP_TOL["loss_rtol"])
    for k in LOSS_TERMS:
        assert p["terms"][k] == pytest.approx(j["terms"][k], rel=STEP_TOL["loss_rtol"]), k
    assert j["terms"]["color_loss"] > 0 and j["terms"]["disp_loss"] > 0
    for k in ("n_sampled", "n_meaningful", "n_oct_hits", "max_oct_hits",
              "overflow_a", "overflow_b", "n_saturated", "n_trav_truncated"):
        assert p["stats"][k] == j["stats"][k], k
    assert p["finite"] and j["finite"]


def test_every_gradient_leaf_matches(steps):
    """Each leaf within grad_rel; the appearance embedding, which no
    config here uses, has a zero gradient on both sides."""
    j, p = steps["jax"]["grads"], steps["port"]["grads"]
    assert j.keys() == p.keys()
    for leaf in j:
        a, b = p[leaf].astype(np.float64), j[leaf].astype(np.float64)
        if leaf == "['app_emb']":
            assert not a.any() and not b.any()
            continue
        assert np.linalg.norm(b) > 0, leaf
        assert np.linalg.norm(a - b) <= STEP_TOL["grad_rel"] * np.linalg.norm(b), leaf


def test_step_agrees_within_stated_tolerances(steps):
    j, p = steps["jax"], steps["port"]
    err = step_errors(p["loss"], j["loss"], p["grads"], j["grads"], p["params"],
                      j["params"], p["occ"], j["occ"], steps["lr"])
    assert step_agrees(err), err


def test_adam_state_and_occupancy_match(steps):
    j, p = steps["jax"], steps["port"]
    assert p["count"] == j["count"] == 3
    for k in j["mu"]:
        a, b = p["mu"][k].astype(np.float64), j["mu"][k].astype(np.float64)
        assert np.linalg.norm(a - b) <= STEP_TOL["grad_rel"] * max(np.linalg.norm(b), 1e-30), k
    for k in OCC:
        np.testing.assert_array_equal(p["occ"][k], j["occ"][k], err_msg=k)
