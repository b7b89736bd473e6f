"""One training step of the port against the JAX package, and the port's
own Trainer.

A tiny JAX Trainer (TINY_OVERRIDES, +train.fused_adam=true, one device)
takes two steps and saves its state; the port loads that state.npz by its
name keys and runs one step with the draws the JAX step makes from its key
(ray picks, jitter, background noise, edge picks), with the JAX step's
static shapes. Compared: the loss and the sample counts, each param's
gradient, the updated params and Adam state, and the occupancy counters,
with the tolerances of f2nerf_torch/utils/parity.py (their reasons are
stated there). The JAX side runs compiled, as in production.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f2nerf_tpu.data import dataset as jds
from f2nerf_tpu.render.renderer import render as jrender
from f2nerf_tpu.train import schedules
from f2nerf_tpu.train import trainer as jtr
from f2nerf_tpu.utils.config import compose
from f2nerf_tpu.utils.synthetic import TINY_OVERRIDES, write_ball_dataset
from f2nerf_torch.render.renderer import RenderStatics
from f2nerf_torch.train import trainer as ttr
from f2nerf_torch.utils import convert
from f2nerf_torch.utils.parity import STEP_TOL, step_agrees, step_errors
from f2nerf_torch.utils.tree import named_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OVERRIDES = list(TINY_OVERRIDES) + ["+train.fused_adam=true",
                                    "+train.data_parallel=off"]
OCC = ("weight_stats", "alpha_stats", "visit_cnt", "trans_idx")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in parallel worker processes; torch's own intra-op
    pool would oversubscribe the cores (the port's step is many small
    ops that gain nothing from it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_draws(key, n_rays, st, n_train, height, width, n_edges,
              single_image=False):
    """The draws the JAX step makes from its key, in its split order
    (trainer.py:332, dataset.py:160-165 or, for ``single_image``,
    dataset.py:179-185, renderer.py:191,203,212,352, device.py:653-655).
    Both the parallel marcher's jitter and the lockstep marcher's noise
    are drawn from the same key, as the JAX render does for its mode."""
    k_rays, k_render = jax.random.split(key)
    if single_image:
        k0, _, k2, k3 = jax.random.split(k_rays, 4)
        pick = jax.random.randint(k0, (), 0, n_train)
        cam_pick = jnp.full((n_rays,), pick)
    else:
        k1, k2, k3 = jax.random.split(k_rays, 3)
        cam_pick = jax.random.randint(k1, (n_rays,), 0, n_train)
    kn, kb, ke = jax.random.split(k_render, 3)
    ke1, ke2 = jax.random.split(ke)
    d = dict(cam_pick=cam_pick,
             i=jax.random.randint(k2, (n_rays,), 0, height),
             j=jax.random.randint(k3, (n_rays,), 0, width),
             jitter=jax.random.uniform(kn, (n_rays, st.max_s), minval=1e-4, maxval=1.0),
             noise=(jax.random.uniform(kn, (n_rays + st.max_s + 16,)) - 0.5) + 1.0,
             bg=jax.random.uniform(kb, (n_rays, 3)),
             edge_idx=jax.random.randint(ke1, (st.n_edge,), 0, max(n_edges, 1)),
             edge_coord=jax.random.uniform(ke2, (st.n_edge, 2)) * 2.0 - 1.0)
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    return one_step_both(tmp_path_factory, OVERRIDES, n_steps=2)


LOSS_TERMS = ("color_loss", "disp_loss", "tv_loss", "var_loss")


def one_step_both(tmp_path_factory, overrides, n_steps, config_name="wanjinyou"):
    """A tiny JAX Trainer of ``confs/<config_name>.yaml`` takes ``n_steps``
    steps and saves; then one more step of the JAX package and one of the
    port from that state, with the same draws and static shapes. The
    port's state after its step is saved too (``port_ckpt``); each side's
    loss terms are kept (``terms``)."""
    data_dir = write_ball_dataset(str(tmp_path_factory.mktemp("ball")))
    cfg = compose(os.path.join(REPO, "confs"), config_name, overrides)
    jt = jtr.Trainer(cfg, str(tmp_path_factory.mktemp("jax_exp")), data_dir, seed=2022)
    for _ in range(n_steps):
        jt.train_one()
    jt.save_checkpoint()
    ckpt = os.path.join(jt.base_exp_dir, "checkpoints", "latest")

    n_rays = jt.cur_batch_size()
    step_fn, st = jt._get_step(n_rays)
    tcfg = cfg["train"]
    s = jt.iter_step
    runtime = dict(lr=schedules.learning_rate(s, tcfg),
                   fineness=schedules.ray_march_fineness(s, tcfg),
                   grad_progress=schedules.gradient_scaling_progress(s, tcfg),
                   var_loss_weight=schedules.var_loss_weight(s, tcfg))
    rt_j = {k: jnp.asarray(v, jnp.float32) for k, v in runtime.items()}
    key = jax.random.PRNGKey(123)
    draws = jax_draws(key, n_rays, st, jt.data["train_ids"].shape[0],
                      jt.dataset.height, jt.dataset.width,
                      jt.tree_host.edge_t.shape[0])

    # JAX gradients of the step's loss (make_core's loss_fn) ...
    k_rays, k_render = jax.random.split(key)
    rays_o, rays_d, _, gt, img_idx = jds.sample_rays(
        jt.data, k_rays, n_rays, jt.dataset.height, jt.dataset.width)
    loss_w = dict(disp_loss_weight=float(tcfg["disp_loss_weight"]),
                  tv_loss_weight=float(tcfg["tv_loss_weight"]))

    def loss_fn(p):
        result, _ = jrender(p, jt.consts, jt.tree, rays_o, rays_d, img_idx, k_render,
                            rt_j["fineness"], rt_j["grad_progress"], st)
        loss, aux = jtr.compute_losses(result, gt, n_rays, loss_w, rt_j)
        aux["stats"] = result["stats"]
        return loss, aux

    g_j, aux_g = jax.jit(jax.grad(loss_fn, has_aux=True))(jt.params)
    # ... and the step itself (fused Pallas Adam in interpret mode)
    p_j, o_j, tree_j, aux_j = step_fn(jt.params, jt.opt_state, jt.tree, jt.consts,
                                      jt.data, key, rt_j, n_rays)
    jax_side = dict(
        loss=float(aux_j["loss"]), stats={k: float(v) for k, v in aux_j["stats"].items()},
        grads=dict(named_leaves(jax.tree_util.tree_map(np.asarray, g_j))),
        params=dict(named_leaves(jax.tree_util.tree_map(np.asarray, p_j))),
        mu=dict(named_leaves(jax.tree_util.tree_map(np.asarray, o_j[1].mu))),
        count=int(o_j[1].count), finite=bool(aux_j["grads_finite"]),
        occ={k: np.asarray(getattr(tree_j, k)) for k in OCC})

    # the port: load the JAX checkpoint, one step with the same draws/shapes
    with np.load(os.path.join(ckpt, "state.npz")) as z:
        host = convert.octree_from_named(z)
    pt = ttr.Trainer(cfg, str(tmp_path_factory.mktemp("port_exp")), data_dir,
                     device="cpu", tree_host=host)
    pt.load_checkpoint(ckpt)
    core = ttr.make_core(cfg, RenderStatics(**st._asdict()), pt.dataset.height,
                         pt.dataset.width)
    rt_t = {k: torch.tensor(v, dtype=torch.float32) for k, v in runtime.items()}
    tree_t, aux_t, g_t = core(pt.params, pt.opt_state, pt.tree, pt.consts, pt.data,
                              rt_t, draws, n_rays)
    port_side = dict(
        loss=float(aux_t["loss"]), stats={k: float(v) for k, v in aux_t["stats"].items()},
        grads={k: v.numpy() for k, v in named_leaves(g_t)},
        params={k: v.detach().numpy() for k, v in named_leaves(pt.params)},
        mu={k: v.numpy() for k, v in named_leaves(pt.opt_state["mu"])},
        count=int(pt.opt_state["count"]), finite=bool(aux_t["grads_finite"]),
        occ={k: getattr(tree_t, k).numpy() for k in OCC})
    pt.tree = tree_t
    pt.save_checkpoint()
    jax_side["terms"] = {k: float(aux_g[k]) for k in LOSS_TERMS}
    port_side["terms"] = {k: float(aux_t[k]) for k in LOSS_TERMS}
    return dict(jax=jax_side, port=port_side, lr=runtime["lr"], cfg=cfg,
                data_dir=data_dir, grad_loss=float(aux_g["loss"]), jax_trainer=jt,
                port_trainer=pt, statics=st,
                port_ckpt=os.path.join(pt.base_exp_dir, "checkpoints", "latest"))


def test_loss_and_sample_counts_match(steps):
    j, p = steps["jax"], steps["port"]
    assert j["loss"] == pytest.approx(steps["grad_loss"], rel=1e-6)
    assert p["loss"] == pytest.approx(j["loss"], rel=STEP_TOL["loss_rtol"])
    for k in ("n_sampled", "n_meaningful", "n_oct_hits", "max_oct_hits",
              "overflow_a", "overflow_b", "n_saturated", "n_trav_truncated"):
        assert p["stats"][k] == j["stats"][k], k
    assert p["finite"] and j["finite"]


@pytest.mark.parametrize("leaf", ["['feat_pool']", "['field_mlp'][0]", "['field_mlp'][2]",
                                  "['shader_mlp'][0]", "['shader_mlp'][3]", "['app_emb']"])
def test_gradient_matches(steps, leaf):
    a = steps["port"]["grads"][leaf].astype(np.float64)
    b = steps["jax"]["grads"][leaf].astype(np.float64)
    assert np.linalg.norm(b) > 0
    assert np.linalg.norm(a - b) <= STEP_TOL["grad_rel"] * np.linalg.norm(b)


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
        assert np.linalg.norm(a - b) <= STEP_TOL["grad_rel"] * np.linalg.norm(b), k
    for k in OCC:
        np.testing.assert_array_equal(p["occ"][k], j["occ"][k], err_msg=k)


def test_port_checkpoint_resumes_in_jax(steps):
    """The port writes the JAX package's name-keyed state.npz: the JAX
    Trainer resumes from it with the port's params, Adam state and tree."""
    jt, port_dir = steps["jax_trainer"], steps["port_ckpt"]
    jt.load_checkpoint(port_dir)
    got = dict(named_leaves(jax.tree_util.tree_map(np.asarray, jt.params)))
    for k, v in steps["port"]["params"].items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert int(jt.opt_state[1].count) == 3
    assert jt.consts["prim_pool"].dtype == jnp.uint32
    np.testing.assert_array_equal(np.asarray(jt.tree.weight_stats)[:jt.tree_host.n_nodes],
                                  steps["port"]["occ"]["weight_stats"][:jt.tree_host.n_nodes])


def test_port_trainer_runs_three_steps(steps, tmp_path):
    """The port's own Trainer (its own octree build on the CPU): finite
    losses, finite gradients, params that move."""
    pt = ttr.Trainer(steps["cfg"], str(tmp_path / "own"), steps["data_dir"],
                     device="cpu", seed=7)
    before = {k: v.detach().clone() for k, v in named_leaves(pt.params)}
    for _ in range(3):
        m = pt.train_one()
        assert np.isfinite(m["loss"]) and m["grads_finite"] == 1.0, m
        assert m["n_meaningful"] > 0.8 * m["n_sampled"] > 0, m
    assert pt.iter_step == 3
    moved = max((v.detach() - before[k]).abs().max().item()
                for k, v in named_leaves(pt.params))
    assert moved > 0
    assert int(pt.opt_state["count"]) == 3
