"""The port's host-side variants against the JAX package: the
``data_at_gpu=false`` host loader (picks from the same numpy generator,
the native pixel gather), ``ray_sample_mode=single_image``,
``rays_interpolate`` / ``rand_rays_whole_space`` with ``pose_interpolate``,
``Trainer.reset``, the ``train.data_parallel`` guard and the Runner's
profile window.

Tolerances: picks, pixels and poses must be equal (the same host code and
generator; poses to 1e-6); rays to one ulp of a unit-size component
(RAY_D_ATOL, as tests/test_torch_eval.py: JAX forms R @ d with einsum,
the port term by term). Where the host generators differ (torch against
numpy or jax), the JAX package's own properties are held instead.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f2nerf_tpu.core import camera as jcam
from f2nerf_tpu.data import dataset as jds
from f2nerf_tpu.train import trainer as jtr
from f2nerf_tpu.utils.config import compose
from f2nerf_tpu.utils.synthetic import TINY_OVERRIDES, write_ball_dataset
from f2nerf_torch import native as tnative
from f2nerf_torch.core import camera as tcam
from f2nerf_torch.data import dataset as tds
from f2nerf_torch.parallel import data_parallel as tdp
from f2nerf_torch.train import runner as trun
from f2nerf_torch.train import trainer as ttr
from f2nerf_torch.utils.tree import named_leaves
from test_torch_train_step import jax_draws

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OVERRIDES = list(TINY_OVERRIDES) + ["+train.fused_adam=true", "+train.data_parallel=off"]
RAY_D_ATOL = 2.4e-7


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in parallel worker processes; torch's own intra-op
    pool would oversubscribe the cores, and these are small ops that gain
    nothing from it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ds_pair(tmp_path_factory):
    data_dir = write_ball_dataset(str(tmp_path_factory.mktemp("ball")))
    cfg = compose(os.path.join(REPO, "confs"), "wanjinyou", OVERRIDES)
    jd = jds.Dataset(data_dir, cfg["dataset"])
    td = tds.Dataset(data_dir, cfg["dataset"])
    return dict(cfg=cfg, data_dir=data_dir, jd=jd, td=td, jdata=jd.device_arrays(),
                tdata=td.device_arrays("cpu"))


def test_sample_pixels_matches_native_case():
    """tests/test_native.py::test_sample_pixels's case through the port's
    copy of the engine."""
    rng = np.random.RandomState(1)
    imgs = rng.randint(0, 255, (3, 8, 10, 3), dtype=np.uint8)
    k = 64
    ii = rng.randint(0, 3, k).astype(np.int32)
    ys = rng.randint(0, 8, k).astype(np.int32)
    xs = rng.randint(0, 10, k).astype(np.int32)
    out = tnative.sample_pixels(imgs, ii, ys, xs)
    want = imgs[ii, ys, xs].astype(np.float32) / 255.0
    np.testing.assert_allclose(out, want, atol=1e-6)
    with pytest.raises(ValueError):
        tnative.sample_pixels(imgs[..., :2], ii, ys, xs)


def test_host_sample_matches_jax(ds_pair):
    """The same picks and pixels as the JAX Trainer's ``_host_sample`` for
    the same seed (np.random.default_rng(seed + 1) on both sides), and the
    host batch's rays equal JAX's ray generation for it."""
    seed, n = 2022, 300
    fake = dict(dataset=ds_pair["jd"], _host_rng=np.random.default_rng(seed + 1))
    want = [jtr.Trainer._host_sample(types.SimpleNamespace(**fake), n) for _ in range(2)]
    fake.update(dataset=ds_pair["td"], _host_rng=np.random.default_rng(seed + 1),
                device=torch.device("cpu"), n_shards=1, rank=0)
    got = [ttr.Trainer._host_sample(types.SimpleNamespace(**fake), n) for _ in range(2)]
    for g, w in zip(got, want):
        for k in ("img_idx", "i", "j", "gt"):
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]), err_msg=k)
    # two ranks: each draws the global batch from its own copy of the host
    # generator and keeps its half (JAX's P("data") split of the batch)
    halves = []
    for rank in range(2):
        fake.update(_host_rng=np.random.default_rng(seed + 1), n_shards=2, rank=rank)
        halves.append(ttr.Trainer._host_sample(types.SimpleNamespace(**fake), n))
    for k in ("img_idx", "i", "j", "gt"):
        np.testing.assert_array_equal(torch.cat([h[k] for h in halves]).numpy(),
                                      np.asarray(want[0][k]), err_msg=k)
    ro, rd, gt, img = tds.host_batch_rays(ds_pair["tdata"], got[0])
    w = want[0]
    jro, jrd = jcam.pixel_to_ray(ds_pair["jdata"]["poses"][w["img_idx"]],
                                 ds_pair["jdata"]["intri"][w["img_idx"]],
                                 ds_pair["jdata"]["dist"][w["img_idx"]],
                                 w["i"] + 0.5, w["j"] + 0.5)
    np.testing.assert_array_equal(ro.numpy(), np.asarray(jro))
    np.testing.assert_allclose(rd.numpy(), np.asarray(jrd), rtol=0, atol=RAY_D_ATOL)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(w["gt"]))


def test_single_image_rays_match_jax(ds_pair):
    """The JAX single-image sampler's draws (its split order) through the
    port's ``sample_rays`` give its rays, pixels and image ids; the port's
    own single-image draws share one camera."""
    jd, td = ds_pair["jd"], ds_pair["td"]
    key, n = jax.random.PRNGKey(5), 256
    st = types.SimpleNamespace(max_s=8, n_edge=4)
    n_train = len(jd.train_set)
    d = jax_draws(key, n, st, n_train, jd.height, jd.width, 1, single_image=True)
    k_rays, _ = jax.random.split(key)
    jro, jrd, _, jgt, jimg = jds.sample_rays_single_image(
        ds_pair["jdata"], k_rays, n, jd.height, jd.width)
    ro, rd, _, gt, img = tds.sample_rays(ds_pair["tdata"], d["cam_pick"], d["i"], d["j"])
    assert len(set(np.asarray(jimg).tolist())) == 1
    np.testing.assert_array_equal(img.numpy(), np.asarray(jimg))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(jgt))
    np.testing.assert_array_equal(ro.numpy(), np.asarray(jro))
    np.testing.assert_allclose(rd.numpy(), np.asarray(jrd), rtol=0, atol=RAY_D_ATOL)
    own = tds.draw_rays_single_image(ds_pair["tdata"], torch.Generator().manual_seed(0),
                                     n, td.height, td.width)
    assert own["cam_pick"].unique().numel() == 1 and own["i"].shape == (n,)
    assert int(own["i"].max()) < td.height and int(own["j"].max()) < td.width


@pytest.mark.parametrize("alpha", [0.0, 0.3, 1.0])
def test_rays_interpolate_matches_jax(ds_pair, alpha):
    jd = ds_pair["jd"]
    p0, p1 = jd.poses[2], jd.poses[9]
    np.testing.assert_allclose(tcam.pose_interpolate(p0, p1, alpha),
                               jcam.pose_interpolate(p0, p1, alpha), atol=1e-6)
    jro, jrd = jds.rays_interpolate(ds_pair["jdata"], 2, 9, alpha, jd.height, jd.width, 2)
    ro, rd = tds.rays_interpolate(ds_pair["tdata"], 2, 9, alpha, jd.height, jd.width, 2)
    np.testing.assert_allclose(ro.numpy(), np.asarray(jro), atol=1e-6)
    np.testing.assert_allclose(rd.numpy(), np.asarray(jrd), rtol=0, atol=1e-6)


def test_pose_interpolate_quaternion_branches():
    """Rotations by pi about each axis take the w < 1e-6 branches; the
    port's host code equals the JAX package's."""
    for axis in range(3):
        r = -np.eye(3)
        r[axis, axis] = 1.0
        p0 = np.concatenate([r, np.zeros((3, 1))], 1).astype(np.float32)
        p1 = np.concatenate([np.eye(3), np.ones((3, 1))], 1).astype(np.float32)
        np.testing.assert_allclose(tcam.pose_interpolate(p0, p1, 0.25),
                                   jcam.pose_interpolate(p0, p1, 0.25), atol=1e-6)


def test_rand_rays_whole_space_matches_jax(ds_pair):
    """The JAX function draws its host seed with ``randint(key, (), 0,
    1 << 31)``, which overflows int32 under this jax (ROADMAP queue 3), so
    its remaining steps (dataset.py:210-222) are run here from a seed: the
    port's ``whole_space_pose`` gives the pose the JAX package's
    ``pose_interpolate`` steps give, and its pixels the same rays. The
    port's own draws (a torch generator) hold JAX's properties: one
    origin, finite directions."""
    jd = ds_pair["jd"]
    key, n, seed = jax.random.PRNGKey(11), 128, 123456789
    rng = np.random.RandomState(seed)
    base = rng.randint(0, max(jd.n_images - 10, 1))
    a, b, c = (base + rng.randint(0, 10, 3)) % jd.n_images
    wa, wb, wc = rng.rand(3) + 1e-7
    want = jcam.pose_interpolate(jd.poses[a], jd.poses[b], wb / (wb + wa))
    want = jcam.pose_interpolate(want, jd.poses[c], wc / (wa + wb + wc))
    pose = tds.whole_space_pose(jd.poses, np.random.RandomState(seed))
    np.testing.assert_allclose(pose, want, atol=1e-6)
    k1, k2 = jax.random.split(key)
    i = jax.random.randint(k1, (n,), 0, jd.height).astype(jnp.float32) + 0.5
    j = jax.random.randint(k2, (n,), 0, jd.width).astype(jnp.float32) + 0.5
    jro, jrd = jcam.pixel_to_ray(jnp.asarray(want), ds_pair["jdata"]["intri"][0],
                                 ds_pair["jdata"]["dist"][0], i, j)
    ro, rd = tcam.pixel_to_ray(torch.from_numpy(pose), ds_pair["tdata"]["intri"][0],
                               ds_pair["tdata"]["dist"][0], torch.from_numpy(np.asarray(i)),
                               torch.from_numpy(np.asarray(j)))
    np.testing.assert_allclose(ro.numpy(), np.asarray(jro), atol=1e-6)
    np.testing.assert_allclose(rd.numpy(), np.asarray(jrd), rtol=0, atol=1e-6)
    ro2, rd2 = tds.rand_rays_whole_space(ds_pair["tdata"], torch.Generator().manual_seed(1),
                                         n, jd.height, jd.width)
    assert ro2.shape == rd2.shape == (n, 3)
    assert torch.equal(ro2, ro2[:1].expand_as(ro2))
    assert float(ro2[0].norm()) <= 1.0 + 1e-5      # inside the camera ring
    assert torch.isfinite(rd2).all()


@pytest.fixture(scope="module")
def host_trainer(ds_pair, tmp_path_factory):
    """A port Trainer with the host loader and single-image sampling."""
    cfg = compose(os.path.join(REPO, "confs"), "wanjinyou", OVERRIDES + [
        "dataset.data_at_gpu=false", "dataset.ray_sample_mode=single_image"])
    return ttr.Trainer(cfg, str(tmp_path_factory.mktemp("host")), ds_pair["data_dir"],
                       device="cpu", seed=3)


def test_host_loader_trainer_steps(host_trainer):
    pt = host_trainer
    assert "train_images" not in pt.data and not pt.data_at_gpu
    for _ in range(2):
        m = pt.train_one()
        assert np.isfinite(m["loss"]) and m["grads_finite"] == 1.0, m
    st = pt._get_step(m["n_rays"])[1]
    draws = pt.draw(st, 64)
    assert set(draws) >= {"gt", "img_idx", "i", "j", "jitter", "bg"}
    assert float(draws["gt"].max()) <= 1.0


def test_reset_reinitialises_field_and_shader(host_trainer):
    """Trainer.reset: pool ~ U(-1e-2, 1e-2), MLPs re-drawn within their
    He-uniform bounds, Adam state zero, the appearance embedding kept; the
    JAX Trainer's reset holds the same properties (its generator differs)."""
    pt = host_trainer
    app = pt.params["app_emb"].detach().clone()
    before = {k: v.detach().clone() for k, v in named_leaves(pt.params)}
    pt.reset()
    pool = pt.params["feat_pool"].detach()
    assert pt.params["feat_pool"].requires_grad and pool.shape == before["['feat_pool']"].shape
    assert -1e-2 <= float(pool.min()) and float(pool.max()) < 1e-2
    assert float(pool.std()) > 5e-3
    for name in ("field_mlp", "shader_mlp"):
        for k, w in enumerate(p.detach() for p in pt.params[name]):
            lim = (6.0 / w.shape[0]) ** 0.5
            assert w.shape == before[f"['{name}'][{k}]"].shape
            assert float(w.abs().max()) <= lim
            assert not torch.equal(w, before[f"['{name}'][{k}]"])
    assert torch.equal(pt.params["app_emb"].detach(), app)
    assert int(pt.opt_state["count"]) == 0
    assert all(float(v.abs().max()) == 0.0 for _, v in named_leaves(pt.opt_state["mu"]))
    m = pt.train_one()
    assert np.isfinite(m["loss"]) and m["grads_finite"] == 1.0
    assert int(pt.opt_state["count"]) == 1


def test_data_parallel_guard(ds_pair, tmp_path):
    """A shard is a torch.distributed rank: 'auto'/'on' mean the world
    size, and 'off' or an int pin must equal it, else ValueError naming
    torchrun (with no process group the world size is 1)."""
    dps = tdp.data_parallel_shards
    assert dps("auto", 1) == 1 and dps("on", 3) == 3 and dps(True, 2) == 2
    assert dps("off", 1) == 1 and dps(False, 1) == 1
    assert dps(4, 4) == 4 and dps("2", 2) == 2
    for pin, world in (("off", 2), (4, 1), ("2", 3)):
        with pytest.raises(ValueError, match="torchrun --nproc_per_node"):
            dps(pin, world)
    cfg = compose(os.path.join(REPO, "confs"), "wanjinyou",
                  list(TINY_OVERRIDES) + ["+train.data_parallel=2"])
    with pytest.raises(ValueError, match="torchrun --nproc_per_node=2"):
        ttr.Trainer(cfg, str(tmp_path / "dp"), ds_pair["data_dir"], device="cpu")


def test_profile_window_writes_a_trace(tmp_path):
    out = tmp_path / "prof"
    w = trun.ProfileWindow(str(out), start=2, stop=4)
    for it in range(6):
        w.at(it)
        torch.ones(8).sum()
    assert sorted(os.listdir(out)) == ["trace_2_4.json"]
    w2 = trun.ProfileWindow(str(tmp_path / "cut"), start=1, stop=50)
    w2.at(1)
    w2.close(3)                        # training ended inside the window
    assert os.listdir(tmp_path / "cut") == ["trace_1_3.json"]
    trun.ProfileWindow(None).at(30)    # off without a directory


def test_runner_reset_flag(ds_pair, tmp_path):
    """The config's ``reset`` flag: the Runner builds its Trainer, then
    re-initialises its field and shader (the pool in U(-1e-2, 1e-2), where
    the init draws U[-1e-4, -0.8e-4))."""
    cfg = compose(os.path.join(REPO, "confs"), "wanjinyou", OVERRIDES)
    cfg.update(base_exp_dir=str(tmp_path / "exp"), reset=True, mode="test",
               device="cpu")
    cfg["dataset"]["data_path"] = ds_pair["data_dir"]
    runner = trun.Runner(cfg)
    pool = runner.trainer.params["feat_pool"].detach()
    assert float(pool.abs().max()) <= 1e-2 and float(pool.std()) > 5e-3
    assert int(runner.trainer.opt_state["count"]) == 0
