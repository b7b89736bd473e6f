"""The port's eval path against the JAX package: camera and pose rays, the
single-pass eval ``render``, ``Trainer.render_image`` with its re-render
tier, and the metrics and writers the runner uses.

One tiny JAX Trainer (TINY_OVERRIDES, one device, ``eval.chunk`` 512)
saves its state with its feature pool replaced by a seeded N(0, 3^2) draw,
so density varies across the image (colours 0.08-0.62 on a test camera);
the port loads that state.npz. Tolerances and their reasons are
EVAL_TOL in f2nerf_torch/utils/parity.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from f2nerf_tpu.data import dataset as jds
from f2nerf_tpu.render.renderer import render as jrender
from f2nerf_tpu.train import trainer as jtr
from f2nerf_tpu.utils import io as jio
from f2nerf_tpu.utils import metrics as jmet
from f2nerf_tpu.utils.config import compose
from f2nerf_tpu.utils.synthetic import TINY_OVERRIDES, write_ball_dataset
from f2nerf_torch.data import dataset as tds
from f2nerf_torch.render.renderer import RenderStatics, check_supported
from f2nerf_torch.render.renderer import render as trender
from f2nerf_torch.train import trainer as ttr
from f2nerf_torch.utils import convert
from f2nerf_torch.utils import io as tio
from f2nerf_torch.utils import metrics as tmet
from f2nerf_torch.utils.parity import EVAL_TOL, eval_agrees, image_errors

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OVERRIDES = list(TINY_OVERRIDES) + ["+train.data_parallel=off", "+eval.chunk=512"]
# the JAX package forms R @ (u, -v, -1) with einsum, the port term by term
# (bitwise equal on the CPU and the card): one ulp of a unit-size component
RAY_D_ATOL = 2.4e-7


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in parallel worker processes; torch's own intra-op
    pool would oversubscribe the cores, and these renders are many small
    ops that gain nothing from it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    data_dir = write_ball_dataset(str(tmp_path_factory.mktemp("ball")))
    cfg = compose(os.path.join(REPO, "confs"), "wanjinyou", OVERRIDES)
    jt = jtr.Trainer(cfg, str(tmp_path_factory.mktemp("jax_exp")), data_dir, seed=2022)
    feat = np.random.RandomState(0).randn(*jt.params["feat_pool"].shape) * 3.0
    jt.params["feat_pool"] = jnp.asarray(feat.astype(np.float32))
    jt.save_checkpoint()
    ckpt = os.path.join(jt.base_exp_dir, "checkpoints", "latest")
    with np.load(os.path.join(ckpt, "state.npz")) as z:
        host = convert.octree_from_named(z)
    pt = ttr.Trainer(cfg, str(tmp_path_factory.mktemp("port_exp")), data_dir,
                     device="cpu", tree_host=host)
    pt.load_checkpoint(ckpt)
    assert pt.hit_cap == jt.hit_cap
    cam = int(jt.dataset.test_set[1])
    ro, rd = jds.camera_rays(jt.data, cam, jt.dataset.height, jt.dataset.width)
    return dict(jt=jt, pt=pt, cfg=cfg, cam=cam, rays=(np.asarray(ro), np.asarray(rd)))


@pytest.mark.parametrize("reso", [1, 2])
def test_camera_rays_match_jax(pair, reso):
    jt, pt, cam = pair["jt"], pair["pt"], pair["cam"]
    h, w = jt.dataset.height, jt.dataset.width
    ro_j, rd_j = jds.camera_rays(jt.data, cam, h, w, reso)
    ro_t, rd_t = tds.camera_rays(pt.data, cam, h, w, reso)
    assert rd_t.shape == ((h // reso) * (w // reso), 3)
    np.testing.assert_array_equal(ro_t.numpy(), np.asarray(ro_j))
    np.testing.assert_allclose(rd_t.numpy(), np.asarray(rd_j), rtol=0, atol=RAY_D_ATOL)


@pytest.mark.parametrize("reso", [1, 3])
def test_pose_rays_match_jax(pair, reso):
    jt, pt = pair["jt"], pair["pt"]
    h, w = jt.dataset.height, jt.dataset.width
    pose = jt.dataset.poses[5]
    ro_j, rd_j = jds.pose_rays(jt.data, jnp.asarray(pose), h, w, reso)
    ro_t, rd_t = tds.pose_rays(pt.data, pose, h, w, reso)
    np.testing.assert_array_equal(ro_t.numpy(), np.asarray(ro_j))
    np.testing.assert_allclose(rd_t.numpy(), np.asarray(rd_j), rtol=0, atol=RAY_D_ATOL)


def test_eval_render_matches_jax(pair):
    """64 rays through the single-pass eval render: the port against JAX
    op by op (every ray), and against JAX compiled (outlier form)."""
    jt, pt, cfg = pair["jt"], pair["pt"], pair["cfg"]
    ro, rd = (np.array(x[1000:1064]) for x in pair["rays"])
    n, max_s = ro.shape[0], 128
    st = jtr.render_statics(cfg, n, jt.dataset.near, train=False, max_s=max_s,
                            cap1=n * max_s, cap2=n * max_s,
                            max_hits=jt.hit_cap)._replace(single_pass=True)
    args = (jt.params, jt.consts, jt.tree, jnp.asarray(ro), jnp.asarray(rd),
            jnp.zeros((n,), jnp.int32), jax.random.PRNGKey(0),
            jnp.asarray(1.0, jnp.float32), jnp.asarray(1.0))
    with jax.disable_jit():
        eager, occ_j = jrender(*args, st)
    compiled, _ = jax.jit(lambda *a: jrender(*a, st))(*args)
    with torch.no_grad():
        got, occ_t = trender(pt.params, pt.consts, pt.tree, torch.from_numpy(ro),
                             torch.from_numpy(rd), torch.zeros(n, dtype=torch.int32),
                             None, torch.tensor(1.0), torch.tensor(1.0),
                             RenderStatics(**st._asdict()))
    assert occ_j is None and occ_t is None and got["edge_feats"] is None
    for k in eager["stats"]:
        assert float(got["stats"][k]) == float(eager["stats"][k]), k
    assert float(got["stats"]["n_meaningful"]) > 0.5 * float(got["stats"]["n_sampled"]) > 0
    np.testing.assert_array_equal(got["ray_id"].numpy(), np.asarray(eager["ray_id"]))
    err = image_errors(got["colors"], got["disparity"], eager["colors"], eager["disparity"])
    assert eval_agrees(err, exact=True), err
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(eager["depth"]),
                               rtol=EVAL_TOL["depth_rtol"], atol=1e-6)
    np.testing.assert_allclose(got["first_oct_dis"].numpy(),
                               np.asarray(eager["first_oct_dis"]), atol=EVAL_TOL["oct_atol"])
    err_c = image_errors(got["colors"], got["disparity"], compiled["colors"],
                         compiled["disparity"])
    assert eval_agrees(err_c, exact=False), err_c


def spy_redo(jt, rays_d, monkeypatch):
    """Record the start ray of every chunk the JAX render_image renders
    again (its exact tier is built with cap1=None)."""
    redo = []
    orig = jt._eval_fn_for

    def eval_fn_for(chunk, max_s, cap1=None):
        fn = orig(chunk, max_s, cap1)
        if cap1 is not None:
            return fn

        def wrapped(params, consts, tree, ro, rd, fineness):
            first = np.asarray(rd)[0]
            redo.append(next(lo for lo in range(0, len(rays_d), chunk)
                             if np.array_equal(rays_d[lo], first)))
            return fn(params, consts, tree, ro, rd, fineness)
        return wrapped

    monkeypatch.setattr(jt, "_eval_fn_for", eval_fn_for)
    return redo


@pytest.mark.parametrize("max_s,want_redo", [(512, False), (24, True), (32, True)])
def test_render_image_matches_jax(pair, monkeypatch, max_s, want_redo):
    """The two-tier chunked render: the same chunks rendered again (a
    ray at the dense cap ``max_s`` forces it), the same image."""
    jt, pt = pair["jt"], pair["pt"]
    ro, rd = pair["rays"]
    redo_j = spy_redo(jt, rd, monkeypatch)
    cj, dj, oj = jt.render_image(ro, rd, max_s=max_s, max_s_hi=512)
    ct, dt, ot = pt.render_image(ro, rd, max_s=max_s, max_s_hi=512)
    assert pt.last_redo == redo_j
    assert bool(redo_j) == want_redo
    assert ct.shape == (ro.shape[0], 3) and np.isfinite(ct).all()
    assert ct.max() - ct.min() > 0.3          # density varies across the image
    err = image_errors(ct, dt, cj, dj)
    assert eval_agrees(err, exact=False), err
    np.testing.assert_allclose(ot, oj, atol=EVAL_TOL["oct_atol"])


def test_check_supported_admits_eval_single_pass_only(pair):
    """Every variant of the JAX renderer is admitted (train or eval,
    single or two pass, both fields, both marchers); an unknown field type
    or march mode raises."""
    st = ttr.render_statics(pair["cfg"], 64, 0.1, train=False)
    for train in (False, True):
        for single_pass in (False, True):
            for field_type in ("HashBlock", "Hash3DAnchored"):
                for march_mode in ("parallel", "lockstep"):
                    check_supported(st._replace(train=train, single_pass=single_pass,
                                                field_type=field_type,
                                                march_mode=march_mode))
    with pytest.raises(ValueError):
        check_supported(st._replace(field_type="Hash4D"))
    with pytest.raises(ValueError):
        check_supported(st._replace(march_mode="sphere_trace"))


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_match_jax(seed):
    rng = np.random.RandomState(seed)
    gt = rng.rand(40, 60, 3).astype(np.float32)
    pred = np.clip(gt + rng.randn(40, 60, 3).astype(np.float32) * 0.05, 0, 1)
    assert tmet.psnr_float(gt, pred) == pytest.approx(jmet.psnr_float(gt, pred), abs=1e-12)
    assert tmet.rgb_ssim(gt, pred) == pytest.approx(jmet.rgb_ssim(gt, pred), abs=1e-12)
    assert tmet.make_lpips() is None and jmet.make_lpips() is None


def test_io_writers_match_jax(pair, tmp_path):
    img = np.random.RandomState(2).rand(40, 60, 3).astype(np.float32) * 1.2 - 0.1
    jio.write_image(str(tmp_path / "j" / "a.png"), img)
    tio.write_image(str(tmp_path / "t" / "a.png"), img)
    a = np.asarray(Image.open(tmp_path / "j" / "a.png"))
    b = np.asarray(Image.open(tmp_path / "t" / "a.png"))
    np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(tio.read_image(str(tmp_path / "t" / "a.png")),
                                  jio.read_image(str(tmp_path / "j" / "a.png")))
    jt, pt = pair["jt"], pair["pt"]
    pos = pt.dataset.poses[:, :3, 3]
    jio.export_pcd(str(tmp_path / "j" / "cam_pos.ply"), jt.dataset.poses[:, :3, 3])
    tio.export_pcd(str(tmp_path / "t" / "cam_pos.ply"), pos)
    jio.export_octree_obj(str(tmp_path / "j" / "octree.obj"), jt.tree_host)
    tio.export_octree_obj(str(tmp_path / "t" / "octree.obj"), pt.tree_host)
    for name in ("cam_pos.ply", "octree.obj"):
        text = (tmp_path / "t" / name).read_text()
        assert text == (tmp_path / "j" / name).read_text(), name
        assert len(text) > 100
