"""The port's small ops against the JAX package on identical inputs:
segment ops, activations (forward and backward), the bf16 MLP, SH, camera
rays with distortion, and the host code the port carries as copies
(config composer, schedules, synthetic scene).

Inputs come from numpy seeds and go to both packages. Tolerances:
  * elementwise f32 math (camera, SH, activations): rtol 1e-5 — the two
    packages round at the same operations, but XLA may contract a multiply
    and an add into one FMA (1 ulp);
  * segment sums / scans: rtol 1e-5, atol 1e-6 — other summation orders
    (the port's segmented cumsum runs in f64);
  * the MLP: rtol/atol 1e-4 on outputs and 1e-3 on gradients scaled by the
    largest entry — bf16-rounded inputs give exact products, but hidden
    activations are re-rounded to bf16 after f32 sums taken in another
    order, and the gradients are bf16-rounded at each layer.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f2nerf_tpu.core import camera as jcam
from f2nerf_tpu.fields import mlp as jmlp
from f2nerf_tpu.fields import sh as jsh
from f2nerf_tpu.ops import activations as jact
from f2nerf_tpu.ops import segment as jseg
from f2nerf_tpu.train import schedules as jsched
from f2nerf_tpu.utils import config as jconfig
from f2nerf_tpu.utils import synthetic as jsyn
from f2nerf_torch.core import camera as tcam
from f2nerf_torch.fields import mlp as tmlp
from f2nerf_torch.fields import sh as tsh
from f2nerf_torch.ops import activations as tact
from f2nerf_torch.ops import segment as tseg
from f2nerf_torch.train import schedules as tsched
from f2nerf_torch.utils import config as tconfig
from f2nerf_torch.utils import synthetic as tsyn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFS = os.path.join(REPO, "confs")


def T(x):
    return torch.from_numpy(np.array(x, copy=True))


def ragged(seed: int, n_rays: int = 40, max_count: int = 30, pad: int = 25):
    """Sorted ray ids with empty rays and trailing padding (== n_rays)."""
    rng = np.random.RandomState(seed)
    counts = rng.randint(0, max_count, n_rays)
    counts[rng.randint(0, n_rays, 4)] = 0
    rid = np.repeat(np.arange(n_rays), counts)
    rid = np.concatenate([rid, np.full(pad, n_rays)]).astype(np.int32)
    x = rng.uniform(0.0, 2.0, rid.shape[0]).astype(np.float32)
    return rid, x, n_rays


# ------------------------------------------------------------- segment ops

@pytest.mark.parametrize("seed", [0, 1])
def test_segment_sum_max_match_jax(seed):
    rid, x, n = ragged(seed)
    x2 = np.stack([x, -x, 2 * x], -1)
    np.testing.assert_allclose(tseg.segment_sum(T(x), T(rid), n).numpy(),
                               np.asarray(jseg.segment_sum(jnp.asarray(x), jnp.asarray(rid), n)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tseg.segment_sum(T(x2), T(rid), n).numpy(),
                               np.asarray(jseg.segment_sum(jnp.asarray(x2), jnp.asarray(rid), n)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tseg.segment_max(T(x), T(rid), n).numpy(),
                                  np.asarray(jseg.segment_max(jnp.asarray(x), jnp.asarray(rid), n)))


@pytest.mark.parametrize("exclusive", [True, False])
def test_segment_cumsum_matches_jax(exclusive):
    rid, x, n = ragged(2)
    tf = tseg.first_flags_from_ray_id(T(rid), n)
    jf = jseg.first_flags_from_ray_id(jnp.asarray(rid), n)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    got = tseg.segment_cumsum(T(x), tf, exclusive=exclusive).numpy()
    want = np.asarray(jseg.segment_cumsum(jnp.asarray(x), jf, exclusive=exclusive))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_segment_cumsum_long_buffer_keeps_precision():
    """393k samples of ~1: a global f32 cumsum minus segment bases would be
    off by ~0.03 at the end; the port accumulates in f64."""
    n_rays, per = 2048, 192
    rid = np.repeat(np.arange(n_rays), per).astype(np.int32)
    x = np.random.RandomState(0).uniform(0.5, 1.5, rid.shape[0]).astype(np.float32)
    got = tseg.segment_cumsum(T(x), tseg.first_flags_from_ray_id(T(rid), n_rays)).numpy()
    want = np.concatenate([np.concatenate([[0.0], np.cumsum(x[k * per:(k + 1) * per],
                                                            dtype=np.float64)[:-1]])
                           for k in range(n_rays)])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


def test_local_index_matches_jax():
    rid, _, n = ragged(3)
    np.testing.assert_array_equal(
        tseg.local_index(T(rid), n).numpy(),
        np.asarray(jseg.local_index(jnp.asarray(rid), n)))


def test_segment_cumsum_backward_matches_jax():
    rid, x, n = ragged(4)
    w = np.random.RandomState(5).randn(x.shape[0]).astype(np.float32)
    jf = jseg.first_flags_from_ray_id(jnp.asarray(rid), n)
    gj = jax.grad(lambda v: jnp.sum(jseg.segment_cumsum(v, jf) * w))(jnp.asarray(x))
    xt = T(x).requires_grad_(True)
    (tseg.segment_cumsum(xt, tseg.first_flags_from_ray_id(T(rid), n)) * T(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gj), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- activations

def test_trunc_exp_forward_backward():
    x = np.array([-120.0, -3.0, 0.0, 2.0, 4.9, 5.0, 10.0], np.float32)
    gj = jax.grad(lambda v: jnp.sum(jact.trunc_exp(v)))(jnp.asarray(x))
    xt = T(x).requires_grad_(True)
    y = tact.trunc_exp(xt)
    y.sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jact.trunc_exp(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-38)
    # atol: XLA flushes exp(-100) (a subnormal) to zero, torch keeps it
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gj), rtol=1e-5, atol=1e-38)
    np.testing.assert_allclose(tact.density_activation(torch.tensor(3.0)).item(), 1.0,
                               rtol=1e-6)


@pytest.mark.parametrize("progress", [0.0, 0.3, 1.0])
def test_gradient_scaling_backward(progress):
    rng = np.random.RandomState(6)
    a = rng.uniform(0, 1, 16).astype(np.float32)
    x = rng.randn(16, 3).astype(np.float32)
    gy = rng.randn(16, 3).astype(np.float32)
    _, vjp = jax.vjp(lambda v: jact.gradient_scaling(v, jnp.asarray(a), progress), jnp.asarray(x))
    (gj,) = vjp(jnp.asarray(gy))
    xt = T(x).requires_grad_(True)
    y = tact.gradient_scaling(xt, T(a), torch.tensor(progress))
    np.testing.assert_array_equal(y.detach().numpy(), x)
    y.backward(T(gy))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gj), rtol=1e-6)


def test_weight_var_forward_backward():
    rid, _, n = ragged(7)
    w = np.random.RandomState(8).uniform(0, 1, rid.shape[0]).astype(np.float32)
    w[rid == n] = 0.0
    li = np.asarray(jseg.local_index(jnp.asarray(rid), n))

    def jf(v):
        return jact.weight_var(v, jnp.asarray(rid), jnp.asarray(li), n)

    gj = jax.grad(lambda v: jnp.sum(jnp.sqrt(jf(v) + 1e-2)))(jnp.asarray(w))
    wt = T(w).requires_grad_(True)
    var = tact.weight_var(wt, T(rid), T(li), n)
    np.testing.assert_allclose(var.detach().numpy(), np.asarray(jf(jnp.asarray(w))),
                               rtol=1e-5, atol=1e-7)
    torch.sqrt(var + 1e-2).sum().backward()
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gj), rtol=1e-4, atol=1e-6)


# ------------------------------------------------------------- MLP + SH

@pytest.mark.parametrize("dims", [(32, 16, 64, 1), (32, 3, 64, 2)])
def test_mlp_forward_backward_bf16(dims):
    d_in, d_out, d_hid, n_hid = dims
    ws = [np.asarray(w) for w in jmlp.init_mlp(jax.random.PRNGKey(0), d_in, d_out, d_hid, n_hid)]
    x = np.random.RandomState(9).randn(256, d_in).astype(np.float32)
    gy = np.random.RandomState(10).randn(256, d_out).astype(np.float32)

    def jloss(wl, xx):
        return jnp.sum(jmlp.mlp_apply(wl, xx) * gy)

    yj = np.asarray(jmlp.mlp_apply([jnp.asarray(w) for w in ws], jnp.asarray(x)))
    gwj, gxj = jax.grad(jloss, argnums=(0, 1))([jnp.asarray(w) for w in ws], jnp.asarray(x))
    wt = [T(w).requires_grad_(True) for w in ws]
    xt = T(x).requires_grad_(True)
    yt = tmlp.mlp_apply(wt, xt)
    assert yt.dtype == torch.float32
    np.testing.assert_allclose(yt.detach().numpy(), yj, rtol=1e-4, atol=1e-4)
    (yt * T(gy)).sum().backward()
    for a, b in zip(wt, gwj):
        b = np.asarray(b)
        assert np.abs(a.grad.numpy() - b).max() <= 1e-3 * np.abs(b).max()
    assert np.abs(xt.grad.numpy() - np.asarray(gxj)).max() <= 1e-3 * np.abs(np.asarray(gxj)).max()


def test_init_mlp_shapes_and_range():
    g = torch.Generator().manual_seed(0)
    ws = tmlp.init_mlp(g, 32, 16, 64, 1)
    assert [tuple(w.shape) for w in ws] == [(32, 64), (64, 64), (64, 16)]
    assert float(ws[0].abs().max()) <= (6.0 / 32) ** 0.5


@pytest.mark.parametrize("degree", [1, 2, 3, 4, 5, 8])
def test_sh_encode_matches_jax(degree):
    v = np.random.RandomState(11).randn(512, 3)
    v = (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)
    np.testing.assert_allclose(tsh.sh_encode(T(v), degree).numpy(),
                               np.asarray(jsh.sh_encode(jnp.asarray(v), degree)),
                               rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------- camera

def test_pixel_to_ray_with_distortion_matches_jax():
    rng = np.random.RandomState(12)
    n = 64
    pose = np.tile(np.eye(4, dtype=np.float32)[:3], (n, 1, 1))
    ang = rng.uniform(-0.5, 0.5, n)
    pose[:, 0, 0], pose[:, 0, 2] = np.cos(ang), np.sin(ang)
    pose[:, 2, 0], pose[:, 2, 2] = -np.sin(ang), np.cos(ang)
    pose[:, :, 3] = rng.randn(n, 3)
    intri = np.tile(np.array([[300.0, 0, 160], [0, 310, 120], [0, 0, 1]], np.float32), (n, 1, 1))
    dist = np.tile(np.array([0.05, -0.01, 0.001, -0.002], np.float32), (n, 1))
    i = rng.uniform(0, 240, n).astype(np.float32)
    j = rng.uniform(0, 320, n).astype(np.float32)
    oj, dj = jcam.pixel_to_ray(*map(jnp.asarray, (pose, intri, dist, i, j)))
    ot, dt = tcam.pixel_to_ray(*map(T, (pose, intri, dist, i, j)))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-6)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5, atol=1e-6)
    # the undistortion is a true inverse of the distortion
    u = T(rng.uniform(-0.6, 0.6, n).astype(np.float32))
    v = T(rng.uniform(-0.6, 0.6, n).astype(np.float32))
    x, y = tcam.undistort(T(dist), u, v)
    du, dv = tcam.apply_distortion(T(dist), x, y)
    np.testing.assert_allclose((x + du).numpy(), u.numpy(), atol=1e-5)
    np.testing.assert_allclose((y + dv).numpy(), v.numpy(), atol=1e-5)


def test_normalize_scene_and_invert_pose_match_jax():
    rng = np.random.RandomState(13)
    poses = np.tile(np.eye(4, dtype=np.float32)[:3], (10, 1, 1))
    poses[:, :, 3] = rng.randn(10, 3) * 3 + 5
    bounds = np.tile([[0.5, 10.0]], (10, 1)).astype(np.float32)
    for a, b in zip(tcam.normalize_scene(poses, bounds), jcam.normalize_scene(poses, bounds)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(tcam.invert_pose(poses), jcam.invert_pose(poses))


# ------------------------------------------------------------- host copies

@pytest.mark.parametrize("name,overrides", [
    ("wanjinyou", ["mode=test", "dataset.factor=4", "+train.fused_adam=true"]),
    ("wanjinyou", list(jsyn.TINY_OVERRIDES)),
    ("llff", []),
    ("nerf-360", []),
])
def test_config_compose_matches_jax(name, overrides):
    assert tconfig.compose(CONFS, name, overrides) == jconfig.compose(CONFS, name, overrides)


def test_config_sci_float_rule():
    cfg = tconfig.compose(CONFS, "wanjinyou", ["+train.x=1e-3", "+train.y=3"])
    assert cfg["train"]["x"] == pytest.approx(1e-3) and isinstance(cfg["train"]["x"], float)
    assert cfg["train"]["y"] == 3 and isinstance(cfg["train"]["y"], int)
    with pytest.raises(KeyError):
        tconfig.apply_override(cfg, "train.not_a_key=1")


def test_schedules_match_jax():
    cfg = jconfig.compose(CONFS, "wanjinyou", [])["train"]
    cfg = dict(cfg, gradient_scaling_start=1000, gradient_scaling_end=5000)
    for s in list(range(0, 25000, 97)) + [999, 1000, 1001, 5000, 10000, 20000]:
        assert tsched.learning_rate(s, cfg) == jsched.learning_rate(s, cfg)
        assert tsched.ray_march_fineness(s, cfg) == jsched.ray_march_fineness(s, cfg)
        assert tsched.gradient_scaling_progress(s, cfg) == jsched.gradient_scaling_progress(s, cfg)
        assert tsched.var_loss_weight(s, cfg) == jsched.var_loss_weight(s, cfg)


def test_synthetic_scene_matches_jax(tmp_path):
    assert tsyn.TINY_OVERRIDES == jsyn.TINY_OVERRIDES
    a = tsyn.write_ball_dataset(str(tmp_path / "a"), n_cams=4, h=12, w=16)
    b = jsyn.write_ball_dataset(str(tmp_path / "b"), n_cams=4, h=12, w=16)
    np.testing.assert_array_equal(np.load(os.path.join(a, "cams_meta.npy")),
                                  np.load(os.path.join(b, "cams_meta.npy")))
    for k in range(4):
        with open(os.path.join(a, "images", f"{k:04d}.png"), "rb") as fa, \
                open(os.path.join(b, "images", f"{k:04d}.png"), "rb") as fb:
            assert fa.read() == fb.read()


def test_package_imports_no_jax():
    """The port never imports jax, optax or the JAX package (run in a
    fresh interpreter: this test process has jax loaded already)."""
    import subprocess
    import sys
    code = ("import sys, f2nerf_torch, f2nerf_torch.train.trainer, "
            "f2nerf_torch.utils.convert, f2nerf_torch.native, "
            "f2nerf_torch.sampler.octree, f2nerf_torch.run; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'optax', 'f2nerf_tpu')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
