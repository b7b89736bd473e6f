"""Kernel K15 of the port, the rays (``sample_rays`` and ``pixel_to_ray``
on CUDA tensors, csrc/rays.cu): the plain versions against the JAX
package in both forms (a camera a ray, one camera for every ray), the
routes and refusals on the CPU, and on the card (``cuda`` marker, skipped
without one) each form against its plain version on the card.

Inputs come from numpy seeds: six cameras with distinct poses, intrinsics
and non-zero (k1, k2, p1, p2), five train rows, images whose first 256
bytes are 0-255 (every value of gt), draws that include the image's edge
rows and columns. Special cameras: one whose Newton step meets a zero
Jacobian determinant (k1 = -1 at (u, v) = (1, 0): the 1e-12 clamp
engages on every step), one with a NaN and one with an inf coefficient.

Tolerances: against JAX, rays_o, bounds, img_idx and gt equal; rays_d to
RTOL/ATOL (JAX forms R @ d with einsum, the port term by term, and XLA
may fuse the Newton steps' ops). On the card: none. K15 rounds every
operation as the plain version's torch ops do there, so every output is
held bit for bit, floats as their int32 views (NaN bits included), a
repeated launch too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f2nerf_tpu.core import camera as jcam
from f2nerf_torch.core import camera as tcam
from f2nerf_torch.data import dataset as tds
from f2nerf_torch.ops import rays as trays

H, W = 20, 90
IDS = np.array([0, 2, 3, 4, 5], np.int32)
# the clamp camera's pixel: (j + 0.5 - cx) / fx = 1, (i + 0.5 - cy) / fy = 0
CLAMP_CAM, CLAMP_ROW, CLAMP_I, CLAMP_J = 3, 2, 3, 40
RTOL, ATOL = 1e-5, 1e-6


def rig(seed: int = 0, special: bool = False, height: int = H, width: int = W) -> dict:
    """Camera tables for 6 cameras and images of the 5 train rows, as
    ``Dataset.device_arrays`` lays them out, on the CPU. ``special``:
    camera 3 the clamp camera, camera 4 k1 NaN, camera 5 p2 inf."""
    rng = np.random.RandomState(seed)
    n = 6
    rot = np.linalg.qr(rng.randn(n, 3, 3))[0].astype(np.float32)
    poses = np.concatenate([rot, rng.randn(n, 3, 1).astype(np.float32)], axis=2)
    intri = np.zeros((n, 3, 3), np.float32)
    intri[:, 0, 0] = rng.uniform(30, 60, n)
    intri[:, 1, 1] = rng.uniform(30, 60, n)
    intri[:, 0, 2] = rng.uniform(0.4, 0.6, n) * width
    intri[:, 1, 2] = rng.uniform(0.4, 0.6, n) * height
    intri[:, 2, 2] = 1.0
    dist = (np.array([0.05, -0.01, 0.001, -0.002], np.float32)
            * rng.uniform(0.5, 2.0, (n, 4))).astype(np.float32)
    bounds = np.stack([rng.uniform(0.01, 0.5, n), rng.uniform(2, 9, n)], -1).astype(np.float32)
    if special:
        intri[CLAMP_CAM, 0, 0], intri[CLAMP_CAM, 0, 2] = CLAMP_J, 0.5
        intri[CLAMP_CAM, 1, 2] = CLAMP_I + 0.5
        dist[CLAMP_CAM] = [-1.0, 0.0, 0.0, 0.0]
        dist[4, 0] = np.nan
        dist[5, 3] = np.inf
    images = rng.randint(0, 256, (len(IDS), height, width, 3)).astype(np.uint8)
    flat = images[0].reshape(-1)
    flat[:256] = np.arange(min(256, flat.size), dtype=np.uint8)
    arrays = dict(poses=poses, intri=intri, dist=dist, bounds=bounds, train_ids=IDS,
                  train_images=images)
    return {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}


def draws(n: int, seed: int, dtype=torch.int64, height: int = H, width: int = W) -> tuple:
    """(cam_pick, i, j) [n]: uniform picks and pixels, the first rays on
    the image's four edges and corners, the clamp camera's pixel once."""
    rng = np.random.RandomState(seed)
    pick = rng.randint(0, len(IDS), n)
    i = rng.randint(0, height, n)
    j = rng.randint(0, width, n)
    edge_i = [0, height - 1, 0, height - 1, 0, height - 1, 7, 7]
    edge_j = [0, 0, width - 1, width - 1, 5, 5, 0, width - 1]
    k = min(n, len(edge_i))
    i[:k], j[:k] = edge_i[:k], edge_j[:k]
    if n > 8:
        pick[8], i[8], j[8] = CLAMP_ROW, CLAMP_I, CLAMP_J
    if n > 300:  # the first 256 bytes of image row 0: every value of gt
        pick[10:100] = 0
        i[10:100] = 0
        j[10:100] = np.arange(90) % width
    return tuple(torch.from_numpy(x.astype(np.int64)).to(dtype) for x in (pick, i, j))


def jax_sample(data: dict, pick, i, j) -> tuple:
    """The JAX package's sample_rays (dataset.py:154-171) from explicit
    draws: its gathers and gt, then ``camera.pixel_to_ray``."""
    d = {k: jnp.asarray(v.numpy()) for k, v in data.items()}
    pick, i, j = (jnp.asarray(x.numpy().astype(np.int32)) for x in (pick, i, j))
    img = d["train_ids"][pick]
    gt = d["train_images"][pick, i, j].astype(jnp.float32) / 255.0
    fi = i.astype(jnp.float32) + 0.5
    fj = j.astype(jnp.float32) + 0.5
    ro, rd = jcam.pixel_to_ray(d["poses"][img], d["intri"][img], d["dist"][img], fi, fj)
    return ro, rd, d["bounds"][img], gt, img


def assert_jax(got, want) -> None:
    ro, rd, bounds, gt, img = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(got[0].numpy(), ro)
    np.testing.assert_allclose(got[1].numpy(), rd, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got[2].numpy(), bounds)
    np.testing.assert_array_equal(got[3].numpy(), gt)
    np.testing.assert_array_equal(got[4].numpy(), img)
    assert got[4].dtype == torch.int32


# ------------------------------------------------------------------- CPU

@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("n", [0, 1, 513])
def test_sample_rays_plain_matches_jax(n, dtype):
    data = rig(1)
    d = draws(n, n + 5, dtype)
    got = tds.sample_rays_plain(data, *d)
    assert [tuple(x.shape) for x in got] == [(n, 3), (n, 3), (n, 2), (n, 3), (n,)]
    assert_jax(got, jax_sample(data, *d))
    # the routed call on CPU tensors is the plain version
    routed = tds.sample_rays(data, *d)
    for a, b in zip(routed, got):
        assert torch.equal(a, b)


def test_sample_rays_edges_and_clamp_match_jax():
    """The image's edge pixels and the clamp camera's pixel, whose first
    Newton step has a zero determinant (so every step substitutes 1e-12)."""
    data = rig(2, special=True)
    pick, i, j = draws(9, 3)
    pick[:8] = torch.tensor([0, 1, 2, 0, 1, 2, 0, 1])  # not the NaN/inf rows
    d = (pick, i, j)
    got = tds.sample_rays_plain(data, *d)
    assert_jax(got, jax_sample(data, *d))
    # the clamp camera's Newton step: (x, y) = (1, 0), k1 = -1 give a zero det
    k1 = float(data["dist"][CLAMP_CAM, 0])
    u = (CLAMP_J + 0.5 - float(data["intri"][CLAMP_CAM, 0, 2])) / float(data["intri"][CLAMP_CAM, 0, 0])
    v = (CLAMP_I + 0.5 - float(data["intri"][CLAMP_CAM, 1, 2])) / float(data["intri"][CLAMP_CAM, 1, 1])
    assert (u, v) == (1.0, 0.0)
    radial = k1 * (u * u + v * v)
    det = (1 + radial + 2 * u * u * k1) * (1 + radial + 2 * v * v * k1) - (2 * u * v * k1) ** 2
    assert abs(det) < 1e-12
    # undistort leaves (1, 0) in place: the ray is R (1, -0, -1)
    rot = data["poses"][IDS[CLAMP_ROW], :, :3]
    np.testing.assert_array_equal(got[1][8].numpy(), (rot[:, 0] - rot[:, 1] * 0.0 - rot[:, 2]).numpy())


@pytest.mark.parametrize("n", [0, 1, 513])
def test_pixel_to_ray_plain_both_forms_match_jax(n):
    data = rig(4)
    rng = np.random.RandomState(n)
    fi = torch.from_numpy(rng.uniform(0, H, n).astype(np.float32))
    fj = torch.from_numpy(rng.uniform(0, W, n).astype(np.float32))
    cam = torch.from_numpy(rng.randint(0, 6, n))
    tabs = ("poses", "intri", "dist")
    forms = {"per_ray": [data[k][cam] for k in tabs], "one": [data[k][2] for k in tabs]}
    for form, (pose, intri, dist) in forms.items():
        want = jcam.pixel_to_ray(*(jnp.asarray(x.numpy()) for x in (pose, intri, dist, fi, fj)))
        for fn in (tcam.pixel_to_ray_plain, tcam.pixel_to_ray):
            ro, rd = fn(pose, intri, dist, fi, fj)
            assert tuple(ro.shape) == tuple(rd.shape) == (n, 3), form
            np.testing.assert_array_equal(ro.numpy(), np.asarray(want[0]), err_msg=form)
            np.testing.assert_allclose(rd.numpy(), np.asarray(want[1]), rtol=RTOL, atol=ATOL,
                                       err_msg=form)


def test_routes_refuse():
    """CPU tensors take the plain versions (no launch); a meta tensor, a
    mixed or float pick, and shapes outside the two forms are refused;
    ``check_tables`` refuses a table of another dtype."""
    data = rig(5)
    d = draws(16, 6)
    before = trays.rays_kernel.launches
    tds.sample_rays(data, *d)
    tcam.pixel_to_ray(data["poses"][0], data["intri"][0], data["dist"][0],
                      d[1].float() + 0.5, d[2].float() + 0.5)
    assert trays.rays_kernel.launches == before
    meta = [x.to("meta") for x in d]
    with pytest.raises(ValueError, match="unsupported device meta"):
        tds.sample_rays(data, *meta)
    with pytest.raises(ValueError, match="unsupported device meta"):
        tcam.pixel_to_ray(*(data[k][0].to("meta") for k in ("poses", "intri", "dist")),
                          meta[1].float(), meta[2].float())
    with pytest.raises(ValueError, match="all int32 or all int64"):
        tds.sample_rays(data, d[0].int(), d[1], d[2])
    with pytest.raises(ValueError, match="all int32 or all int64"):
        tds.sample_rays(data, d[0].float(), d[1].float(), d[2].float())
    tds.check_tables(data)
    bad = dict(data, train_ids=data["train_ids"].long())
    with pytest.raises(ValueError, match="train_ids"):
        tds.check_tables(bad)
    fi = d[1].float()
    with pytest.raises(ValueError, match="shapes"):  # per-ray pose with one camera's intri
        tcam.pixel_to_ray(data["poses"][d[0]], data["intri"][0], data["dist"][0], fi, fi)
    with pytest.raises(ValueError, match="float32"):
        tcam.pixel_to_ray(data["poses"][0], data["intri"][0], data["dist"][0], fi.double(), fi)


# ------------------------------------------------------------------ card

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def assert_bits(got, want) -> None:
    assert len(got) == len(want)
    for k, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if a.dtype == torch.float32:
            a, b = a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)
        assert torch.equal(a, b), (k, (a != b).nonzero()[:8].tolist())


def on(data: dict, dev) -> dict:
    return {k: v.to(dev) for k, v in data.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("special", [False, True])
@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("n", [0, 1, 512, 513, 4099])
def test_sample_rays_on_card(cuda, n, dtype, special):
    """K15's sample_rays against the plain route on the card, with
    distorted cameras, edge pixels, every gt value, the clamp camera and
    (special) NaN and inf coefficients, some picks and pixels negative
    (torch's gathers count them from the end); launched twice."""
    data = on(rig(7, special), cuda)
    pick, i, j = draws(n, 11 + n, dtype)
    if n > 200:
        pick[150:160] = torch.arange(-5, 5, dtype=dtype)
        i[160:165], j[165:170] = -1, -W
    d = [x.to(cuda) for x in (pick, i, j)]
    before = trays.rays_kernel.launches
    got = tds.sample_rays(data, *d)
    again = tds.sample_rays(data, *d)
    want = tds.sample_rays_plain(data, *d)
    torch.cuda.synchronize()
    assert trays.rays_kernel.launches == before + 2 * (n > 0)
    assert_bits(got, want)
    assert_bits(again, want)
    if special and n > 8:
        nan = torch.isnan(want[1]).any(1)
        assert bool(nan.any()), "the NaN/inf cameras give NaN rays"


@pytest.mark.cuda
@pytest.mark.parametrize("special", [False, True])
def test_pixel_to_ray_per_ray_on_card(cuda, special):
    """The camera-a-ray form, as host_batch_rays calls it: gathered rows,
    float pixels."""
    data = on(rig(8, special), cuda)
    rng = np.random.RandomState(9)
    n = 3001
    img = torch.from_numpy(rng.randint(0, 6, n)).to(cuda)
    fi = torch.from_numpy(rng.randint(0, H, n).astype(np.float32) + 0.5).to(cuda)
    fj = torch.from_numpy(rng.randint(0, W, n).astype(np.float32) + 0.5).to(cuda)
    args = (data["poses"][img], data["intri"][img], data["dist"][img], fi, fj)
    got = tcam.pixel_to_ray(*args)
    again = tcam.pixel_to_ray(*args)
    want = tcam.pixel_to_ray_plain(*args)
    assert_bits(got, want)
    assert_bits(again, want)
    batch = dict(img_idx=img.int(), i=fi - 0.5, j=fj - 0.5,
                 gt=torch.zeros((n, 3), device=cuda))
    hb = tds.host_batch_rays(data, batch)
    assert_bits(hb[:2], want)


@pytest.mark.cuda
@pytest.mark.parametrize("cam", [0, 3, 4])
def test_camera_rays_full_image_on_card(cuda, cam):
    """The one-camera form over a whole 756x1008 grid, as camera_rays,
    pose_rays and rand_rays_whole_space call it; camera 3 clamps its
    determinant on its pixel, camera 4's k1 is NaN."""
    h, w = 756, 1008
    data = on(rig(10, special=True, height=8, width=8), cuda)
    ii, jj = tds._pixel_grid(h, w, 1, cuda)
    args = (data["poses"][cam], data["intri"][cam], data["dist"][cam], ii, jj)
    want = tcam.pixel_to_ray_plain(*args)
    got = tds.camera_rays(data, cam, h, w)
    assert_bits(got, want)
    assert_bits(tcam.pixel_to_ray(*args), want)
    pose = data["poses"][1].cpu().numpy()
    got = tds.pose_rays(data, pose, h, w, 2)
    ii, jj = tds._pixel_grid(h, w, 2, cuda)
    assert_bits(got, tcam.pixel_to_ray_plain(torch.as_tensor(pose, device=cuda),
                                             data["intri"][0], data["dist"][0], ii, jj))


@pytest.mark.cuda
def test_rand_rays_whole_space_on_card(cuda):
    data = on(rig(12), cuda)
    g = torch.Generator(device=cuda).manual_seed(5)
    got = tds.rand_rays_whole_space(data, g, 2048, H, W, window_size=3)
    g = torch.Generator(device=cuda).manual_seed(5)
    kw = dict(generator=g, device=cuda)
    seed = int(torch.randint(0, 1 << 31, (1,), **kw))
    pose = tds.whole_space_pose(data["poses"].cpu().numpy(), np.random.RandomState(seed), 3)
    i = torch.randint(0, H, (2048,), **kw).to(cuda, torch.float32) + 0.5
    j = torch.randint(0, W, (2048,), **kw).to(cuda, torch.float32) + 0.5
    want = tcam.pixel_to_ray_plain(torch.as_tensor(pose, device=cuda), data["intri"][0],
                                   data["dist"][0], i, j)
    assert_bits(got, want)
