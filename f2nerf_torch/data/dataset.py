"""Dataset ingestion and train-ray sampling (port of
``f2nerf_tpu/data/dataset.py``).

Loads the reference formats (Dataset.cpp:16-125): cams_meta.npy ([n, 27]
f64 rows: 12 c2w pose + 9 intrinsics + 4 distortion + 2 bounds),
image_list.txt, optional split.npy and poses_render.npy. The host side is a
numpy copy of the JAX package's ``Dataset``; images stay uint8 on the
device and are converted to [0, 1] floats at gather time (or, with
``data_at_gpu=false``, gathered on the host: ``host_batch_rays``).
Train-ray draws: every ray its own camera (``draw_rays``) or one camera a
batch (``draw_rays_single_image``, ray_sample_mode=single_image).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import kernels
from ..core import camera
from ..ops import rays
from ..parallel.data_parallel import shard_rows


class Dataset:
    def __init__(self, data_path: str, cfg: dict, load_images: bool = True):
        self.data_path = data_path
        factor = float(cfg.get("factor", 1.0))
        self.factor = factor
        bounds_factor = cfg.get("bounds_factor", [1.0, 1.0])

        cams = np.load(os.path.join(data_path, "cams_meta.npy"))
        if cams.ndim != 2 or cams.shape[1] != 27:
            raise ValueError(f"cams_meta.npy must be [n, 27], got {cams.shape}")
        cams = cams.astype(np.float32)
        self.n_images = cams.shape[0]
        poses = cams[:, :12].reshape(-1, 3, 4).copy()
        intri = cams[:, 12:21].reshape(-1, 3, 3).copy()
        intri[:, :2, :] /= factor
        dist = cams[:, 21:25].copy()
        bounds = cams[:, 25:27].copy()

        poses, bounds, self.center, self.radius = camera.normalize_scene(poses, bounds)
        self.poses = poses
        self.w2c = camera.invert_pose(poses)
        self.intri = intri
        self.dist = dist

        render_path = os.path.join(data_path, "poses_render.npy")
        if os.path.exists(render_path):
            rp = np.load(render_path).astype(np.float32).reshape(-1, 3, 4).copy()
            rp[:, :3, 3] = (rp[:, :3, 3] - self.center) / self.radius
            self.render_poses = rp
        else:
            self.render_poses = None

        bounds = np.stack([bounds[:, 0] * bounds_factor[0],
                           bounds[:, 1] * bounds_factor[1]], axis=-1)
        self.bounds = np.clip(bounds, 1e-2, 1e9).astype(np.float32)
        self.near = float(self.bounds.min())

        split_path = os.path.join(data_path, "split.npy")
        if os.path.exists(split_path):
            sp = np.load(split_path).astype(np.uint8)
            if sp.shape[0] != self.n_images:
                raise ValueError("split.npy length != number of images")
            self.train_set = np.nonzero(sp & 1)[0].astype(np.int32)
            self.test_set = np.nonzero(sp & 2)[0].astype(np.int32)
            self.val_set = np.nonzero(sp & 4)[0].astype(np.int32)
        else:
            idx = np.arange(self.n_images)
            self.test_set = idx[idx % 8 == 0].astype(np.int32)
            self.train_set = idx[idx % 8 != 0].astype(np.int32)
            self.val_set = np.zeros((0,), np.int32)

        self.images = None
        self.height = self.width = 0
        if load_images:
            self._load_images()

    def _load_images(self):
        from PIL import Image
        list_path = os.path.join(self.data_path, "image_list.txt")
        if os.path.exists(list_path):
            with open(list_path) as f:
                paths = [line.strip() for line in f if line.strip()]
        else:  # read-only dataset dir: glob directly
            paths = glob_images(self.data_path, self.factor)
        if len(paths) < self.n_images:
            raise ValueError(f"{len(paths)} images for {self.n_images} cameras")
        imgs = []
        for p in paths[: self.n_images]:
            with Image.open(p) as im:
                imgs.append(np.asarray(im.convert("RGB"), np.uint8))
        self.images = np.stack(imgs, axis=0)
        self.height, self.width = self.images.shape[1:3]

    def device_arrays(self, device="cpu", n_shards: int = 1, shard: int = 0) -> dict:
        """Camera metadata (every camera) and one shard's rows of the
        train-image pool, [rows, H, W, 3] uint8, with their ids, on
        ``device``: the train ids padded with the leading ones to a
        multiple of ``n_shards``, block ``shard`` of them
        (``parallel.data_parallel.shard_rows``, the JAX package's
        ``device_arrays(n_shards)`` then ``shard_data``); all of them with
        one shard."""
        ids = self.train_set[shard_rows(len(self.train_set), n_shards, shard)]
        out = dict(
            poses=torch.as_tensor(self.poses, device=device),
            intri=torch.as_tensor(self.intri, device=device),
            dist=torch.as_tensor(self.dist, device=device),
            bounds=torch.as_tensor(self.bounds, device=device),
            train_ids=torch.as_tensor(ids.astype(np.int32), device=device),
        )
        if self.images is not None:
            out["train_images"] = torch.as_tensor(
                np.ascontiguousarray(self.images[ids]), device=device)
            check_tables(out)
        return out

    @property
    def train_arrays(self):
        """Train-camera subsets for octree construction (c2w, w2c, intri,
        bounds)."""
        t = self.train_set
        return self.poses[t], self.w2c[t], self.intri[t], self.bounds[t]


# the tables ``sample_rays`` reads, in K15's argument order
TABLES = ("train_ids", "train_images", "poses", "intri", "dist", "bounds")


def check_tables(data: dict) -> None:
    """The layout ``sample_rays`` (and K15) reads: train_ids [R] i32,
    train_images [R, H, W, 3] u8, poses/intri/dist/bounds [N, 3, 4] /
    [N, 3, 3] / [N, 4] / [N, 2] f32. Raises ValueError otherwise."""
    tabs = [data[k] for k in TABLES]
    ids, images, poses, intri, dist, bounds = tabs
    N = poses.shape[0]
    if ids.dtype != torch.int32 or images.dtype != torch.uint8 \
            or any(x.dtype != torch.float32 for x in tabs[2:]) \
            or ids.dim() != 1 or images.dim() != 4 or images.shape[0] != ids.shape[0] \
            or images.shape[3] != 3 or tuple(poses.shape) != (N, 3, 4) \
            or tuple(intri.shape) != (N, 3, 3) or tuple(dist.shape) != (N, 4) \
            or tuple(bounds.shape) != (N, 2):
        raise ValueError(f"sample_rays' tables: train_ids [R] i32, train_images [R, H, W, 3] "
                         f"u8, poses/intri/dist/bounds [N, ...] f32; got "
                         f"{[(tuple(x.shape), str(x.dtype)) for x in tabs]}")


def draw_rays(data: dict, generator: torch.Generator, n_rays: int,
              height: int, width: int) -> dict:
    """Random (train camera, pixel) picks for ``sample_rays``, among the
    cameras of ``data`` (under data parallel, the rank's own rows)."""
    dev = generator.device
    n_train = data["train_ids"].shape[0]
    kw = dict(generator=generator, device=dev)
    return dict(cam_pick=torch.randint(0, n_train, (n_rays,), **kw),
                i=torch.randint(0, height, (n_rays,), **kw),
                j=torch.randint(0, width, (n_rays,), **kw))


def draw_rays_single_image(data: dict, generator: torch.Generator,
                           n_rays: int, height: int, width: int) -> dict:
    """ray_sample_mode=single_image (RandRaysDataOfCamera,
    Dataset.cpp:251-267): one train-camera pick broadcast to every ray,
    then the pixels; the same keys as ``draw_rays``. Under data parallel
    each rank picks among its own rows, so a batch mixes one camera per
    shard (JAX trainer.py:324-326)."""
    dev = generator.device
    n_train = data["train_ids"].shape[0]
    kw = dict(generator=generator, device=dev)
    pick = torch.randint(0, n_train, (1,), **kw)
    return dict(cam_pick=pick.expand(n_rays).contiguous(),
                i=torch.randint(0, height, (n_rays,), **kw),
                j=torch.randint(0, width, (n_rays,), **kw))


def host_batch_rays(data: dict, batch: dict):
    """Train rays for a host batch (data_at_gpu=false; JAX
    trainer.py:336-344): img_idx [n] image ids, i, j [n] pixel row/col
    (f32, integral), gt [n, 3]. Returns (rays_o, rays_d, gt, img_idx)."""
    img_idx = batch["img_idx"].long()
    rays_o, rays_d = camera.pixel_to_ray(
        data["poses"][img_idx], data["intri"][img_idx], data["dist"][img_idx],
        batch["i"] + 0.5, batch["j"] + 0.5)
    return rays_o, rays_d, batch["gt"], batch["img_idx"]


def sample_rays_plain(data: dict, cam_pick: torch.Tensor, i: torch.Tensor,
                      j: torch.Tensor):
    """Plain PyTorch version of K15's ``sample_rays``: the row gathers,
    gt's cast and divide, then ``camera.pixel_to_ray_plain``."""
    cam_pick = cam_pick.long()
    il, jl = i.long(), j.long()
    img_idx = data["train_ids"][cam_pick].long()
    gt = data["train_images"][cam_pick, il, jl].to(torch.float32) / 255.0
    fi = il.to(torch.float32) + 0.5
    fj = jl.to(torch.float32) + 0.5
    rays_o, rays_d = camera.pixel_to_ray_plain(
        data["poses"][img_idx], data["intri"][img_idx], data["dist"][img_idx],
        fi, fj)
    bounds = data["bounds"][img_idx]
    return rays_o, rays_d, bounds, gt, img_idx.to(torch.int32)


def sample_rays(data: dict, cam_pick: torch.Tensor, i: torch.Tensor,
                j: torch.Tensor):
    """Train rays for explicit draws (RandRaysData, Dataset.cpp:275-298):
    cam_pick [n] indexes the train cameras (``train_ids`` and the rows of
    ``train_images``), (i, j) [n] the integer pixel row/col, all three
    int64 (as ``draw_rays`` gives them) or all int32. Returns (rays_o,
    rays_d [n, 3], bounds [n, 2], gt [n, 3] in [0, 1], img_idx [n] i32).
    ``data`` holds the tables as ``device_arrays`` lays them out
    (``check_tables``, run there once). CPU tensors take
    ``sample_rays_plain``; CUDA tensors launch K15 (``ops/rays.py``,
    csrc/rays.cu, a thread a ray), bit for bit the plain version."""
    n = cam_pick.shape[0] if cam_pick.dim() == 1 else -1
    if n < 0 or tuple(i.shape) != (n,) or tuple(j.shape) != (n,) \
            or cam_pick.dtype not in (torch.int32, torch.int64) \
            or i.dtype != cam_pick.dtype or j.dtype != cam_pick.dtype:
        raise ValueError(f"sample_rays: cam_pick, i, j must be [n] and all int32 or all "
                         f"int64, got {tuple(cam_pick.shape)} {cam_pick.dtype}, "
                         f"{tuple(i.shape)} {i.dtype}, {tuple(j.shape)} {j.dtype}")
    if cam_pick.device.type == "cpu":
        return sample_rays_plain(data, cam_pick, i, j)
    if cam_pick.device.type != "cuda":
        raise ValueError(f"sample_rays: unsupported device {cam_pick.device}")
    draws = [x.contiguous() for x in (cam_pick, i, j)]
    tabs = [data[k] for k in TABLES]
    kernels.require_cuda("sample_rays", *draws, *tabs)
    ids, images, poses, intri, dist, bounds = tabs
    return rays.rays_kernel(draws[1], draws[2], poses, intri, dist, pick=draws[0],
                            train_ids=ids, images=images, bounds=bounds)


def _pixel_grid(height: int, width: int, reso_level: int, device):
    """Row/col pixel centres [h*w] of the full-image grid: the f32 values
    of the JAX package's ``jnp.linspace(0, H-1, h) + 0.5``. XLA compiles
    that linspace to ``k * (stop * (1/(num-1)))`` with the factor rounded
    to f32 once (then ``stop`` itself last), which is not what a plain f32
    ``k/(num-1)*stop`` gives; the rays must match bit for bit."""
    def linspace(stop: float, num: int) -> np.ndarray:
        if num == 1:
            return np.zeros((1,), np.float32)
        step = np.float32(stop) * (np.float32(1.0) / np.float32(num - 1))
        out = np.arange(num - 1, dtype=np.float32) * step
        return np.concatenate([out, np.array([stop], np.float32)])
    h, w = height // reso_level, width // reso_level
    i = linspace(height - 1.0, h) + np.float32(0.5)
    j = linspace(width - 1.0, w) + np.float32(0.5)
    ii, jj = np.meshgrid(i, j, indexing="ij")
    return (torch.from_numpy(ii.reshape(-1)).to(device),
            torch.from_numpy(jj.reshape(-1)).to(device))


def camera_rays(data: dict, cam_idx: int, height: int, width: int,
                reso_level: int = 1):
    """Full-image ray grid of camera ``cam_idx`` (RaysOfCamera,
    Dataset.cpp:177-196): (rays_o, rays_d) [h*w, 3] on the data's device."""
    dev = data["poses"].device
    ii, jj = _pixel_grid(height, width, reso_level, dev)
    return camera.pixel_to_ray(data["poses"][cam_idx], data["intri"][cam_idx],
                               data["dist"][cam_idx], ii, jj)


def pose_rays(data: dict, pose, height: int, width: int, reso_level: int = 1):
    """Rays from an arbitrary c2w pose [3, 4] with camera-0 intrinsics
    (RaysFromPose, Dataset.cpp:198-218)."""
    dev = data["poses"].device
    ii, jj = _pixel_grid(height, width, reso_level, dev)
    pose = torch.as_tensor(pose, dtype=torch.float32, device=dev)
    return camera.pixel_to_ray(pose, data["intri"][0], data["dist"][0], ii, jj)


def rays_interpolate(data: dict, idx_0: int, idx_1: int, alpha: float,
                     height: int, width: int, reso_level: int = 1):
    """Full-image rays from a pose slerped between two cameras
    (RaysInterpolate, Dataset.cpp:237-243)."""
    poses = data["poses"].cpu().numpy()
    pose = camera.pose_interpolate(poses[idx_0], poses[idx_1], alpha)
    return pose_rays(data, pose, height, width, reso_level)


def whole_space_pose(poses: np.ndarray, rng: np.random.RandomState,
                     window_size: int = 10) -> np.ndarray:
    """A c2w pose blended between three nearby cameras (RandRaysWholeSpace,
    Dataset.cpp:245-255): a base in [0, n - window), three cameras in its
    window, slerped with random weights."""
    n_images = poses.shape[0]
    base = rng.randint(0, max(n_images - window_size, 1))
    a, b, c = (base + rng.randint(0, window_size, 3)) % n_images
    wa, wb, wc = rng.rand(3) + 1e-7
    pose = camera.pose_interpolate(poses[a], poses[b], wb / (wb + wa))
    return camera.pose_interpolate(pose, poses[c], wc / (wa + wb + wc))


def rand_rays_whole_space(data: dict, generator: torch.Generator, n_rays: int,
                          height: int, width: int, window_size: int = 10):
    """Random rays from a pose blended between three nearby train cameras
    (RandRaysWholeSpace, Dataset.cpp:245-255): the pose from a host
    RandomState seeded by one draw of ``generator``, then random pixels
    with camera-0 intrinsics. Returns (rays_o, rays_d) [n, 3]."""
    dev = data["poses"].device
    kw = dict(generator=generator, device=generator.device)
    seed = int(torch.randint(0, 1 << 31, (1,), **kw))
    pose = whole_space_pose(data["poses"].cpu().numpy(),
                            np.random.RandomState(seed), window_size)
    i = torch.randint(0, height, (n_rays,), **kw).to(dev, torch.float32) + 0.5
    j = torch.randint(0, width, (n_rays,), **kw).to(dev, torch.float32) + 0.5
    return camera.pixel_to_ray(torch.as_tensor(pose, device=dev),
                               data["intri"][0], data["dist"][0], i, j)


def glob_images(data_path: str, factor: float) -> list[str]:
    """Image paths under images_{factor}/ (scripts/run.py:18-34 semantics)."""
    import glob
    suffixes = ["*.jpg", "*.png", "*.JPG", "*.jpeg"]
    image_list = []
    if 0.999 < factor < 1.001:
        for suf in suffixes:
            image_list += glob.glob(os.path.join(data_path, "images", suf))
            image_list += glob.glob(os.path.join(data_path, "images_1", suf))
    else:
        f_int = int(round(factor))
        for suf in suffixes:
            image_list += glob.glob(os.path.join(data_path, f"images_{f_int}", suf))
    if not image_list:
        raise FileNotFoundError(f"No image found under {data_path}")
    image_list.sort()
    return image_list


def make_image_list(data_path: str, factor: float) -> str | None:
    """Create image_list.txt (scripts/run.py:18-34); returns None when the
    dataset dir is read-only (loader then falls back to glob_images)."""
    image_list = glob_images(data_path, factor)
    out = os.path.join(data_path, "image_list.txt")
    try:
        with open(out, "w") as f:
            f.write("\n".join(image_list) + "\n")
    except OSError:
        return None
    return out
