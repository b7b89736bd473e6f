"""The scene's arrays as the reference reads them, worked out from the files
the benchmark wrote: a frozen copy of the port's ``data/dataset.py``
arithmetic (intrinsics over the factor, the scene normalised to the unit
ball, the bounds, the train split) and of its ray draws and ray grids.
Imports nothing of the port."""

from __future__ import annotations

import os

import numpy as np
import torch

from . import camera


def _cameras(data_path: str, cfg: dict):
    """(poses, w2c, intri, dist, bounds, train ids) of the scene at
    data_path, as the dataset loader works them out. ``cfg``: the
    configuration's ``dataset`` group."""
    cams = np.load(os.path.join(data_path, "cams_meta.npy")).astype(np.float32)
    factor = float(cfg.get("factor", 1.0))
    poses = cams[:, :12].reshape(-1, 3, 4).copy()
    intri = cams[:, 12:21].reshape(-1, 3, 3).copy()
    intri[:, :2, :] /= factor
    dist = cams[:, 21:25].copy()
    poses, bounds, _, _ = camera.normalize_scene(poses, cams[:, 25:27].copy())
    bf = cfg.get("bounds_factor", [1.0, 1.0])
    bounds = np.clip(np.stack([bounds[:, 0] * bf[0], bounds[:, 1] * bf[1]], -1),
                     1e-2, 1e9).astype(np.float32)
    idx = np.arange(cams.shape[0])
    train = idx[idx % 8 != 0].astype(np.int32)
    return poses, camera.invert_pose(poses), intri, dist, bounds, train


def scene_cams(data_path: str, cfg: dict) -> tuple:
    """The train cameras the octree is built over: (c2w, w2c, intri,
    bounds), numpy."""
    poses, w2c, intri, _, bounds, train = _cameras(data_path, cfg)
    return poses[train], w2c[train], intri[train], bounds[train]


def load_scene(data_path: str, images: np.ndarray, cfg: dict, device) -> dict:
    """The reference's data dict (poses, intri, dist, bounds, train_ids,
    train_images) for the scene at data_path, with the images [n, H, W, 3]
    uint8 the benchmark wrote there."""
    poses, _, intri, dist, bounds, train = _cameras(data_path, cfg)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=device)

    return dict(poses=t(poses), intri=t(intri), dist=t(dist), bounds=t(bounds),
                train_ids=t(train), train_images=t(images[train]))


def draw_rays(data: dict, generator: torch.Generator, n_rays: int,
              height: int, width: int) -> dict:
    """Random (train camera, pixel) picks."""
    dev = generator.device
    n_train = data["train_ids"].shape[0]
    kw = dict(generator=generator, device=dev)
    return dict(cam_pick=torch.randint(0, n_train, (n_rays,), **kw),
                i=torch.randint(0, height, (n_rays,), **kw),
                j=torch.randint(0, width, (n_rays,), **kw))


def sample_rays(data: dict, cam_pick, i, j):
    """Train rays for the picks: (rays_o, rays_d, gt, img_idx)."""
    cam_pick = cam_pick.long()
    il, jl = i.long(), j.long()
    img_idx = data["train_ids"][cam_pick].long()
    gt = data["train_images"][cam_pick, il, jl].to(torch.float32) / 255.0
    rays_o, rays_d = camera.pixel_to_ray(
        data["poses"][img_idx], data["intri"][img_idx], data["dist"][img_idx],
        il.to(torch.float32) + 0.5, jl.to(torch.float32) + 0.5)
    return rays_o, rays_d, gt, img_idx.to(torch.int32)


def _linspace(stop: float, num: int) -> np.ndarray:
    """f32 ``linspace(0, stop, num)`` rounded as the port's pixel grid is."""
    if num == 1:
        return np.zeros((1,), np.float32)
    step = np.float32(stop) * (np.float32(1.0) / np.float32(num - 1))
    out = np.arange(num - 1, dtype=np.float32) * step
    return np.concatenate([out, np.array([stop], np.float32)])


def camera_rays(data: dict, cam: int, height: int, width: int):
    """Every pixel's ray of camera ``cam``: (rays_o, rays_d) [H*W, 3]."""
    dev = data["poses"].device
    i = _linspace(height - 1.0, height) + np.float32(0.5)
    j = _linspace(width - 1.0, width) + np.float32(0.5)
    ii, jj = np.meshgrid(i, j, indexing="ij")
    return camera.pixel_to_ray(data["poses"][cam], data["intri"][cam], data["dist"][cam],
                               torch.from_numpy(ii.reshape(-1)).to(dev),
                               torch.from_numpy(jj.reshape(-1)).to(dev))
