"""Synthetic test scene: a camera ring around a colored ball.

Copy of ``f2nerf_tpu/utils/synthetic.py`` (that package imports jax; the
port does not). tests/test_torch_ops.py keeps the two byte-for-byte equal
in output. Writes the same byte-compatible dataset layout the reference
consumes (Dataset.cpp:16-125).
"""

from __future__ import annotations

import os

import numpy as np


def camera_ring(n_cams=24, radius=2.0, target=(0, 0, 0), seed=0):
    """OpenGL-convention c2w poses on a ring looking at `target`."""
    rng = np.random.RandomState(seed)
    c2w = np.zeros((n_cams, 3, 4), np.float32)
    for k in range(n_cams):
        ang = 2 * np.pi * k / n_cams
        pos = np.array([radius * np.cos(ang), radius * np.sin(ang),
                        0.5 + 0.1 * rng.randn()])
        fwd = np.asarray(target) - pos
        fwd = fwd / np.linalg.norm(fwd)
        up = np.array([0.0, 0.0, 1.0])
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        up2 = np.cross(right, fwd)
        c2w[k, :3, 0] = right
        c2w[k, :3, 1] = up2
        c2w[k, :3, 2] = -fwd
        c2w[k, :3, 3] = pos
    w2c = np.zeros_like(c2w)
    for k in range(n_cams):
        full = np.eye(4, dtype=np.float32)
        full[:3] = c2w[k]
        w2c[k] = np.linalg.inv(full)[:3]
    return c2w, w2c


def write_ball_dataset(out_dir: str, n_cams=24, h=40, w=60, seed=0) -> str:
    """Render a diffuse ball analytically and write a reference-format
    dataset (cams_meta.npy, images/, image_list.txt)."""
    c2w, _ = camera_ring(n_cams=n_cams, seed=seed)
    intri = np.tile(np.array([[50.0, 0, w / 2], [0, 50.0, h / 2], [0, 0, 1]],
                             np.float32), (n_cams, 1, 1))
    dist = np.zeros((n_cams, 4), np.float32)
    bounds = np.tile(np.array([0.5, 6.0], np.float32), (n_cams, 1))

    from PIL import Image
    os.makedirs(os.path.join(out_dir, "images"), exist_ok=True)
    paths = []
    for k in range(n_cams):
        i, j = np.meshgrid(np.arange(h) + 0.5, np.arange(w) + 0.5, indexing="ij")
        u = (j - intri[k, 0, 2]) / intri[k, 0, 0]
        v = (i - intri[k, 1, 2]) / intri[k, 1, 1]
        d = np.stack([u, -v, -np.ones_like(u)], -1) @ c2w[k, :3, :3].T
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        o = c2w[k, :3, 3]
        b = (d * o).sum(-1)
        c = (o * o).sum() - 0.7 ** 2
        hit = b * b - c > 0
        img = np.full((h, w, 3), 0.5, np.float32)
        img[hit] = np.array([0.9, 0.5, 0.1])
        p = os.path.join(out_dir, "images", f"{k:04d}.png")
        Image.fromarray((img * 255).astype(np.uint8)).save(p)
        paths.append(p)
    with open(os.path.join(out_dir, "image_list.txt"), "w") as f:
        f.write("\n".join(paths) + "\n")

    cams = np.zeros((n_cams, 27), np.float64)
    cams[:, :12] = c2w.reshape(n_cams, -1)
    cams[:, 12:21] = intri.reshape(n_cams, -1)
    cams[:, 21:25] = dist
    cams[:, 25:27] = bounds
    np.save(os.path.join(out_dir, "cams_meta.npy"), cams)
    return out_dir


TINY_OVERRIDES = [
    "train.pts_batch_size=4096",
    "pts_sampler.bbox_levels=6",
    "pts_sampler.max_level=4",
    "pts_sampler.sample_l=0.015625",
    "train.ray_march_init_fineness=2",
    "field.log2_table_size=12",
    "+capacity.max_nodes=8192",
    "+capacity.max_trans=512",
    "+capacity.max_edges=16384",
]
