"""The benchmark's scene: a camera ring around a ball, at a chosen size.

The port's synthetic scene (``f2nerf_torch/utils/synthetic.py``, 40x60 px)
copied with its size as a parameter: the same 24 ring cameras, and the
40x60 scene's field of view at any size (the focal length scales with the
width) and its colours. Images go straight into ``images_<factor>/`` with
intrinsics written at ``factor`` times the image size, as a dataset loader
that divides them by ``dataset.factor`` reads them, so nothing is resized.
The scene is the same for every seed: its colours set how many samples a
ray keeps once trained a little, and so the batch the controller settles
on, which the seed must not change.
"""

from __future__ import annotations

import os

import numpy as np

N_CAMS = 24
BASE_W, BASE_FOCAL = 60, 50.0
BALL_RADIUS = 0.7
BALL_COLOUR = np.array([0.9, 0.5, 0.1], np.float32)
BACKGROUND = 0.5


def camera_ring(n_cams: int = N_CAMS, radius: float = 2.0):
    """OpenGL-convention c2w poses [n, 3, 4] on a ring looking at the
    origin, heights jittered from a fixed stream (seed 0), as the port's
    synthetic scene has them."""
    rng = np.random.RandomState(0)
    c2w = np.zeros((n_cams, 3, 4), np.float32)
    for k in range(n_cams):
        ang = 2 * np.pi * k / n_cams
        pos = np.array([radius * np.cos(ang), radius * np.sin(ang),
                        0.5 + 0.1 * rng.randn()])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross(fwd, np.array([0.0, 0.0, 1.0]))
        right /= np.linalg.norm(right)
        c2w[k, :3, 0] = right
        c2w[k, :3, 1] = np.cross(right, fwd)
        c2w[k, :3, 2] = -fwd
        c2w[k, :3, 3] = pos
    return c2w


def render_ball(c2w: np.ndarray, focal: float, h: int, w: int) -> np.ndarray:
    """One view of the diffuse ball, [h, w, 3] uint8: a pixel whose ray
    meets the ball takes its colour, the rest the background."""
    u = ((np.arange(w, dtype=np.float32) + 0.5) - w / 2) / focal
    v = ((np.arange(h, dtype=np.float32) + 0.5) - h / 2) / focal
    rot, o = c2w[:3, :3].astype(np.float32), c2w[:3, 3].astype(np.float32)
    # ray direction R @ (u, -v, -1), per axis as a [h, w] outer sum
    d = [rot[a, 0] * u[None, :] - rot[a, 1] * v[:, None] - rot[a, 2] for a in range(3)]
    norm2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    b = (d[0] * o[0] + d[1] * o[1] + d[2] * o[2])
    hit = b * b - norm2 * (float(o @ o) - BALL_RADIUS ** 2) > 0
    img = np.empty((h, w, 3), np.uint8)
    img[:] = np.uint8(BACKGROUND * 255)
    img[hit] = (BALL_COLOUR * 255).astype(np.uint8)
    return img


def write_scene(out_dir: str, h: int, w: int, factor: int) -> np.ndarray:
    """Write cams_meta.npy, images_<factor>/ and image_list.txt under
    out_dir; return the images written, [n, h, w, 3] uint8."""
    from PIL import Image
    c2w = camera_ring()
    focal = BASE_FOCAL * w / BASE_W
    img_dir = os.path.join(out_dir, f"images_{factor}")
    os.makedirs(img_dir, exist_ok=True)
    paths, images = [], []
    for k in range(N_CAMS):
        p = os.path.join(img_dir, f"{k:04d}.png")
        images.append(render_ball(c2w[k], focal, h, w))
        Image.fromarray(images[-1]).save(p, compress_level=1)
        paths.append(p)
    with open(os.path.join(out_dir, "image_list.txt"), "w") as f:
        f.write("\n".join(paths) + "\n")
    intri = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]], np.float32)
    intri[:2] *= factor
    cams = np.zeros((N_CAMS, 27), np.float64)
    cams[:, :12] = c2w.reshape(N_CAMS, -1)
    cams[:, 12:21] = intri.reshape(-1)
    cams[:, 25:27] = (0.5, 6.0)
    np.save(os.path.join(out_dir, "cams_meta.npy"), cams)
    return np.stack(images)
