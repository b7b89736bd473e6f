"""Legacy LLFF-style pose pipeline: COLMAP sparse model ->
poses_bounds.npy (port of ``scripts/poses/pose_utils.py``, without jax).

``load_colmap_data`` / ``save_poses`` / ``minify`` / ``load_data`` as the
script has them (reference pose_utils.py:12-277), on the port's COLMAP
readers (``tools/colmap.py``) and image I/O (``utils/io.py``). The
script's ``gen_poses`` runs the external COLMAP program first and is not
carried over.

Output format (LLFF): poses_bounds.npy is [n_images, 17] float64 -- a 3x5
matrix (c2w rotation|translation|hwf column) in OpenGL (right, up, back)
axes, raveled, plus [near, far] from the 0.1/99.9 depth percentiles of the
points visible in that image. visibility.npy is [n_points, n_images] uint8.
Rotation columns are stored directly in OpenGL (right, up, back) order,
as the reference's pose_utils.py:54-55 stores them.
"""

import os

import numpy as np

from ..utils.io import export_pcd, read_image, write_image
from .colmap import load_sparse, qvec2rotmat

_IMG_EXT = (".jpg", ".jpeg", ".png", ".JPG", ".JPEG", ".PNG")


def load_colmap_data(realdir: str):
    """Read sparse/0 and return (poses [n, 3, 5] OpenGL c2w with hwf column,
    pts [P, 3], vis [P, n] uint8), images sorted by filename
    (reference pose_utils.py:12-57 semantics)."""
    cams, images, pids, pxyz = load_sparse(os.path.join(realdir, "sparse", "0"))
    cam = cams[sorted(cams.keys())[0]]
    hwf = np.array([cam["height"], cam["width"], cam["params"][0]], np.float64)

    order = sorted(images.keys(), key=lambda k: images[k]["name"])
    n = len(order)
    poses = np.zeros((n, 3, 5), np.float64)
    pid_to_row = {int(p): i for i, p in enumerate(pids)}
    vis = np.zeros((len(pids), n), np.uint8)
    for i, k in enumerate(order):
        im = images[k]
        r_w2c = qvec2rotmat(im["qvec"])
        # c2w: R^T, -R^T t; COLMAP camera axes (right, down, fwd) -> OpenGL
        # (right, up, back) by negating the y/z columns
        poses[i, :, :3] = r_w2c.T * np.array([1.0, -1.0, -1.0])
        poses[i, :, 3] = -r_w2c.T @ im["tvec"]
        poses[i, :, 4] = hwf
        rows = [pid_to_row[int(p)] for p in im["point3d_ids"]
                if int(p) in pid_to_row]
        vis[rows, i] = 1
    return poses, np.asarray(pxyz, np.float64), vis


def save_poses(basedir: str, poses: np.ndarray, pts: np.ndarray,
               vis: np.ndarray) -> None:
    """Write poses_bounds.npy / visibility.npy / debug point clouds
    (reference pose_utils.py:60-112)."""
    export_pcd(os.path.join(basedir, "sparse_cloud.ply"), pts)
    view_dir = os.path.join(basedir, "view_cloud")
    os.makedirs(view_dir, exist_ok=True)

    n = poses.shape[0]
    # depth of every point along each camera's forward axis (-z in OpenGL)
    centers = poses[:, :, 3]                      # [n, 3]
    fwd = -poses[:, :, 2]                         # [n, 3]
    zvals = np.einsum("pnc,nc->pn", pts[:, None, :] - centers[None], fwd)

    rows = np.zeros((n, 17), np.float64)
    for i in range(n):
        m = vis[:, i] == 1
        export_pcd(os.path.join(view_dir, f"{i}.ply"), pts[m])
        zs = zvals[m, i]
        if zs.size:
            near, far = np.percentile(zs, 0.1), np.percentile(zs, 99.9)
        else:
            near, far = 0.1, 10.0
        rows[i] = np.concatenate([poses[i].ravel(), [near, far]])
    np.save(os.path.join(basedir, "poses_bounds.npy"), rows)
    np.save(os.path.join(basedir, "visibility.npy"), vis)


def _list_images(d: str):
    return [f for f in sorted(os.listdir(d)) if f.endswith(_IMG_EXT)]


def minify(basedir: str, factors=(), resolutions=()) -> None:
    """Build images_{f}/ (or images_{w}x{h}/) downsampled pyramids
    (reference pose_utils.py:166-215; PIL instead of mogrify)."""
    src = os.path.join(basedir, "images")
    names = _list_images(src)
    for r in list(factors) + list(resolutions):
        if isinstance(r, int):
            out = os.path.join(basedir, f"images_{r}")
        else:
            out = os.path.join(basedir, f"images_{r[1]}x{r[0]}")
        if os.path.exists(out):
            continue
        os.makedirs(out)
        for f in names:
            img = read_image(os.path.join(src, f))
            h, w = img.shape[:2]
            size = (h // r, w // r) if isinstance(r, int) else (r[0], r[1])
            from PIL import Image
            im = Image.fromarray((img * 255 + 0.5).astype(np.uint8))
            im = im.resize((size[1], size[0]), Image.LANCZOS)
            write_image(os.path.join(out, os.path.splitext(f)[0] + ".png"),
                        np.asarray(im, np.float32) / 255.0)
        print("Minified", r, "->", out)


def load_data(basedir: str, factor=None, width=None, height=None,
              load_imgs=True):
    """Read poses_bounds.npy (+ images at the requested scale), fixing the
    hwf column to the actual on-disk resolution
    (reference pose_utils.py:220-277). Returns (poses [n,3,5], bds [n,2])
    or (poses, bds, imgs [n,h,w,3] float)."""
    arr = np.load(os.path.join(basedir, "poses_bounds.npy"))
    poses = arr[:, :-2].reshape(-1, 3, 5)
    bds = arr[:, -2:]

    src = os.path.join(basedir, "images")
    h0, w0 = read_image(os.path.join(src, _list_images(src)[0])).shape[:2]
    sfx = ""
    if factor is not None:
        sfx = f"_{factor}"
        minify(basedir, factors=[factor])
    elif height is not None:
        factor = h0 / float(height)
        width = int(w0 / factor)
        minify(basedir, resolutions=[[height, width]])
        sfx = f"_{width}x{height}"
    elif width is not None:
        factor = w0 / float(width)
        height = int(h0 / factor)
        minify(basedir, resolutions=[[height, width]])
        sfx = f"_{width}x{height}"
    else:
        factor = 1

    imgdir = os.path.join(basedir, "images" + sfx)
    names = _list_images(imgdir)
    if len(names) != poses.shape[0]:
        raise ValueError(f"{imgdir}: {len(names)} images for {poses.shape[0]} poses")
    h, w = read_image(os.path.join(imgdir, names[0])).shape[:2]
    poses = poses.copy()
    poses[:, 0, 4] = h
    poses[:, 1, 4] = w
    poses[:, 2, 4] = poses[:, 2, 4] / factor
    if not load_imgs:
        return poses, bds
    imgs = np.stack([read_image(os.path.join(imgdir, f)) for f in names])
    return poses, bds, imgs
