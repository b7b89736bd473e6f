"""COLMAP sparse-model readers (cameras / images / points3D, .bin or
.txt): a copy of the readers in ``scripts/colmap2poses.py`` (``scripts/``
is not a package of the port), for ``tools/pose_utils.py``."""

import os
import struct

import numpy as np

CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}


def qvec2rotmat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y],
    ])


# ------------------------------------------------------------ binary readers

def _read(f, fmt):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_bin(path):
    cams = {}
    with open(path, "rb") as f:
        n = _read(f, "<Q")[0]
        for _ in range(n):
            cid, model, w, h = _read(f, "<iiQQ")
            n_params = CAMERA_MODELS[model][1]
            params = _read(f, "<" + "d" * n_params)
            cams[cid] = dict(model=CAMERA_MODELS[model][0], width=w, height=h,
                             params=np.array(params))
    return cams


def read_images_bin(path):
    images = {}
    with open(path, "rb") as f:
        n = _read(f, "<Q")[0]
        for _ in range(n):
            iid = _read(f, "<I")[0]
            qvec = np.array(_read(f, "<dddd"))
            tvec = np.array(_read(f, "<ddd"))
            cam_id = _read(f, "<I")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            n_pts = _read(f, "<Q")[0]
            data = np.frombuffer(f.read(24 * n_pts), dtype=np.float64)
            p3d_ids = data.reshape(-1, 3)[:, 2].copy().view(np.int64) \
                if n_pts else np.zeros(0, np.int64)
            # xys are float64 pairs + int64 id per point; reparse exactly:
            rec = np.frombuffer(data.tobytes(), dtype=[("x", "<f8"), ("y", "<f8"), ("id", "<i8")]) \
                if n_pts else np.zeros(0, dtype=[("x", "<f8"), ("y", "<f8"), ("id", "<i8")])
            images[iid] = dict(qvec=qvec, tvec=tvec, camera_id=cam_id,
                               name=name.decode(), point3d_ids=rec["id"])
    return images


def read_points3d_bin(path):
    with open(path, "rb") as f:
        n = _read(f, "<Q")[0]
        ids = np.zeros(n, np.int64)
        xyz = np.zeros((n, 3), np.float64)
        for i in range(n):
            ids[i] = _read(f, "<Q")[0]
            xyz[i] = _read(f, "<ddd")
            f.read(3)  # rgb
            f.read(8)  # error
            track_len = _read(f, "<Q")[0]
            f.read(8 * track_len)
    return ids, xyz


def read_cameras_txt(path):
    cams = {}
    with open(path) as f:
        lines = f.readlines()
    for line in lines:
        if line.startswith("#") or not line.strip():
            continue
        parts = line.split()
        cams[int(parts[0])] = dict(
            model=parts[1], width=int(parts[2]), height=int(parts[3]),
            params=np.array([float(x) for x in parts[4:]]))
    return cams


def read_images_txt(path):
    images = {}
    with open(path) as f:
        lines = [l for l in f if not l.startswith("#") and l.strip()]
    for meta, pts in zip(lines[0::2], lines[1::2]):
        p = meta.split()
        iid = int(p[0])
        toks = pts.split()
        p3d = np.array([int(x) for x in toks[2::3]], np.int64) if toks else \
            np.zeros(0, np.int64)
        images[iid] = dict(
            qvec=np.array([float(x) for x in p[1:5]]),
            tvec=np.array([float(x) for x in p[5:8]]),
            camera_id=int(p[8]), name=p[9], point3d_ids=p3d)
    return images


def read_points3d_txt(path):
    ids, xyz = [], []
    with open(path) as f:
        lines = f.readlines()
    for line in lines:
        if line.startswith("#") or not line.strip():
            continue
        p = line.split()
        ids.append(int(p[0]))
        xyz.append([float(p[1]), float(p[2]), float(p[3])])
    return np.asarray(ids, np.int64), np.asarray(xyz, np.float64)


def load_sparse(sparse_dir):
    if os.path.exists(os.path.join(sparse_dir, "cameras.bin")):
        cams = read_cameras_bin(os.path.join(sparse_dir, "cameras.bin"))
        images = read_images_bin(os.path.join(sparse_dir, "images.bin"))
        pids, pxyz = read_points3d_bin(os.path.join(sparse_dir, "points3D.bin"))
    else:
        cams = read_cameras_txt(os.path.join(sparse_dir, "cameras.txt"))
        images = read_images_txt(os.path.join(sparse_dir, "images.txt"))
        pids, pxyz = read_points3d_txt(os.path.join(sparse_dir, "points3D.txt"))
    return cams, images, pids, pxyz
