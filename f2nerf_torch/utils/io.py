"""Image / point-cloud / mesh I/O (reference src/Utils/{ImageIO,Utils}.cpp).

Float images are HWC in [0, 1] (ReadImageTensor/WriteImageTensor semantics,
Utils.h:9-17). PLY/OBJ writers cover the reference's debug artifacts:
cam_pos.ply (Dataset.cpp:145) and octree.obj (PersSampler.cpp:332-357).

Copy of ``f2nerf_tpu/utils/io.py`` (that package imports jax; the port
does not); tests/test_torch_eval.py holds the two writers equal.
"""

from __future__ import annotations

import os

import numpy as np


def read_image(path: str) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0


def write_image(path: str, img: np.ndarray) -> None:
    from PIL import Image
    os.makedirs(os.path.dirname(path), exist_ok=True)
    arr = np.clip(np.asarray(img), 0.0, 1.0)
    Image.fromarray((arr * 255.0 + 0.5).astype(np.uint8)).save(path)


def export_pcd(path: str, pts: np.ndarray) -> None:
    """ASCII PLY point cloud (TensorExportPCD, Utils.cpp:8-67)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    pts = np.asarray(pts, np.float32).reshape(-1, 3)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("end_header\n")
        for p in pts:
            f.write(f"{p[0]} {p[1]} {p[2]}\n")


def export_octree_obj(path: str, tree) -> None:
    """Wireframe of valid octree leaves (VisOctree, PersSampler.cpp:332-357)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for i in range(tree.n_nodes):
            c, s = tree.center[i], tree.side[i]
            for st in range(8):
                off = np.array([(st >> 2) & 1, (st >> 1) & 1, st & 1]) - 0.5
                v = c + off * s
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for i in range(tree.n_nodes):
            if tree.trans_idx[i] < 0:
                continue
            for a in range(8):
                for b in range(a + 1, 8):
                    if (a ^ b) in (1, 2, 4):
                        f.write(f"l {i * 8 + a + 1} {i * 8 + b + 1}\n")
