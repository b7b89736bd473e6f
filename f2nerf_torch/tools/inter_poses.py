"""Generate a smooth novel-view path through key poses -> poses_render.npy
(port of ``scripts/inter_poses.py``, without jax).

Reference scripts/inter_poses.py:11-62: every output pose is a
gaussian-weighted chain of pairwise slerps through the key poses.

    python -m f2nerf_torch.tools.inter_poses --data_dir <scene> [--key_poses 0,3,7]
"""

import argparse
import os

import numpy as np

from ..core.camera import pose_interpolate


def inter_poses(key_poses: np.ndarray, n_out: int, sigma: float = 1.0) -> np.ndarray:
    n_key = len(key_poses)
    out = []
    for i in range(n_out):
        w = np.linspace(0, n_key - 1, n_key)
        w = np.exp(-((np.abs(i / n_out * n_key - w) / sigma) ** 2)) + 1e-6
        w /= w.sum()
        cur = key_poses[0]
        cur_w = w[0]
        for j in range(n_key - 1):
            # alpha convention matches the reference: weight cur_w stays on
            # the accumulated pose
            cur = pose_interpolate(key_poses[j + 1], cur,
                                   cur_w / (cur_w + w[j + 1]))
            cur_w += w[j + 1]
        out.append(cur)
    return np.stack(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--key_poses", default="all",
                    help="'all' or comma-separated image indices")
    ap.add_argument("--n_out_poses", type=int, default=240)
    args = ap.parse_args(argv)

    cams = np.load(os.path.join(args.data_dir, "cams_meta.npy")).reshape(-1, 27)
    poses = cams[:, :12].reshape(-1, 3, 4)
    if args.key_poses == "all":
        key = poses.copy()
    else:
        key = poses[[int(x) for x in args.key_poses.split(",")]]
    out = inter_poses(key, args.n_out_poses)
    np.save(os.path.join(args.data_dir, "poses_render.npy"),
            np.ascontiguousarray(out.astype(np.float64)))


if __name__ == "__main__":
    main()
