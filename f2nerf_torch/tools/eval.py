"""Offline PSNR / SSIM / LPIPS evaluation (port of ``scripts/eval.py``,
without jax; reference scripts/eval.py:27-121).

Directory layout (same as the reference):
    <base_data_dir>/<scene>/gt/*.png        ground-truth renders
    <base_data_dir>/<scene>/<method>/*.png  predictions
Writes <scene>/<method>/info.json with per-image and mean metrics.

SSIM is the port's ``utils/metrics.rgb_ssim``; LPIPS stays None unless the
`lpips` package is importable (its weights come from outside the repo).

    python -m f2nerf_torch.tools.eval --base_data_dir exp/evals --scenes a,b --methods m
"""

import argparse
import json
import os
from glob import glob

import numpy as np

from ..utils.metrics import make_lpips, rgb_ssim


def glob_images(image_dir):
    ret = []
    for suff in ["*.jpg", "*.JPG", "*.png", "*.PNG"]:
        ret += glob(os.path.join(image_dir, suff))
    return sorted(ret)


def read_image(path):
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.float32)


def psnr(gt_u8: np.ndarray, pd_u8: np.ndarray) -> float:
    mse = np.mean((gt_u8.astype(np.float64) - pd_u8.astype(np.float64)) ** 2)
    return float(20.0 * np.log10(255.0 / np.sqrt(max(mse, 1e-12))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base_data_dir", default="exp/evals")
    ap.add_argument("--scenes", required=True, help="comma-separated")
    ap.add_argument("--methods", required=True, help="comma-separated")
    args = ap.parse_args(argv)

    lpips_fn = make_lpips()
    for scene in args.scenes.split(","):
        scene_dir = os.path.join(args.base_data_dir, scene)
        gt_paths = glob_images(os.path.join(scene_dir, "gt"))
        for method in args.methods.split(","):
            pd_paths = glob_images(os.path.join(scene_dir, method))
            if len(gt_paths) != len(pd_paths):
                raise ValueError(f"{scene}/{method}: {len(pd_paths)} images for "
                                 f"{len(gt_paths)} ground-truth images")
            info = {"psnr": {}, "ssim": {}, "lpips": {}}
            tot = np.zeros(3)
            for i, (g, p) in enumerate(zip(gt_paths, pd_paths)):
                gt = read_image(g)
                pd = read_image(p)
                m_psnr = psnr(gt, pd)
                m_ssim = rgb_ssim(gt / 255.0, pd / 255.0)
                m_lpips = lpips_fn(gt, pd) if lpips_fn else float("nan")
                info["psnr"][str(i)] = m_psnr
                info["ssim"][str(i)] = m_ssim
                info["lpips"][str(i)] = m_lpips
                tot += [m_psnr, m_ssim, m_lpips]
                print(f"{scene}/{method} {i}: psnr {m_psnr:.2f} ssim {m_ssim:.4f}")
            n = len(gt_paths)
            info["psnr"]["mean"] = tot[0] / n
            info["ssim"]["mean"] = tot[1] / n
            info["lpips"]["mean"] = tot[2] / n
            with open(os.path.join(scene_dir, method, "info.json"), "w") as f:
                json.dump(info, f, indent=2)


if __name__ == "__main__":
    main()
