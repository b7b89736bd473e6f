"""Image quality metrics: PSNR / SSIM (and optional LPIPS).

Copy of ``f2nerf_tpu/utils/metrics.py`` (that package imports jax; the port
does not); tests/test_torch_eval.py holds the two equal. ``rgb_ssim`` is
kept exactly as the JAX package has it, without the reference's
``sigma01`` clamp (ROADMAP.md queue 3).

The reference computes PSNR inline after test renders (ExpRunner.cpp:360-369)
and SSIM/LPIPS offline in scripts/eval.py:27-121 (mip-NeRF-style separable
gaussian SSIM, lpips-vgg). Here the SSIM implementation lives in the package
so both the offline script and the in-process test flow share one
implementation, and `mode=test` can publish the full metric set directly.
"""

from __future__ import annotations

import numpy as np
import scipy.signal


def psnr_float(gt: np.ndarray, pred: np.ndarray, max_val: float = 1.0) -> float:
    """PSNR over float images in [0, max_val]."""
    mse = float(np.mean((gt.astype(np.float64) - pred.astype(np.float64)) ** 2))
    return float(20.0 * np.log10(max_val / np.sqrt(max(mse, 1e-12))))


def rgb_ssim(img0: np.ndarray, img1: np.ndarray, max_val: float = 1.0,
             filter_size: int = 11, filter_sigma: float = 1.5,
             k1: float = 0.01, k2: float = 0.03) -> float:
    """Separable-gaussian SSIM over RGB, mip-NeRF semantics
    (reference scripts/eval.py:27-74)."""
    hw = filter_size // 2
    shift = np.arange(filter_size) - hw
    f_i = np.exp(-0.5 * (shift / filter_sigma) ** 2)
    f_i /= f_i.sum()

    def blur(z):
        z = scipy.signal.convolve2d(z, f_i[:, None], mode="valid")
        return scipy.signal.convolve2d(z, f_i[None, :], mode="valid")

    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    ssim_vals = []
    for ch in range(img0.shape[-1]):
        x, y = img0[..., ch], img1[..., ch]
        mu0, mu1 = blur(x), blur(y)
        s00 = blur(x * x) - mu0 ** 2
        s11 = blur(y * y) - mu1 ** 2
        s01 = blur(x * y) - mu0 * mu1
        s00, s11 = np.maximum(0.0, s00), np.maximum(0.0, s11)
        ssim_map = ((2 * mu0 * mu1 + c1) * (2 * s01 + c2)) / \
            ((mu0 ** 2 + mu1 ** 2 + c1) * (s00 + s11 + c2))
        ssim_vals.append(ssim_map.mean())
    return float(np.mean(ssim_vals))


def make_lpips():
    """LPIPS(vgg) on torch-cpu when the `lpips` package is importable;
    returns None otherwise (this image ships without it)."""
    try:
        import lpips  # noqa: F401
        import torch

        net = lpips.LPIPS(net="vgg")

        def fn(gt_u8: np.ndarray, pd_u8: np.ndarray) -> float:
            def conv(x):
                t = torch.from_numpy(x / 255.0 * 2.0 - 1.0).float()
                return t.permute(2, 0, 1)[None]
            with torch.no_grad():
                return float(net(conv(gt_u8), conv(pd_u8)).item())

        return fn
    except ImportError:
        return None
