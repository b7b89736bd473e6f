"""Pixels to world rays: kernel K15's wrapper (csrc/rays.cu).

K15 is the CUDA route of ``data/dataset.py`` ``sample_rays`` and of
``core/camera.py`` ``pixel_to_ray``, whose plain versions
(``sample_rays_plain``, ``pixel_to_ray_plain``) are the CPU route and the
reference it is held to bit for bit on the card. The callers check their
arguments; this module only launches.
"""

from __future__ import annotations

import torch

from .. import kernels


def rays_kernel(i: torch.Tensor, j: torch.Tensor, poses: torch.Tensor,
                intri: torch.Tensor, dist: torch.Tensor, n_iters: int = 10,
                cam_step: int = 0, pick: torch.Tensor | None = None,
                train_ids: torch.Tensor | None = None,
                images: torch.Tensor | None = None, bounds: torch.Tensor | None = None):
    """One launch of K15 (``f2_rays``) on contiguous CUDA tensors. Camera
    form (``pixel_to_ray``, no ``pick``): (i, j) [n] f32 shifted pixels,
    ray r on camera row ``r * cam_step`` of poses/intri/dist; returns
    (rays_o, rays_d). Training form (``sample_rays``, with ``pick`` and
    the tables of ``Dataset.device_arrays``): (i, j) integer pixels of
    pick's dtype, ray r on camera ``train_ids[pick[r]]`` and image row
    ``pick[r]``; returns (rays_o, rays_d, bounds, gt, img_idx). No launch
    for n = 0."""
    dev = i.device
    n = i.shape[0]
    kw = dict(dtype=torch.float32, device=dev)
    rays_o = torch.empty((n, 3), **kw)
    rays_d = torch.empty((n, 3), **kw)
    outs = ()
    if pick is not None:
        outs = (torch.empty((n, 2), **kw), torch.empty((n, 3), **kw),
                torch.empty((n,), dtype=torch.int32, device=dev))
    if n > 0:
        kind = {torch.int32: 0, torch.int64: 1, torch.float32: 2}[i.dtype]
        bounds_out, gt, img_idx = outs or (None, None, None)
        ptr = [None if x is None else x.data_ptr()
               for x in (pick, i, j, train_ids, images, poses, intri, dist, bounds,
                         rays_o, rays_d, gt, bounds_out, img_idx)]
        n_rows, height, width = images.shape[:3] if images is not None else (0, 0, 0)
        code = kernels.library().f2_rays(
            *ptr[:3], kind, *ptr[3:], n, n_rows, poses.shape[0] if poses.dim() == 3 else 1,
            height, width, cam_step, n_iters, kernels.stream_ptr(dev))
        kernels.check(code, "rays")
        rays_kernel.launches += 1
    return (rays_o, rays_d, *outs)


rays_kernel.launches = 0
