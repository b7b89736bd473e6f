"""Camera model: pixel->ray generation with iterative undistortion and
scene normalization (port of ``f2nerf_tpu/core/camera.py``).

Semantics match the reference:
  * OpenGL-style c2w poses: camera looks down -z, pixel ray direction in
    camera frame is (u, -v, -1) with u=(j+.5-cx)/fx, v=(i+.5-cy)/fy in
    OpenCV image coords (Dataset.cu:98-123, Dataset.cpp:148-178).
  * Radial-tangential (k1,k2,p1,p2) distortion inverted by a fixed number
    of Newton steps with the analytic Jacobian (same fixed point as the
    reference's iterative_camera_undistortion, Dataset.cu:31-69).
  * Scene normalization: camera centroid -> origin, max radius -> 1
    (Dataset.cpp:127-146), host numpy.
  * Pose interpolation: quaternion slerp + translation lerp
    (CameraUtils.cpp:11-41), host numpy.

``pixel_to_ray`` launches kernel K15 (``ops/rays.py``, ``csrc/rays.cu``)
on CUDA tensors, in its camera form, and runs ``pixel_to_ray_plain``, the torch ops, on CPU tensors; the two
are bit for bit equal on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..ops import rays


def apply_distortion(params: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Forward distortion displacement (du, dv) (Dataset.cu:14-27)."""
    k1, k2, p1, p2 = params[..., 0], params[..., 1], params[..., 2], params[..., 3]
    u2, v2, uv = u * u, v * v, u * v
    r2 = u2 + v2
    radial = k1 * r2 + k2 * r2 * r2
    du = u * radial + 2.0 * p1 * uv + p2 * (r2 + 2.0 * u2)
    dv = v * radial + 2.0 * p2 * uv + p1 * (r2 + 2.0 * v2)
    return du, dv


def undistort(params: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
              n_iters: int = 10):
    """Find (x, y) with (x, y) + D(x, y) = (u, v) by Newton iteration."""
    k1, k2, p1, p2 = params[..., 0], params[..., 1], params[..., 2], params[..., 3]
    x, y = u, v
    for _ in range(n_iters):
        x2, y2, xy_ = x * x, y * y, x * y
        r2 = x2 + y2
        radial = k1 * r2 + k2 * r2 * r2
        dradial_dr2 = k1 + 2.0 * k2 * r2
        du = x * radial + 2.0 * p1 * xy_ + p2 * (r2 + 2.0 * x2)
        dv = y * radial + 2.0 * p2 * xy_ + p1 * (r2 + 2.0 * y2)
        fx_ = x + du - u
        fy_ = y + dv - v
        j00 = 1.0 + radial + x * dradial_dr2 * 2.0 * x + 2.0 * p1 * y + 6.0 * p2 * x
        j01 = x * dradial_dr2 * 2.0 * y + 2.0 * p1 * x + 2.0 * p2 * y
        j10 = y * dradial_dr2 * 2.0 * x + 2.0 * p2 * y + 2.0 * p1 * x
        j11 = 1.0 + radial + y * dradial_dr2 * 2.0 * y + 2.0 * p2 * x + 6.0 * p1 * y
        det = j00 * j11 - j01 * j10
        det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
        sx = (j11 * fx_ - j01 * fy_) / det
        sy = (-j10 * fx_ + j00 * fy_) / det
        x, y = x - sx, y - sy
    return x, y


def pixel_to_ray_plain(pose: torch.Tensor, intri: torch.Tensor, dist: torch.Tensor,
                       i: torch.Tensor, j: torch.Tensor, n_undistort_iters: int = 10):
    """Plain PyTorch version of K15's ``pixel_to_ray``: pixel (i=row,
    j=col, already +0.5-shifted) -> world ray (o, d).

    ``pose`` [..., 3, 4] c2w, ``intri`` [..., 3, 3], ``dist`` [..., 4]
    (Img2WorldRayKernel, Dataset.cu:98-123)."""
    fx = intri[..., 0, 0]
    fy = intri[..., 1, 1]
    cx = intri[..., 0, 2]
    cy = intri[..., 1, 2]
    u = (j - cx) / fx
    v = (i - cy) / fy
    u, v = undistort(dist, u, v, n_undistort_iters)
    # R @ (u, -v, -1) written out term by term: elementwise ops round the
    # same on every device, so the CPU and the card get bitwise equal rays
    # (a reduction or matmul may sum in another order and move a ray by an
    # ulp, which can flip a sample count downstream)
    rot = pose[..., :3, :3]
    rays_d = torch.stack([rot[..., a, 0] * u - rot[..., a, 1] * v - rot[..., a, 2]
                          for a in range(3)], dim=-1)
    rays_o = pose[..., :3, 3].expand_as(rays_d)
    return rays_o, rays_d


def pixel_to_ray(pose: torch.Tensor, intri: torch.Tensor, dist: torch.Tensor,
                 i: torch.Tensor, j: torch.Tensor, n_undistort_iters: int = 10):
    """Pixel (i=row, j=col, already +0.5-shifted) -> world ray (o, d)
    (Img2WorldRayKernel, Dataset.cu:98-123), in one of two forms the shapes
    tell apart: a camera a ray (``pose`` [n, 3, 4], ``intri`` [n, 3, 3],
    ``dist`` [n, 4]) or one camera for every ray (``pose`` [3, 4],
    ``intri`` [3, 3], ``dist`` [4]); i, j [n] f32. Returns (rays_o,
    rays_d) [n, 3]. CPU tensors take ``pixel_to_ray_plain``; CUDA tensors
    launch K15, bit for bit the plain version."""
    n = i.shape[0] if i.dim() == 1 else -1
    lead = () if pose.dim() == 2 else (n,)
    if n < 0 or tuple(j.shape) != (n,) or tuple(pose.shape) != (*lead, 3, 4) \
            or tuple(intri.shape) != (*lead, 3, 3) or tuple(dist.shape) != (*lead, 4):
        raise ValueError(f"pixel_to_ray: shapes pose {tuple(pose.shape)}, intri "
                         f"{tuple(intri.shape)}, dist {tuple(dist.shape)}, i "
                         f"{tuple(i.shape)}, j {tuple(j.shape)}")
    if any(x.dtype != torch.float32 for x in (pose, intri, dist, i, j)):
        raise ValueError(f"pixel_to_ray: every tensor must be float32, got "
                         f"{[str(x.dtype) for x in (pose, intri, dist, i, j)]}")
    if i.device.type == "cpu":
        return pixel_to_ray_plain(pose, intri, dist, i, j, n_undistort_iters)
    if i.device.type != "cuda":
        raise ValueError(f"pixel_to_ray: unsupported device {i.device}")
    ins = [x.contiguous() for x in (i, j, pose, intri, dist)]
    kernels.require_cuda("pixel_to_ray", *ins)
    return rays.rays_kernel(*ins, n_iters=n_undistort_iters, cam_step=len(lead))


def normalize_scene(poses: np.ndarray, bounds: np.ndarray):
    """Translate camera centroid to origin and scale max radius to 1.
    Returns (poses, bounds, center, radius); Dataset.cpp:127-146."""
    poses = np.array(poses, dtype=np.float32, copy=True)
    cam_pos = poses[:, :3, 3]
    center = cam_pos.mean(axis=0)
    radius = float(np.linalg.norm(cam_pos - center, axis=-1).max())
    poses[:, :3, 3] = (cam_pos - center) / radius
    bounds = np.asarray(bounds, dtype=np.float32) / radius
    return poses, bounds, center.astype(np.float32), radius


def invert_pose(poses: np.ndarray) -> np.ndarray:
    """c2w [n,3,4] -> w2c [n,3,4] (Dataset.cpp:137-143)."""
    n = poses.shape[0]
    full = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    full[:, :3, :] = poses
    return np.linalg.inv(full)[:, :3, :].astype(np.float32)


def _quat_from_mat(m: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (w, x, y, z), host numpy."""
    w = np.sqrt(max(0.0, 1.0 + m[0, 0] + m[1, 1] + m[2, 2])) / 2.0
    if w < 1e-6:
        # fall back to the largest diagonal element's branch
        if m[0, 0] >= m[1, 1] and m[0, 0] >= m[2, 2]:
            x = np.sqrt(max(0.0, 1.0 + m[0, 0] - m[1, 1] - m[2, 2])) / 2.0
            y = (m[0, 1] + m[1, 0]) / (4.0 * x)
            z = (m[0, 2] + m[2, 0]) / (4.0 * x)
            w = (m[2, 1] - m[1, 2]) / (4.0 * x)
        elif m[1, 1] >= m[2, 2]:
            y = np.sqrt(max(0.0, 1.0 - m[0, 0] + m[1, 1] - m[2, 2])) / 2.0
            x = (m[0, 1] + m[1, 0]) / (4.0 * y)
            z = (m[1, 2] + m[2, 1]) / (4.0 * y)
            w = (m[0, 2] - m[2, 0]) / (4.0 * y)
        else:
            z = np.sqrt(max(0.0, 1.0 - m[0, 0] - m[1, 1] + m[2, 2])) / 2.0
            x = (m[0, 2] + m[2, 0]) / (4.0 * z)
            y = (m[1, 2] + m[2, 1]) / (4.0 * z)
            w = (m[1, 0] - m[0, 1]) / (4.0 * z)
        return np.array([w, x, y, z])
    x = (m[2, 1] - m[1, 2]) / (4.0 * w)
    y = (m[0, 2] - m[2, 0]) / (4.0 * w)
    z = (m[1, 0] - m[0, 1]) / (4.0 * w)
    return np.array([w, x, y, z])


def _mat_from_quat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def pose_interpolate(pose_0: np.ndarray, pose_1: np.ndarray, alpha: float) -> np.ndarray:
    """Quaternion slerp between two [3,4] c2w poses + lerp of translation
    (PoseInterpolate, CameraUtils.cpp:11-41). Host numpy."""
    q0 = _quat_from_mat(pose_0[:3, :3])
    q1 = _quat_from_mat(pose_1[:3, :3])
    dot = float(np.dot(q0, q1))
    if dot < 0.0:
        q1, dot = -q1, -dot
    if dot > 0.9995:
        q = q0 + alpha * (q1 - q0)
    else:
        theta0 = np.arccos(np.clip(dot, -1.0, 1.0))
        theta = theta0 * alpha
        s0 = np.cos(theta) - dot * np.sin(theta) / np.sin(theta0)
        s1 = np.sin(theta) / np.sin(theta0)
        q = s0 * q0 + s1 * q1
    rot = _mat_from_quat(q)
    trans = (1.0 - alpha) * pose_0[:3, 3] + alpha * pose_1[:3, 3]
    out = np.zeros((3, 4), dtype=np.float32)
    out[:3, :3] = rot
    out[:3, 3] = trans
    return out
