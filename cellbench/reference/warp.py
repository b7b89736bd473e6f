"""Frozen plain copy of the port's ``sampler/warp.py``: the leaf warps'
construction (distance summary, virtual cameras, the PCA and step
normalisation of ``finish_trans_batch``), so the reference builds its own
warp table. It imports nothing of the port; cellbench's reference runs it."""

from __future__ import annotations

import numpy as np
import torch

N_PROS = 12


def distance_summary(dis: np.ndarray) -> float:
    """exp(mean of log-distances below the first quartile); 1e8 if empty.

    Falls back to exp(mean(log)) when the below-quartile mask is empty
    (reference PersSampler.cpp:16-25).
    """
    dis = np.asarray(dis, np.float64).reshape(-1)
    if dis.size <= 0:
        return 1e8
    log_dis = np.log(np.maximum(dis, 1e-30))
    thres = np.quantile(log_dis, 0.25)
    mask = log_dis < thres
    if mask.sum() < 1e-3:
        return float(np.exp(log_dis.mean()))
    return float(np.exp(log_dis[mask].mean()))


def _rot_align(from_z: np.ndarray, to_z: np.ndarray) -> np.ndarray:
    """Rotation matrix R with (row-vector convention) from_z @ R.T == to_z.

    Mirrors the angle-axis construction at PersSampler.cpp:525-546:
    angle = asin(|cross|), flipped through pi when the dot is negative.
    """
    crossed = np.cross(from_z, to_z)
    sin_val = np.linalg.norm(crossed)
    cos_val = float(np.dot(from_z, to_z))
    angle = np.arcsin(np.clip(sin_val, -1.0, 1.0))
    if cos_val < 0.0:
        angle = np.pi - angle
    if sin_val < 1e-12:
        return np.eye(3) if cos_val > 0 else -np.eye(3)
    axis = crossed / sin_val
    k = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * (k @ k)


def virtual_cams(c2w: np.ndarray, intri: np.ndarray, center: np.ndarray,
                 rng: np.random.Generator) -> tuple[np.ndarray, float]:
    """Host half of the leaf-warp construction: distance summary, greedy
    camera selection, z-axis alignment, projection rows
    (PersSampler.cpp:461-566). Cheap (O(n_cams)); the per-point PCA +
    Jacobian half is batched over leaves on the accelerator
    (``finish_trans_batch``). Returns (w2xz [12, 2, 4] f64, dis_summary)."""
    n_virt = N_PROS // 2
    n_cams = c2w.shape[0]
    center = np.asarray(center, np.float64)
    cam_pos = c2w[:, :3, 3].astype(np.float64)
    cam_axes = np.linalg.inv(c2w[:, :3, :3].astype(np.float64))  # rows = axes

    dis = np.linalg.norm(cam_pos - center, axis=-1)
    dis_sum = distance_summary(dis)
    normed = (cam_pos - center) / dis[:, None]

    # greedy farthest-point selection on normalized positions
    pair_dis = np.linalg.norm(normed[None] - normed[:, None], axis=-1)
    good = [int(rng.integers(n_cams))]
    marks = np.zeros(n_cams, bool)
    marks[good[0]] = True
    for _ in range(1, min(n_virt, n_cams)):
        cand_dis = pair_dis[:, marks].min(axis=1)
        cand_dis[marks] = -1.0
        cand = int(np.argmax(cand_dis))
        marks[cand] = True
        good.append(cand)
    i = 0
    while len(good) < n_virt:
        good.append(good[i])
        i += 1

    cam_scale = np.clip(dis / dis_sum, 1.0, 1e9)
    rel_pos = normed * np.clip(dis, dis_sum, 1e9)[:, None]

    g = np.asarray(good)
    good_pos = rel_pos[g] + center          # virtual cam world position
    good_rel = rel_pos[g]
    good_axes = cam_axes[g].copy()          # [6, 3, 3] rows = x, y, z axes
    good_scale = cam_scale[g]

    expect_z = good_rel / np.linalg.norm(good_rel, axis=-1, keepdims=True)
    for i in range(n_virt):
        r = _rot_align(good_axes[i, 2], expect_z[i])
        good_axes[i] = good_axes[i] @ r.T
    assert np.abs(good_axes[:, 2] - expect_z).max() < 1e-3

    focal = float(intri[0, 0] / intri[0, 2])
    x_axis = good_axes[:, 0] * focal * good_scale[:, None]
    y_axis = good_axes[:, 1] * focal * good_scale[:, None]
    z_axis = good_axes[:, 2]

    row0 = np.concatenate([x_axis, y_axis], axis=0)       # [12, 3]
    row1 = np.concatenate([z_axis, z_axis], axis=0)       # [12, 3]
    wp_pos = np.concatenate([good_pos, good_pos], axis=0)  # [12, 3]
    w2xz = np.zeros((N_PROS, 2, 4))
    w2xz[:, 0, :3] = row0
    w2xz[:, 1, :3] = row1
    w2xz[:, 0, 3] = -(row0 * wp_pos).sum(-1)
    w2xz[:, 1, 3] = -(row1 * wp_pos).sum(-1)
    return w2xz, dis_sum


def _inv3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 inverse (adjugate/det), vectorized."""
    a, b_, cc = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    ca, cb, ccc = e * i - f * h, cc * h - b_ * i, b_ * f - cc * e
    cd, ce, cf = f * g - d * i, a * i - cc * g, cc * d - a * f
    cg, ch, ci = d * h - e * g, b_ * g - a * h, a * e - b_ * d
    det = a * ca + b_ * cd + cc * cg
    adj = torch.stack([torch.stack([ca, cb, ccc], -1),
                       torch.stack([cd, ce, cf], -1),
                       torch.stack([cg, ch, ci], -1)], -2)
    return adj / det[..., None, None]


def _ab(w2xz: torch.Tensor, pts: torch.Tensor):
    w0, t0 = w2xz[:, :, 0, :3], w2xz[:, :, 0, 3]
    w1, t1 = w2xz[:, :, 1, :3], w2xz[:, :, 1, 3]
    a = torch.einsum("cnk,cjk->cnj", pts, w0) + t0[:, None]
    b = torch.einsum("cnk,cjk->cnj", pts, w1) + t1[:, None]
    return a, b, w0, w1


def _cov(w2xz: torch.Tensor, pts: torch.Tensor):
    """Covariance [c, 12, 12] of the projected coords and max b per leaf."""
    a, b, _, _ = _ab(w2xz, pts)
    v = a / b
    mv = v - v.mean(dim=1, keepdim=True)
    cov = torch.einsum("cni,cnj->cij", mv, mv) / pts.shape[1]
    return cov, b.amax(dim=(1, 2))


def _mean_step(w2xz: torch.Tensor, pts: torch.Tensor, weight: torch.Tensor):
    """Mean per-axis step (1 / max |d image / d warp|) per leaf, [c, 3]."""
    a, b, w0, w1 = _ab(w2xz, pts)
    dv = (w0[:, None] / b[..., None]
          - (a / (b * b))[..., None] * w1[:, None])     # [c, n, 12, 3]
    jac = torch.einsum("cxj,cnjk->cnxk", weight, dv)    # [c, n, 3, 3]
    jac_w2i = torch.einsum("cnjk,cnkx->cnjx", dv, _inv3(jac))
    jac_max = jac_w2i.abs().amax(dim=2)                 # [c, n, 3]
    return (1.0 / jac_max).mean(dim=1)


def finish_trans_batch(w2xz_all: np.ndarray, pts_all: np.ndarray = None,
                       centers: np.ndarray = None, sides: np.ndarray = None,
                       seed: int = 0, n_rand: int = 32768, chunk: int = 16,
                       device="cpu") -> np.ndarray:
    """Batched second half of ConstructTrans over L leaves: PCA of projected
    coords + mean-Jacobian step normalization (PersSampler.cpp:568-597).

    w2xz_all: [L, 12, 2, 4]. Either pass explicit in-node points
    (pts_all [L, n_pts, 3]) or (centers, sides, seed) to draw n_rand
    uniform points per leaf on ``device`` (torch.Generator seeded with
    seed + chunk start; the JAX package draws with jax.random, so the
    weights of a fresh build differ between the packages).
    Returns weight [L, 3, 12] f32. Asserts all points sit in front of the
    virtual cameras (b < 0).
    """
    L = w2xz_all.shape[0]
    if L == 0:
        return np.zeros((0, 3, N_PROS), np.float32)
    n = n_rand if pts_all is None else pts_all.shape[1]
    chunk = min(chunk, L)
    out = np.zeros((L, 3, N_PROS), np.float32)
    for i in range(0, L, chunk):
        m = min(chunk, L - i)
        w = np.zeros((chunk, N_PROS, 2, 4), np.float32)
        w[:m] = w2xz_all[i:i + m]
        w[m:] = w2xz_all[i]  # pad with a real leaf: keeps b < 0 everywhere
        w_t = torch.as_tensor(w, device=device)
        if pts_all is None:
            cpad = np.zeros((chunk, 3), np.float32)
            spad = np.full((chunk,), 1e-3, np.float32)
            cpad[:m] = centers[i:i + m]
            spad[:m] = sides[i:i + m]
            cpad[m:] = centers[i]
            spad[m:] = sides[i]
            gen = torch.Generator(device=device).manual_seed(seed + i)
            u = torch.rand((chunk, n, 3), generator=gen, device=device)
            p = ((u - 0.5) * torch.as_tensor(spad, device=device)[:, None, None]
                 + torch.as_tensor(cpad, device=device)[:, None, :])
        else:
            pp = np.zeros((chunk, n, 3), np.float32)
            pp[:m] = pts_all[i:i + m]
            pp[m:] = pts_all[i]
            p = torch.as_tensor(pp, device=device)
        cov, max_b = _cov(w_t, p)
        cov = cov.cpu().numpy()
        if not float(max_b.max()) < 0.0:
            raise ValueError("points must be in front of the virtual cameras")
        # host eigh in f64: top-3 eigenvectors as rows (reference PCA,
        # PersSampler.cpp:423-435)
        _, vec = np.linalg.eigh(cov.astype(np.float64))
        weight = vec[:, :, ::-1][:, :, :3].transpose(0, 2, 1)  # [c, 3, 12]
        mean_step = _mean_step(w_t, p, torch.as_tensor(
            weight.astype(np.float32), device=device))
        mean_step = mean_step.cpu().numpy().astype(np.float64)
        out[i:i + m] = (weight / mean_step[:, :, None])[:m].astype(np.float32)
    return out
