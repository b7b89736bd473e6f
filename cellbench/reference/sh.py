"""Frozen plain copy of the port's ``fields.sh``: every kernel dispatch replaced by the plain version it routes CPU tensors to, so this module runs plain torch on any device. It imports nothing of the port; cellbench's reference runs it.

Real spherical-harmonics direction encoding (port of
``f2nerf_tpu/fields/sh.py``; reference SHShader.cu:10-106). Degrees 1-4
use the hardcoded table, 5-8 the Cartesian recurrence."""
from __future__ import annotations
import math
import torch

def sh_encode_general(dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """Real SH basis for any degree (Condon-Shortley; index l^2 + (l + m))."""
    x, y, z = (dirs[..., 0], dirs[..., 1], dirs[..., 2])
    one = torch.ones_like(x)
    out = [None] * (degree * degree)
    A = [one]
    B = [torch.zeros_like(x)]
    for m in range(1, degree):
        A.append(x * A[m - 1] - y * B[m - 1])
        B.append(x * B[m - 1] + y * A[m - 1])

    def K(l, m):
        return math.sqrt((2 * l + 1) / (4 * math.pi) * math.factorial(l - m) / math.factorial(l + m))

    def emit(l, m, p):
        k = K(l, m)
        if m == 0:
            out[l * l + l] = k * p
        else:
            sq2k = math.sqrt(2.0) * k
            out[l * l + l + m] = sq2k * p * A[m]
            out[l * l + l - m] = sq2k * p * B[m]
    for m in range(degree):
        coef = 1.0
        for i in range(1, m + 1):
            coef *= -(2 * i - 1)
        pmm = coef * one
        emit(m, m, pmm)
        if m + 1 < degree:
            pm1 = (2 * m + 1) * z * pmm
            emit(m + 1, m, pm1)
            p_lm2, p_lm1 = (pmm, pm1)
            for l in range(m + 2, degree):
                p = ((2 * l - 1) * z * p_lm1 - (l + m - 1) * p_lm2) / (l - m)
                emit(l, m, p)
                p_lm2, p_lm1 = (p_lm1, p)
    return torch.stack(out, dim=-1)

def sh_encode(dirs: torch.Tensor, degree: int=4) -> torch.Tensor:
    """dirs: [..., 3] unit direction vectors -> [..., degree**2] SH basis."""
    if not 1 <= degree <= 8:
        raise NotImplementedError(f'SH degree {degree} not supported (1..8)')
    if degree > 4:
        return sh_encode_general(dirs, degree)
    x, y, z = (dirs[..., 0], dirs[..., 1], dirs[..., 2])
    out = [torch.full_like(x, 0.28209479177387814)]
    if degree >= 2:
        out += [-0.48860251190291987 * y, 0.48860251190291987 * z, -0.48860251190291987 * x]
    if degree >= 3:
        xy, yz, xz = (x * y, y * z, x * z)
        x2, y2, z2 = (x * x, y * y, z * z)
        out += [1.0925484305920792 * xy, -1.0925484305920792 * yz, 0.94617469575756 * z2 - 0.31539156525252, -1.0925484305920792 * xz, 0.5462742152960396 * (x2 - y2)]
    if degree >= 4:
        out += [0.5900435899266435 * y * (-3.0 * x2 + y2), 2.890611442640554 * xy * z, 0.4570457994644657 * y * (1.0 - 5.0 * z2), 0.3731763325901154 * z * (5.0 * z2 - 3.0), 0.4570457994644657 * x * (1.0 - 5.0 * z2), 1.445305721320277 * z * (x2 - y2), 0.5900435899266435 * x * (-x2 + 3.0 * y2)]
    return torch.stack(out, dim=-1)
