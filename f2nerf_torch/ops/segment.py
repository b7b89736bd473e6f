"""Segmented (per-ray) ops over flat sample buffers (port of
``f2nerf_tpu/ops/segment.py``).

Samples sit in a flat fixed-capacity buffer with a per-sample ``ray_id``
(sorted; padding rows carry ray_id == n_rays). All ops are plain torch and
differentiable through autograd.

``segment_cumsum`` accumulates in float64: a global f32 cumsum minus each
segment's base would lose precision over a 393k-sample buffer, which is
why the JAX package scans (value, flag) pairs instead.
"""

from __future__ import annotations

import torch


def segment_sum(x: torch.Tensor, ray_id: torch.Tensor, n_rays: int) -> torch.Tensor:
    """Per-ray sum. x: [cap] or [cap, c]; returns [n_rays] or [n_rays, c].
    Padding samples (ray_id == n_rays) are dropped."""
    out = x.new_zeros((n_rays + 1,) + tuple(x.shape[1:]))
    return out.index_add(0, ray_id.long(), x)[:n_rays]


def segment_max(x: torch.Tensor, ray_id: torch.Tensor, n_rays: int) -> torch.Tensor:
    """Per-ray max; -inf for empty rays (jax.ops.segment_max)."""
    out = torch.full((n_rays + 1,) + tuple(x.shape[1:]), float("-inf"),
                     dtype=x.dtype, device=x.device)
    idx = ray_id.long()
    if x.dim() > 1:
        idx = idx.view(-1, *([1] * (x.dim() - 1))).expand_as(x)
    return out.scatter_reduce(0, idx, x, "amax", include_self=True)[:n_rays]


def _segment_start(is_first: torch.Tensor) -> torch.Tensor:
    """Index of the latest flagged position <= k (0 before any flag), the
    reset point of the JAX (value, flag) scan."""
    idx = torch.arange(is_first.shape[0], device=is_first.device)
    marks = torch.where(is_first, idx, torch.zeros_like(idx))
    return torch.cummax(marks, dim=0).values


def segment_cumsum(x: torch.Tensor, is_first: torch.Tensor,
                   exclusive: bool = True) -> torch.Tensor:
    """Segmented prefix sum along a flat buffer (FlexOps::AccumulateSum,
    FlexOps.cu:75-215). ``is_first`` marks the first sample of each
    segment; rows after the last flag keep accumulating (as in the JAX
    scan)."""
    cs = torch.cumsum(x.double(), dim=0)
    cs_pad = torch.cat([cs.new_zeros(1), cs])
    start = _segment_start(is_first)
    base = cs_pad.index_select(0, start)  # backward: index_add, not a sort
    if exclusive:
        return (cs_pad[:-1] - base).to(x.dtype)
    return (cs - base).to(x.dtype)


def first_flags_from_ray_id(ray_id: torch.Tensor, n_rays: int) -> torch.Tensor:
    """is_first[k] = sample k starts a new segment (ray_id changes at k)."""
    prev = torch.cat([ray_id.new_full((1,), -1), ray_id[:-1]])
    return (ray_id != prev) & (ray_id < n_rays)


def local_index(ray_id: torch.Tensor, n_rays: int) -> torch.Tensor:
    """Index of each sample within its ray (0-based), int32."""
    is_first = first_flags_from_ray_id(ray_id, n_rays)
    idx = torch.arange(ray_id.shape[0], device=ray_id.device)
    return (idx - _segment_start(is_first)).to(torch.int32)
