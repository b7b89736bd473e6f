"""Frozen plain copy of the port's ``ops.activations``: every kernel dispatch replaced by the plain version it routes CPU tensors to, so this module runs plain torch on any device. It imports nothing of the port; cellbench's reference runs it.

Custom activations / gradient shaping ops (port of
``f2nerf_tpu/ops/activations.py``); the JAX ``custom_vjp``s become
``torch.autograd.Function``s with the same backward.

  * trunc_exp — exp forward, backward clamps the input to [-100, 5]
    (reference CustomOps.cpp:9-18); density = trunc_exp(x - 3).
  * gradient_scaling — identity forward; backward multiplies gradients by
    ``progress + (1 - progress) * a^2`` (reference CustomOps.cu:68-80).
  * weight_var — per-ray variance of the sample-weight distribution over
    positions i/16 (reference CustomOps.cu:12-66), through the segment ops'
    autograd Functions (K10 and its gather on the card)."""
from __future__ import annotations
import torch
from .segment import ray_gather, segment_sum
_WEIGHT_VAR_SCALE = 16.0

class _TruncExp(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return g * torch.exp(x.clamp(-100.0, 5.0))

def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return _TruncExp.apply(x)

def density_activation(raw: torch.Tensor) -> torch.Tensor:
    """density = trunc_exp(raw - 3) (reference Renderer.cpp:102-105)."""
    return trunc_exp(raw - 3.0)

class _GradientScaling(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, a_norm, progress):
        ctx.save_for_backward(a_norm, progress)
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        a_norm, progress = ctx.saved_tensors
        scale = progress + (1.0 - progress) * a_norm * a_norm
        scale = scale.reshape(tuple(scale.shape) + (1,) * (g.dim() - scale.dim()))
        return (g * scale, None, None)

def gradient_scaling(x: torch.Tensor, a_norm: torch.Tensor, progress: torch.Tensor) -> torch.Tensor:
    """Identity fwd; bwd scales grad by progress + (1-progress)*a_norm^2.
    ``a_norm``: [cap], broadcast over trailing dims of x; ``progress`` a
    0-d tensor in [0, 1]."""
    progress = torch.as_tensor(progress, dtype=x.dtype, device=x.device)
    return _GradientScaling.apply(x, a_norm.detach(), progress)

def weight_var(weights: torch.Tensor, ray_id: torch.Tensor, i_local: torch.Tensor, n_rays: int, offsets: torch.Tensor | None=None) -> torch.Tensor:
    """mean = sum w*(i/16) / (1e-6 + sum w);  var = sum w*(i/16 - mean)^2.
    ``offsets``: ``ray_offsets(ray_id, n_rays)[0]`` for the per-ray sums
    (the renderer's result carries them; computed when None)."""
    pos = i_local.to(torch.float32) / _WEIGHT_VAR_SCALE
    sums = segment_sum(torch.stack([weights, weights * pos], dim=1), ray_id, n_rays, offsets)
    mean = sums[:, 1] / (sums[:, 0] + 1e-06)
    bias = pos - ray_gather(mean, ray_id, n_rays, offsets)
    bias = torch.where(ray_id < n_rays, bias, torch.zeros_like(bias))
    return segment_sum(weights * bias * bias, ray_id, n_rays, offsets)
