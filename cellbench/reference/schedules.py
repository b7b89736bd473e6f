"""Frozen plain copy of the port's ``train.schedules``: every kernel dispatch replaced by the plain version it routes CPU tensors to, so this module runs plain torch on any device. It imports nothing of the port; cellbench's reference runs it.

Training schedules (ExpRunner::UpdateAdaParams, ExpRunner.cpp:221-254).

All pure functions of the integer step, evaluated on host each iteration
and fed to the step as scalars. Copy of ``f2nerf_tpu/train/schedules.py``;
tests/test_torch_ops.py holds the two equal."""
from __future__ import annotations
import math

def learning_rate(step: int, cfg: dict) -> float:
    """Linear warmup then cosine decay to alpha * base."""
    base = float(cfg['learning_rate'])
    alpha = float(cfg['learning_rate_alpha'])
    warm = int(cfg['learning_rate_warm_up_end_iter'])
    end = int(cfg['end_iter'])
    if step >= warm:
        progress = (step - warm) / max(end - warm, 1)
        factor = (1 - alpha) * (math.cos(progress * math.pi) * 0.5 + 0.5) + alpha
    else:
        factor = step / max(warm, 1)
    return base * factor

def ray_march_fineness(step: int, cfg: dict) -> float:
    """Exponential decay from ray_march_init_fineness to 1."""
    end = int(cfg['ray_march_fineness_decay_end_iter'])
    init = float(cfg['ray_march_init_fineness'])
    if step >= end:
        return 1.0
    progress = step / end
    return math.exp(math.log(init) * (1.0 - progress))

def gradient_scaling_progress(step: int, cfg: dict) -> float:
    start = int(cfg['gradient_scaling_start'])
    end = int(cfg['gradient_scaling_end'])
    if step >= end:
        return 1.0
    return max(0.0, (step - start) / (end - start + 1e-09))

def var_loss_weight(step: int, cfg: dict) -> float:
    """Linear ramp between var_loss_start and var_loss_end
    (ExpRunner.cpp:107-114)."""
    w = float(cfg['var_loss_weight'])
    start = int(cfg['var_loss_start'])
    end = int(cfg['var_loss_end'])
    if step > end:
        return w
    if step > start:
        return (step - start) / max(end - start, 1) * w
    return 0.0
