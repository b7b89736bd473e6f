"""Frozen plain copy of the port's ``fields.mlp``: every kernel dispatch replaced by the plain version it routes CPU tensors to, so this module runs plain torch on any device. It imports nothing of the port; cellbench's reference runs it.

Small bias-free MLPs (port of ``f2nerf_tpu/fields/mlp.py``; the
reference's tcnn FullyFusedMLP: ReLU hidden, linear output, no biases,
TCNNWP.cpp:79-100).

Precision follows the JAX package: inputs and weights are rounded to bf16,
products accumulate in f32 with an f32 output. ``torch.matmul`` on bf16
tensors would return bf16, so the rounded values are cast back to f32 and
multiplied in f32 (exact products of bf16 values, f32 sums). The casts'
backward rounds the gradients to bf16 at the same places as JAX's
transposed dots. TF32 must be off for this to hold on the card."""
from __future__ import annotations
import torch

def init_mlp(generator: torch.Generator, d_in: int, d_out: int, d_hidden: int, n_hidden_layers: int, device='cpu'):
    """He-uniform init for ReLU nets; a list of [a, b] f32 weights."""
    dims = [d_in] + [d_hidden] * (n_hidden_layers + 1) + [d_out]
    ws = []
    for a, b in zip(dims[:-1], dims[1:]):
        lim = (6.0 / a) ** 0.5
        u = torch.rand((a, b), generator=generator, device=generator.device)
        ws.append(((u * 2.0 - 1.0) * lim).to(device))
    return ws

def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)

def mlp_apply(ws, x: torch.Tensor) -> torch.Tensor:
    """ReLU-hidden, linear-output, bias-free forward: bf16 inputs, f32
    accumulation, f32 output."""
    h = _bf16_round(x)
    for i, w in enumerate(ws):
        h = torch.matmul(h, _bf16_round(w))
        if i + 1 < len(ws):
            h = _bf16_round(torch.relu(h))
    return h
