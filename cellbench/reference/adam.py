"""Frozen plain copy of the port's ``ops.fused_adam``: every kernel dispatch replaced by the plain version it routes CPU tensors to, so this module runs plain torch on any device. It imports nothing of the port; cellbench's reference runs it.

Fused Adam(+weight decay): kernel K1's wrapper and the port's
``apply_adam`` (port of ``f2nerf_tpu/ops/fused_adam.py``).

Semantics are those of trainer.make_optimizer()'s optax chain:

    g'   = g + wd * p                      (coupled decay; wd = 0 for the
                                            feature pool, 1e-6 elsewhere)
    m    = b1 * m + (1 - b1) * g'
    v    = b2 * v + (1 - b2) * g'^2
    p'   = p - lr * (m * c1) / (sqrt(v * c2) + eps)

with c1 = 1/(1 - b1^t), c2 = 1/(1 - b2^t) computed in f32 from the int32
step count. Every leaf goes through the kernel on the card (the JAX
package sends only the pool to Pallas). The all-finite guard is a device
bool read by the kernel, so a skipped step costs no host sync and leaves
params, moments and the count untouched.

The update is in place: ``params`` and ``opt_state`` tensors are written."""
from __future__ import annotations
import torch
from .tree import map_leaves, named_leaves

def adam_leaf_plain(p, m, v, g, scal, flag, *, b1: float, b2: float, eps: float, wd: float):
    """Plain PyTorch version of K1, in place; also the CPU path."""
    with torch.no_grad():
        lr, c1, c2 = (scal[0], scal[1], scal[2])
        if wd:
            g = g + wd * p
        m_new = b1 * m + (1.0 - b1) * g
        v_new = b2 * v + (1.0 - b2) * (g * g)
        u = m_new * c1 / (torch.sqrt(v_new * c2) + eps)
        p_new = p - lr * u
        p.copy_(torch.where(flag, p_new, p))
        m.copy_(torch.where(flag, m_new, m))
        v.copy_(torch.where(flag, v_new, v))

def fused_adam(p, m, v, g, scal, flag, *, b1: float, b2: float, eps: float, wd: float):
    """One in-place Adam step over one leaf.

    p, m, v, g: f32 tensors of one shape. scal: [3] f32 (lr, c1, c2) on the
    same device. flag: 0-d bool, the all-finite guard. CPU tensors take the
    plain version; CUDA tensors launch K1 (csrc/fused_adam.cu)."""
    adam_leaf_plain(p, m, v, g, scal, flag, b1=b1, b2=b2, eps=eps, wd=wd)
    return

def init_adam_state(params) -> dict:
    """optax scale_by_adam's state: count, and mu/nu shaped like params."""
    dev = params['feat_pool'].device
    return dict(count=torch.zeros((), dtype=torch.int32, device=dev), mu=map_leaves(lambda t: torch.zeros_like(t.detach()), params), nu=map_leaves(lambda t: torch.zeros_like(t.detach()), params))

def apply_adam(params, opt_state, grads, lr, finite, *, b1: float, b2: float, eps: float, weight_decay: float):
    """In-place Adam over every leaf; weight decay on every leaf but
    ``feat_pool``. ``grads`` has the structure of ``params``; ``lr`` a
    float or 0-d tensor; ``finite`` a 0-d bool tensor (False skips the
    update and keeps the count)."""
    dev = opt_state['count'].device
    with torch.no_grad():
        count = opt_state['count'] + finite.to(torch.int32)
        cf = count.to(torch.float32)
        f32 = dict(dtype=torch.float32, device=dev)
        one = torch.ones((), **f32)
        c1 = one / (one - torch.pow(torch.full((), b1, **f32), cf))
        c2 = one / (one - torch.pow(torch.full((), b2, **f32), cf))
        lr_t = (lr.to(**f32) if torch.is_tensor(lr) else torch.full((), float(lr), **f32)).reshape(())
        scal = torch.stack([lr_t, c1, c2]).contiguous()
        flag = finite.reshape(()).to(torch.bool)
        leaves_p = named_leaves(params)
        leaves_g = [t for _, t in named_leaves(grads)]
        leaves_m = [t for _, t in named_leaves(opt_state['mu'])]
        leaves_v = [t for _, t in named_leaves(opt_state['nu'])]
        for (path, p), g, m, v in zip(leaves_p, leaves_g, leaves_m, leaves_v):
            wd = 0.0 if path.startswith("['feat_pool']") else weight_decay
            fused_adam(p.data, m, v, g, scal, flag, b1=b1, b2=b2, eps=eps, wd=wd)
        opt_state['count'].copy_(count)
