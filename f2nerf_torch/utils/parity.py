"""Agreement of one training step computed two ways from one state and one
set of draws: the JAX package against the port on the CPU
(tests/test_torch_train_step.py), and the port on the card against the
port on the CPU (chip_smoke.py). Both comparisons use these tolerances.

Why each bound:
  * loss_rtol 1e-5: the loss is a mean over the batch; the two sides sum
    in other orders (segment sums, matmuls, atomics).
  * grad_rel 1e-2, per leaf as ||a - b|| / ||b||: MLP gradients are
    rounded to bf16 at every layer (one bf16 ulp is 2^-8 = 0.4%), and the
    JAX package's compiled hash index math may contract into an FMA, which
    moves a sample's interpolation weights by one ulp of its grid
    coordinate.
  * params: Adam normalizes every entry, so an entry whose gradient sits
    at rounding-noise level (a weight into a ReLU unit that has not fired,
    a table row touched by one sample) can flip the sign of its step. Per
    leaf, at most param_outlier_frac of the entries, or 2 entries if that
    is more, may differ by more than param_atol; none by more than
    param_step_bound learning rates.
  * occ_frac: occupancy counters are integers voted from thresholds on the
    prefilter weights; at most this fraction of nodes may differ.

Eval rendering (``render`` with eval statics, ``Trainer.render_image``),
EVAL_TOL. Sample counts, ray ids, truncation flags and the chunks
rendered again must be equal; ``first_oct_dis`` involves no density and
agrees to ``oct_atol``. Colours and disparity:
  * against JAX run op by op (``jax.disable_jit``):
    ``color_atol``/``disp_atol`` for every ray (the same per-operation
    rounding; sums and matmuls in another order), depth to
    ``depth_rtol`` (it divides by 1 - last_trans + 1e-4, which magnifies
    the error of a nearly transparent ray).
  * against compiled JAX, and the card against the CPU: XLA contracts the hash index math, the warp and
    the composite into FMAs, so samples move by ulps; at a block boundary
    the duplicated corner features turn that into a jump of the encoding.
    JAX compiled differs from JAX op by op in the same way (3.0e-4 on one
    64-ray chunk where the port is within 1.5e-5 of the op-by-op JAX). So
    every ray is held to ``outlier_atol`` and at most ``outlier_frac`` of
    the rays may exceed ``color_atol * 20``; measured on the ball scene
    with N(0, 3^2) features: median 2.3e-5, 13 of 2,400 rays over 1e-3,
    largest 2.1e-2. On the card, exp and log come from CUDA's libm and
    the MLP sums from cuBLAS in another order; a last-bit change of a
    hidden value can flip its bf16 rounding, so the same form holds.
  * ``psnr_db``: the runner's per-image PSNR quantizes colours to uint8,
    so a colour near a level boundary can flip one level.
"""

from __future__ import annotations

import numpy as np

STEP_TOL = dict(loss_rtol=1e-5, grad_rel=1e-2, param_atol=1e-6,
                param_outlier_frac=1e-3, param_step_bound=3.0, occ_frac=1e-3)
EVAL_TOL = dict(color_atol=5e-5, disp_atol=2e-5, depth_rtol=1e-3,
                oct_atol=1e-5, outlier_frac=1e-2, outlier_atol=5e-2,
                psnr_db=0.05)


def _np(x):
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def step_errors(loss_a, loss_b, grads_a: dict, grads_b: dict,
                params_a: dict, params_b: dict, occ_a: dict, occ_b: dict,
                lr: float) -> dict:
    """Worst-case errors of side a against reference side b. grads/params:
    {leaf name: array}; occ: {counter name: int array}. ``param_outliers``
    is the worst leaf's outlier count over its allowance (<= 1 passes)."""
    loss_err = abs(float(loss_a) - float(loss_b)) / max(abs(float(loss_b)), 1e-30)
    grad_err = float(max(np.linalg.norm(_np(grads_a[k]) - _np(grads_b[k]))
                   / max(np.linalg.norm(_np(grads_b[k])), 1e-30) for k in grads_b))
    outlier, step = 0.0, 0.0
    for k in params_b:
        d = np.abs(_np(params_a[k]) - _np(params_b[k]))
        allowed = max(2.0, STEP_TOL["param_outlier_frac"] * d.size)
        outlier = max(outlier, float((d > STEP_TOL["param_atol"]).sum()) / allowed)
        step = max(step, float(d.max()) / max(lr, 1e-30))
    n_nodes = max(len(_np(v)) for v in occ_b.values())
    occ = max(int((_np(occ_a[k]) != _np(occ_b[k])).sum()) for k in occ_b) / n_nodes
    return dict(loss_rel=loss_err, grad_rel=grad_err, param_outliers=outlier,
                param_steps=step, occ_frac=occ)


def step_agrees(err: dict) -> bool:
    t = STEP_TOL
    return (err["loss_rel"] <= t["loss_rtol"] and err["grad_rel"] <= t["grad_rel"]
            and err["param_outliers"] <= 1.0
            and err["param_steps"] <= t["param_step_bound"]
            and err["occ_frac"] <= t["occ_frac"])


def image_errors(colors_a, disp_a, colors_b, disp_b) -> dict:
    """Per-ray colour (max over channels) and disparity errors of side a
    against side b: the largest, and the fraction of rays over 20x the
    every-ray bound (``eval_agrees`` reads both)."""
    ec = np.abs(_np(colors_a) - _np(colors_b)).reshape(len(_np(disp_b)), -1).max(-1)
    ed = np.abs(_np(disp_a) - _np(disp_b))
    t = EVAL_TOL
    over = (ec > 20 * t["color_atol"]) | (ed > 20 * t["disp_atol"])
    return dict(color_max=float(ec.max()), disp_max=float(ed.max()),
                color_median=float(np.median(ec)), over_frac=float(over.mean()))


def eval_agrees(err: dict, exact: bool) -> bool:
    """``exact``: the every-ray bounds (JAX op by op); otherwise the
    outlier form (compiled JAX, card vs CPU)."""
    t = EVAL_TOL
    if exact:
        return err["color_max"] <= t["color_atol"] and err["disp_max"] <= t["disp_atol"]
    return (err["over_frac"] <= t["outlier_frac"]
            and err["color_max"] <= t["outlier_atol"]
            and err["disp_max"] <= t["outlier_atol"]
            and err["color_median"] <= t["color_atol"])
