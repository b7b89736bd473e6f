"""The reference: one training step and one eval render of F2-NeRF in plain
PyTorch, from the frozen plain copies beside this file. A frozen copy of
the port's ``train/trainer.py`` step body (``make_core``: rays, render,
losses, backward, occupancy fold, NaN-guarded Adam) and eval chunk
(``make_render_fn``), with the init of the weights the benchmark hands
both sides. Imports nothing of the port.

``lower_precision()`` is the control: the same computation with the field
table, its encodings and every MLP product rounded to bfloat16, where the
configuration states float32 (the MLPs' inputs rounded to bfloat16 and
multiplied in float32).
"""

from __future__ import annotations

import contextlib

import torch

from . import adam, hash_block, hash_encoding, mlp, renderer, schedules
from . import sampler as dv
from .activations import weight_var
from .data import draw_rays, sample_rays
from .tree import map_leaves, named_leaves

ADAM_KW = dict(b1=0.9, b2=0.99, eps=1e-15)
WEIGHT_DECAY = 1e-6
N_EDGE = 8192
RUNTIME_KEYS = ("lr", "fineness", "grad_progress", "var_loss_weight")


def next_primes(seeds: torch.Tensor, chunk: int = 4096) -> torch.Tensor:
    """Each seed (odd-rounded) advanced to the next prime, on the seeds'
    device: the copies' ``_random_primes`` (trial division by the primes
    below 2^15, exact for candidates below 2^30) in a few large calls."""
    primes = torch.as_tensor(hash_encoding._small_primes(1 << 15)[1:], device=seeds.device)
    cand = seeds.to(torch.int64) | 1
    for lo in range(0, cand.numel(), chunk):
        part = cand[lo:lo + chunk]
        active = torch.arange(part.numel(), device=part.device)
        for _ in range(200):
            active = active[(part[active, None] % primes[None, :] == 0).any(dim=1)]
            if not active.numel():
                break
            part[active] += 2
    return cand


def init_params(generator: torch.Generator, cfg: dict, n_images: int, n_volumes: int):
    """(params, consts) with the configuration's init distributions
    (``hash_block.init_block_state`` / ``hash_encoding.init_hash_state``
    and ``mlp.init_mlp``, drawn in their order), made on the generator's
    device: params feat_pool, field_mlp, shader_mlp, app_emb (leaves
    requiring grad); consts prim_pool (the uint32 primes as int32),
    bias_pool."""
    fcfg, scfg = cfg["field"], cfg["shader"]
    dev = generator.device
    l2t, levels = int(fcfg["log2_table_size"]), hash_encoding.N_LEVELS
    if fcfg.get("type", "HashBlock") == "HashBlock":
        shape = (levels, hash_block.n_blocks(l2t), hash_block.LANES)
    else:
        shape = ((1 << l2t) * levels, hash_encoding.N_CHANNELS)
    feat_pool = (torch.rand(shape, generator=generator, device=dev) * 0.2 - 1.0) * 0.0001
    seeds = torch.randint(1 << 28, 1 << 30, (levels * n_volumes * 3,), generator=generator,
                          device=dev)
    prim_pool = next_primes(seeds).reshape(levels, n_volumes, 3).to(torch.int32)
    if bool(fcfg["rand_bias"]):
        bias_pool = torch.rand((levels, n_volumes, 3), generator=generator,
                               device=dev) * 1000.0 + 100.0
    else:
        bias_pool = torch.zeros((levels, n_volumes, 3), device=dev)
    field_mlp = mlp.init_mlp(generator, levels * hash_encoding.N_CHANNELS,
                             int(fcfg["mlp_out_dim"]), int(fcfg["mlp_hidden_dim"]),
                             int(fcfg["n_hidden_layers"]), device=dev)
    shader_mlp = mlp.init_mlp(generator, int(scfg["d_in"]), int(scfg["d_out"]),
                              int(scfg["d_hidden"]), int(scfg["n_hiddens"]), device=dev)
    app_emb = torch.randn((n_images, 16), generator=generator, device=dev) * 0.1
    params = dict(feat_pool=feat_pool, field_mlp=field_mlp, shader_mlp=shader_mlp,
                  app_emb=app_emb)
    params = map_leaves(lambda t: t.contiguous().requires_grad_(True), params)
    return params, dict(prim_pool=prim_pool, bias_pool=bias_pool)


def max_s_for(n_rays: int, pts_batch: int) -> int:
    """The per-ray sample cap of a training bucket (floored at 512)."""
    v, p = 4 * pts_batch // n_rays, 512
    while p < v and p < 1024:
        p *= 2
    return p


def statics(cfg: dict, n_rays: int, train: bool, max_s: int, cap1: int, cap2: int,
            max_hits: int, single_pass: bool) -> renderer.RenderStatics:
    """The render's static sizes and switches from the configuration and
    the capacities the step runs at."""
    p, r, f, s = cfg["pts_sampler"], cfg["renderer"], cfg["field"], cfg["shader"]
    return renderer.RenderStatics(
        max_hits=max_hits, max_s=max_s, cap1=cap1, cap2=cap2, n_edge=N_EDGE,
        log2_table_size=int(f["log2_table_size"]), sh_degree=int(s["degree"]),
        sample_l=float(p["sample_l"]), global_near=float(p["near"]),
        scale_by_dis=bool(p["scale_by_dis"]), use_app_emb=bool(r["use_app_emb"]),
        bg_mode=str(r["bg_color"]), train=train, single_pass=single_pass,
        field_type=str(f.get("type", "HashBlock")),
        march_mode=str(p.get("march_mode", "parallel")))


def runtime(step: int, tcfg: dict, device) -> dict:
    """The schedules of iteration ``step`` as 0-d f32 tensors."""
    row = torch.tensor([schedules.learning_rate(step, tcfg),
                        schedules.ray_march_fineness(step, tcfg),
                        schedules.gradient_scaling_progress(step, tcfg),
                        schedules.var_loss_weight(step, tcfg)],
                       dtype=torch.float32, device=device)
    return dict(zip(RUNTIME_KEYS, row))


def draw_step(generator: torch.Generator, data: dict, st: renderer.RenderStatics,
              n_rays: int, height: int, width: int, n_edges: int) -> dict:
    """One step's random draws: the ray picks and the render's draws."""
    draws = draw_rays(data, generator, n_rays, height, width)
    dev = generator.device
    if st.march_mode == "lockstep":
        u = torch.rand((n_rays + st.max_s + 16,), generator=generator, device=dev)
        draws["noise"] = (u - 0.5) + 1.0
    else:
        draws["jitter"] = torch.rand((n_rays, st.max_s), generator=generator,
                                     device=dev) * (1.0 - 1e-4) + 1e-4
    draws["bg"] = torch.rand((n_rays, 3), generator=generator, device=dev)
    e = torch.randint(0, max(n_edges, 1), (st.n_edge,), generator=generator, device=dev)
    draws["edge_idx"] = e.to(torch.int32)
    draws["edge_coord"] = torch.rand((st.n_edge, 2), generator=generator, device=dev) * 2.0 - 1.0
    return draws


def compute_losses(result: dict, gt, n_rays: int, tcfg: dict, rt: dict):
    pred = result["colors"]
    color_loss = torch.mean(torch.sqrt((pred - gt) ** 2 + 1e-4))
    disp_loss = torch.mean(result["disparity"] ** 2)
    ef = result["edge_feats"]
    tv_loss = torch.mean((ef[:, 0, :] - ef[:, 1, :]) ** 2)
    var = weight_var(result["weights"], result["ray_id"], result["i_local"], n_rays,
                     result["ray_offsets"])
    var_loss = torch.mean(torch.sqrt(var + 1e-2))
    return (color_loss + var_loss * rt["var_loss_weight"]
            + disp_loss * float(tcfg["disp_loss_weight"])
            + tv_loss * float(tcfg["tv_loss_weight"]))


def train_step(params, opt_state, tree, consts, data, rt, draws, n_rays: int,
               tcfg: dict, st: renderer.RenderStatics):
    """One training iteration; params and opt_state are updated in place.
    Returns (the tree after the occupancy fold, the loss as a float)."""
    rays_o, rays_d, gt, img_idx = sample_rays(data, draws["cam_pick"], draws["i"], draws["j"])
    for _, p in named_leaves(params):
        p.grad = None
    result, occ = renderer.render(params, consts, tree, rays_o, rays_d, img_idx, draws,
                                  rt["fineness"], rt["grad_progress"], st)
    loss = compute_losses(result, gt, n_rays, tcfg, rt)
    loss.backward()
    grads = map_leaves(lambda p: p.grad if p.grad is not None else torch.zeros_like(p),
                       params)
    new_tree = dv.apply_occupancy_adders_plain(tree, occ)
    finite = torch.stack([torch.isfinite(g).all() for _, g in named_leaves(grads)]).all()
    adam.apply_adam(params, opt_state, grads, rt["lr"], finite,
                    weight_decay=WEIGHT_DECAY, **ADAM_KW)
    return new_tree, float(loss.detach())


def render_rays(params, consts, tree, rays_o, rays_d, fineness: float,
                st: renderer.RenderStatics):
    """Eval render of rays [R, 3] (R = the statics' ray count): (colors
    [R, 3], disparity [R], samples of each ray [R])."""
    dev = rays_o.device
    with torch.no_grad():
        result, _ = renderer.render(
            params, consts, tree, rays_o, rays_d,
            torch.zeros((rays_o.shape[0],), dtype=torch.int32, device=dev), None,
            torch.tensor(fineness, dtype=torch.float32, device=dev),
            torch.ones((), dtype=torch.float32, device=dev), st)
    return result["colors"], result["disparity"], result["stats"]["n_sampled"]


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


@contextlib.contextmanager
def lower_precision():
    """Within the block the reference computes its field in bfloat16: the
    table read rounded, each encoding and each MLP product rounded."""
    saved_mlp, saved_encode = renderer.mlp_apply, renderer._field_encode

    def mlp_apply(ws, x):
        h = _bf16(x)
        for i, w in enumerate(ws):
            h = _bf16(torch.matmul(h, _bf16(w)))
            if i + 1 < len(ws):
                h = torch.relu(h)
        return h

    def field_encode(params, consts, pts01, vol_idx, st):
        low = dict(params, feat_pool=_bf16(params["feat_pool"]))
        return _bf16(saved_encode(low, consts, pts01, vol_idx, st))

    renderer.mlp_apply, renderer._field_encode = mlp_apply, field_encode
    try:
        yield
    finally:
        renderer.mlp_apply, renderer._field_encode = saved_mlp, saved_encode


def device_tree(fields: dict) -> dv.DeviceTree:
    """The reference's tree from a dict of the tree's fields."""
    return dv.DeviceTree(**fields)


def leaf_norms(tree) -> dict:
    """{leaf path: its float64 norm}."""
    return {k: float(torch.linalg.vector_norm(t.detach().double()))
            for k, t in named_leaves(tree)}

