"""Frozen plain copy of the port's ``render.renderer``: every kernel dispatch replaced by the plain version it routes CPU tensors to, so this module runs plain torch on any device. It imports nothing of the port; cellbench's reference runs it.

Render pipeline: sample -> prefilter -> field/shader -> composite (port
of ``f2nerf_tpu/render/renderer.py``; reference Renderer::Render,
Renderer.cpp:52-213).

  1. octree traversal + parallel ray marching into dense per-ray buffers,
     compacted to a flat capacity-CAP1 buffer A with each sample warped
     (``compact_a_warp``, kernel K12 on the card);
  2. no-grad density prefilter: keep samples with transmittance > 1e-4,
     compacted to CAP2 (buffer B; ``compact_keep``, kernel K13 on the
     card); the raw A encodings are kept so B's encodings are a gather of
     them (cached-B);
  3. occupancy votes from the prefilter weights/alphas (training);
  4. grad pass: the field on B (+ 8192x2 TV edge samples in training),
     SH shader with the per-image appearance embedding, early-training
     gradient scaling;
  5. compositing with segmented sums.

Shapes are fixed by ``RenderStatics`` as in the JAX package. Random draws
enter as tensors (``draws``: jitter or noise, bg, edge_idx, edge_coord),
so both packages can be fed the same numbers.

Every variant of the JAX renderer is ported:
  * ``field_type``: 'HashBlock' (``hash_block_encode``, K2/K3; the two-pass
    grad pass gathers B's encodings from the prefilter's cache, K4) or
    'Hash3DAnchored' (``hash_encode``, K5/K6; no cache: the grad pass
    encodes B and the edge samples in one call);
  * ``march_mode``: 'parallel' (``ray_march_parallel``, jitter [R, max_s])
    or 'lockstep' (``ray_march``, K7, noise [R + max_s + 16]);
  * ``single_pass``: one field query over all of A (training: with the
    edge samples, grad-enabled, occupancy votes from the composite
    weights; eval: no votes), or the prefilter + B two-pass path in
    training and eval alike.
Eval statics draw nothing: jitter or noise of ones, no edge samples, no
appearance embedding, background 0.5 for ``rand_noise``."""
from __future__ import annotations
from typing import NamedTuple
import torch
from .hash_block import hash_block_encode, hash_block_gather_cached, hash_block_grad_pass
from .hash_encoding import hash_encode
from .mlp import mlp_apply
from .sh import sh_encode
from .activations import density_activation, gradient_scaling
from .segment import first_flags_from_ray_id, ray_gather, ray_offsets, ray_offsets_plain, segment_cumsum, segment_sum
from . import sampler as dv

class RenderStatics(NamedTuple):
    """Static render configuration (same fields as the JAX package's)."""
    max_hits: int
    max_s: int
    cap1: int
    cap2: int
    n_edge: int
    log2_table_size: int
    sh_degree: int
    sample_l: float
    global_near: float
    scale_by_dis: bool
    use_app_emb: bool
    bg_mode: str
    train: bool
    single_pass: bool = False
    field_type: str = 'HashBlock'
    march_mode: str = 'parallel'
FIELD_TYPES = ('HashBlock', 'Hash3DAnchored')
MARCH_MODES = ('parallel', 'lockstep')

def check_supported(st: RenderStatics) -> None:
    """Raise for a field type or march mode the renderer does not know."""
    if st.field_type not in FIELD_TYPES:
        raise ValueError(f'field type {st.field_type!r}: expected one of {FIELD_TYPES}')
    if st.march_mode not in MARCH_MODES:
        raise ValueError(f'march_mode {st.march_mode!r}: expected one of {MARCH_MODES}')

def _compact(valid_flat: torch.Tensor, cap: int, fields: dict, n_rays: int, ray_id_src=None, max_s: int=None):
    """Compact flat sample arrays keeping `valid` rows, padded to `cap`.

    Returns (gathered fields, ray_id, valid_mask, kept_idx). Padding rows
    get zeros, ray_id == n_rays and kept index n-1 (the JAX fill index)."""
    n = valid_flat.shape[0]
    dev = valid_flat.device
    pos = torch.cumsum(valid_flat.to(torch.int64), dim=0) - 1
    target = torch.where(valid_flat & (pos < cap), pos, torch.full_like(pos, cap))
    idx = torch.full((cap + 1,), n, dtype=torch.int64, device=dev)
    idx.scatter_reduce_(0, target, torch.arange(n, device=dev), 'amin')
    idx = idx[:cap]
    ok = idx < n
    idx_c = torch.clamp(idx, max=n - 1)
    out = {k: torch.where(ok.reshape((-1,) + (1,) * (v.dim() - 1)), v[idx_c], torch.zeros_like(v[:1])) for k, v in fields.items()}
    if ray_id_src is None:
        rid = idx_c // max_s
    else:
        rid = ray_id_src[idx_c].to(torch.int64)
    rid = torch.where(ok, rid, torch.full_like(rid, n_rays)).to(torch.int32)
    return (out, rid, ok, idx_c)

def _compact_rowpacked(n_s: torch.Tensor, cap: int, fields: dict, n_rays: int, max_s: int):
    """Compact a row-packed dense [n_rays, max_s] source (valid samples
    occupy the first n_s[r] slots of each row) into a flat cap buffer.
    Output identical to ``_compact(pos < n_s, ...)`` except the fourth
    return (source index, 0 for padding). Slot j belongs to the first ray
    whose end exceeds j (``searchsorted`` over the ray ends)."""
    dev = n_s.device
    n_s = n_s.to(torch.int64)
    ends = torch.cumsum(n_s, dim=0)
    starts = ends - n_s
    total = ends[-1]
    j = torch.arange(cap, device=dev)
    r = torch.searchsorted(ends, j, right=True).clamp(max=n_rays - 1)
    ok = j < total
    src = r * max_s + (j - starts[r])
    src_c = torch.where(ok, src, torch.zeros_like(src))
    out = {k: torch.where(ok.reshape((-1,) + (1,) * (v.dim() - 1)), v[src_c], torch.zeros_like(v[:1])) for k, v in fields.items()}
    rid = torch.where(ok, r, torch.full_like(r, n_rays)).to(torch.int32)
    return (out, rid, ok, src_c)

def compact_a_warp_plain(tree: dv.DeviceTree, n_s: torch.Tensor, out_t: torch.Tensor, out_dt: torch.Tensor, out_node: torch.Tensor, rays_o: torch.Tensor, rays_d: torch.Tensor, cap: int):
    """Plain PyTorch version of K12's ``compact_a_warp`` (JAX
    ``renderer.py:223-240``): ``_compact_rowpacked``, the leaf row, the
    world point, ``apply_warp`` and the pin of padding slots; A's ray
    offsets by a searchsorted over its ray ids."""
    R, max_s = out_t.shape
    a, rid_a, ok_a, _ = _compact_rowpacked(n_s, cap, dict(t=out_t.reshape(-1), dt=out_dt.reshape(-1), node=out_node.reshape(-1)), R, max_s=max_s)
    rid_ac = torch.clamp(rid_a, max=R - 1).long()
    node_a = torch.where(ok_a, a['node'], torch.zeros_like(a['node']))
    trans_a = torch.clamp(tree.trans_idx[node_a.long()], min=0)
    xyz_a = rays_o[rid_ac] + rays_d[rid_ac] * a['t'][:, None]
    warp_a = dv.apply_warp(tree, trans_a, xyz_a)
    pts01_a = torch.where(ok_a[:, None], (warp_a + 1.0) * 0.5, torch.full_like(warp_a, 0.5))
    keys = torch.arange(R + 1, dtype=rid_a.dtype, device=rid_a.device)
    offsets_a = torch.searchsorted(rid_a, keys).to(torch.int32)
    return (dict(a, trans=trans_a, pts01=pts01_a, dirs=rays_d[rid_ac]), rid_a, ok_a, offsets_a)

def compact_a_warp(tree: dv.DeviceTree, n_s: torch.Tensor, out_t: torch.Tensor, out_dt: torch.Tensor, out_node: torch.Tensor, rays_o: torch.Tensor, rays_d: torch.Tensor, cap: int):
    """The marcher's dense [R, max_s] output (row-packed: ray r's samples
    in its first n_s[r] slots) as flat buffer A [cap], each slot warped.
    Returns (fields, rid [cap] i32, ok [cap] bool, offsets [R + 1] i32);
    fields: t, dt [cap] f32, node, trans [cap] i32 (the slot's node and its
    leaf row max(trans_idx[node], 0)), pts01 [cap, 3] (the warped point in
    [0, 1]^3, 0.5 on padding) and dirs [cap, 3] (the ray's direction).
    Padding slots have t = dt = node = 0, rid = R and the last ray's
    direction. ``offsets`` are A's ray offsets as ``ray_offsets`` gives
    them for rid: ray r's first slot, min(the sum of n_s before r, cap),
    and offsets[R] the first padding slot. CPU tensors take
    ``compact_a_warp_plain``; CUDA tensors launch K12's
    ``f2_compact_a_warp`` (csrc/warp.cu: a block scans n_s for its slots'
    owners, block 0 writes the offsets, 2 slots a thread), bit for bit the
    plain version."""
    return compact_a_warp_plain(tree, n_s, out_t, out_dt, out_node, rays_o, rays_d, cap)
KEEP_FIELDS = (('t', torch.float32, 1), ('dt', torch.float32, 1), ('node', torch.int32, 1), ('trans', torch.int32, 1), ('pts01', torch.float32, 3), ('dirs', torch.float32, 3))

def compact_keep_plain(keep: torch.Tensor, cap: int, fields: dict, rid_src: torch.Tensor, n_rays: int):
    """Plain PyTorch version of K13 (JAX ``_compact`` with a ray-id source,
    renderer.py:72): ``_compact``, then B's segments by
    ``ray_offsets_plain`` of B's ray ids."""
    b, rid, ok, idx = _compact(keep, cap, fields, n_rays, ray_id_src=rid_src)
    return (b, rid, ok, idx, ray_offsets_plain(rid, n_rays))
_keep_states: dict = {}

def compact_keep(keep: torch.Tensor, cap: int, fields: dict, rid_src: torch.Tensor, n_rays: int):
    """The keep-set compaction A -> B: slot p < min(total, cap) takes the
    p-th kept row of A (kept rows past cap are dropped); padding slots get
    zeros, rid = n_rays and index n - 1. ``fields``: A's KEEP_FIELDS;
    rid_src: A's ray ids [n] i32 (ray-sorted, padding rows n_rays; kept
    rows lie in rays, as the prefilter keeps only valid rows). Returns
    (fields [cap], rid [cap] i32, ok [cap] bool, idx [cap] int64,
    segments): ``_compact``'s four, then B's segments, what ``ray_offsets``
    gives for B's rid: (offsets [n_rays + 1] i32, counts [n_rays] f32, local
    [cap] i32, first [cap] bool). CPU tensors take ``compact_keep_plain``;
    CUDA tensors launch K13 (csrc/compact.cu: one launch, tiles of A that
    look back over the earlier tiles' kept counts, then blocks that write
    B's padding), bit for bit the plain version."""
    return compact_keep_plain(keep, cap, fields, rid_src, n_rays)

def _field_encode(params, consts, pts01, vol_idx, statics: RenderStatics):
    """The field's hash encode -> [n, N_LEVELS*N_CHANNELS] features."""
    encode = hash_block_encode if statics.field_type == 'HashBlock' else hash_encode
    return encode(params['feat_pool'], consts['prim_pool'], consts['bias_pool'], pts01, vol_idx, statics.log2_table_size)

def _image_rows(app_emb: torch.Tensor, emb_idx: torch.Tensor) -> torch.Tensor:
    """``app_emb[emb_idx]`` [R, d] as the product of emb_idx's one-hot rows
    with the table: the same values (TF32 is off), and a backward, the
    one-hot's transpose times the gradient, that sums each image's rays in
    cuBLAS's fixed order."""
    hot = emb_idx.long()[:, None] == torch.arange(app_emb.shape[0], device=app_emb.device)
    return hot.to(app_emb.dtype) @ app_emb

def _shader_query(params, shading_feat, dirs, statics: RenderStatics):
    """SH encode + shader MLP + eps-widened sigmoid (SHShader.cpp:23-29)."""
    enc = sh_encode(dirs, statics.sh_degree)
    x = torch.cat([shading_feat, enc], dim=-1)
    out = mlp_apply(params['shader_mlp'], x)
    eps = 0.001
    return (1.0 + 2.0 * eps) * torch.sigmoid(out) - eps

def draw_render(generator: torch.Generator, statics: RenderStatics, n_rays: int, tree: dv.DeviceTree) -> dict:
    """The random draws of one training render: the marcher's (parallel:
    jitter [R, max_s] in [1e-4, 1); lockstep: noise [R + max_s + 16] in
    [0.5, 1.5), U[0, 1) - 0.5 + 1 as the JAX package draws it), bg [R, 3]
    in [0, 1), and the edge picks."""
    dev = generator.device
    if statics.march_mode == 'lockstep':
        u = torch.rand((n_rays + statics.max_s + 16,), generator=generator, device=dev)
        march = dict(noise=u - 0.5 + 1.0)
    else:
        march = dict(jitter=torch.rand((n_rays, statics.max_s), generator=generator, device=dev) * (1.0 - 0.0001) + 0.0001)
    bg = torch.rand((n_rays, 3), generator=generator, device=dev)
    edge_idx, edge_coord = dv.draw_edges(tree, generator, statics.n_edge)
    return dict(march, bg=bg, edge_idx=edge_idx, edge_coord=edge_coord)

def render(params: dict, consts: dict, tree: dv.DeviceTree, rays_o: torch.Tensor, rays_d: torch.Tensor, emb_idx: torch.Tensor, draws: dict | None, fineness, grad_progress, statics: RenderStatics):
    """Render a fixed-size ray batch. Returns (result dict, occupancy-vote
    dict or None); the caller folds the votes into the tree with
    ``apply_occupancy_adders``.

    params: feat_pool, field_mlp, shader_mlp, app_emb. consts: prim_pool
    (int32 bits of the uint32 primes), bias_pool. emb_idx: [R] image index.
    draws: jitter or noise, bg, edge_idx, edge_coord (``draw_render``);
    None for eval statics, which draw nothing.
    fineness / grad_progress: 0-d tensors.
    """
    st = statics
    check_supported(st)
    R = rays_o.shape[0]
    dev = rays_o.device
    f32 = dict(dtype=torch.float32, device=dev)
    l2t = st.log2_table_size
    feat_pool, prim, bias = (params['feat_pool'], consts['prim_pool'], consts['bias_pool'])
    rays_d = rays_d / dv.norm3(rays_d)[:, None]
    near = torch.full((R,), st.global_near, **f32)
    far = torch.full((R,), 100000000.0, **f32)
    hit_idx, hit_near, hit_far, n_hits, trav_trunc, trav_iters = dv.traverse(tree, rays_o, rays_d, near, far, st.max_hits)
    if st.march_mode == 'parallel':
        jitter = draws['jitter'] if st.train else torch.ones((R, st.max_s), **f32)
        out_t, out_dt, out_node, n_s, first_oct = dv.ray_march_parallel(tree, rays_o, rays_d, hit_idx, hit_near, hit_far, n_hits, jitter, fineness, st.sample_l, st.scale_by_dis, st.max_s)
    else:
        noise = draws['noise'] if st.train else torch.ones((R + st.max_s + 16,), **f32)
        out_t, out_dt, out_node, n_s, first_oct = dv.ray_march(tree, rays_o, rays_d, hit_idx, hit_near, hit_far, n_hits, noise * fineness, st.sample_l, st.scale_by_dis, st.max_s)
    a, rid_a, ok_a, offsets_a = compact_a_warp(tree, n_s, out_t, out_dt, out_node, rays_o, rays_d, st.cap1)
    trans_a, pts01_a, dirs_a = (a['trans'], a['pts01'], a['dirs'])
    occ = None
    if st.single_pass:
        b = a
        rid_b, ok_b = (rid_a, ok_a)
        vol_b = trans_a
        seg_b = None
    else:
        with torch.no_grad():
            enc_a = _field_encode(params, consts, pts01_a, trans_a, st)
            feat_a = mlp_apply([w.detach() for w in params['field_mlp']], enc_a)
            sigma_a = density_activation(feat_a[:, 0])
            sigma_a = torch.where(ok_a, sigma_a, torch.zeros_like(sigma_a))
            sec_a = sigma_a * a['dt']
            first_a = first_flags_from_ray_id(rid_a, R)
            acc_a = segment_cumsum(sec_a, first_a, exclusive=True)
            trans_vis_a = torch.exp(-acc_a)
            alpha_a = 1.0 - torch.exp(-sec_a)
            weights_a = trans_vis_a * alpha_a
            keep = ok_a & (trans_vis_a > 0.0001)
            n_keep = keep.to(torch.float32).sum()
            if st.train:
                occ = dv.compute_occupancy_adders(tree, a['node'], rid_a, weights_a, alpha_a, R, offsets_a)
        b, rid_b, ok_b, idx_b, seg_b = compact_keep(keep, st.cap2, a, rid_a, R)
        vol_b = b['trans']
    cached = not st.single_pass and st.field_type == 'HashBlock'
    edge_feat = None
    if st.train:
        edge_pts, edge_anchor = dv.sample_edges(tree, draws['edge_idx'], draws['edge_coord'])
        edge_pts01 = (edge_pts.reshape(-1, 3) + 1.0) * 0.5
        edge_vol = edge_anchor.reshape(-1)
        if cached:
            enc_b, enc_edge = hash_block_grad_pass(feat_pool, prim, bias, b['pts01'], vol_b, l2t, enc_a, idx_b, edge_pts01, edge_vol)
            enc_b = torch.where(ok_b[:, None], enc_b, torch.zeros_like(enc_b))
            enc = torch.cat([enc_b, enc_edge], dim=0)
        else:
            enc = _field_encode(params, consts, torch.cat([b['pts01'], edge_pts01], dim=0), torch.cat([vol_b, edge_vol], dim=0), st)
        all_feat = mlp_apply(params['field_mlp'], enc)
        scene_feat = all_feat[:st.cap2]
        edge_feat = all_feat[st.cap2:].reshape(st.n_edge, 2, -1)
    elif cached:
        enc_b = hash_block_gather_cached(feat_pool, prim, bias, b['pts01'], vol_b, l2t, enc_a, idx_b)
        enc_b = torch.where(ok_b[:, None], enc_b, torch.zeros_like(enc_b))
        scene_feat = mlp_apply(params['field_mlp'], enc_b)
    else:
        scene_feat = mlp_apply(params['field_mlp'], _field_encode(params, consts, b['pts01'], vol_b, st))
    sigma = density_activation(scene_feat[:, :1])
    sigma = torch.where(ok_b[:, None], sigma, torch.zeros_like(sigma))
    shading_feat = torch.cat([torch.ones_like(scene_feat[:, :1]), scene_feat[:, 1:]], dim=-1)
    if seg_b is None:
        seg_b = ray_offsets(rid_b, R, offsets_a)
    offsets_b, counts_b, i_local, first_b = seg_b
    if st.train and st.use_app_emb:
        shading_feat = shading_feat + ray_gather(_image_rows(params['app_emb'], emb_idx), rid_b, R, offsets_b)
    colors_s = _shader_query(params, shading_feat, b['dirs'], st)
    count_of = torch.clamp(ray_gather(counts_b, rid_b, R, offsets_b), min=1.0)
    a_norm = (i_local.to(torch.float32) + 0.5) / count_of
    sigma = gradient_scaling(sigma, a_norm, grad_progress)
    colors_s = gradient_scaling(colors_s, a_norm, grad_progress)
    sampled_t = b['t'] + 0.01
    sec = sigma[:, 0] * b['dt']
    acc = segment_cumsum(sec, first_b, exclusive=True)
    trans_vis = torch.exp(-acc)
    alpha = 1.0 - torch.exp(-sec)
    weights = trans_vis * alpha
    weights = torch.where(ok_b, weights, torch.zeros_like(weights))
    if st.bg_mode == 'white':
        bg = torch.ones((R, 3), **f32)
    elif st.bg_mode == 'black':
        bg = torch.zeros((R, 3), **f32)
    elif st.train:
        bg = draws['bg']
    else:
        bg = torch.full((R, 3), 0.5, **f32)
    sums = segment_sum(torch.cat([sec[:, None], weights[:, None] * colors_s, (weights / sampled_t)[:, None], (weights * sampled_t)[:, None]], dim=1), rid_b, R, offsets_b)
    last_trans = torch.exp(-sums[:, 0])
    colors = sums[:, 1:4] + last_trans[:, None] * bg
    disparity = sums[:, 4]
    depth = sums[:, 5] / (1.0 - last_trans + 0.0001)
    if st.single_pass:
        n_keep = (ok_b & (trans_vis > 0.0001)).to(torch.float32).sum()
        overflow_b = torch.zeros((), **f32)
        if st.train:
            with torch.no_grad():
                occ = dv.compute_occupancy_adders(tree, b['node'], rid_b, weights, alpha, R, offsets_b)
    else:
        overflow_b = n_keep - ok_b.to(torch.float32).sum()
    n_ok_a = ok_a.to(torch.float32).sum()
    result = dict(colors=colors, first_oct_dis=first_oct, disparity=disparity, depth=depth, edge_feats=edge_feat, weights=weights, ray_id=rid_b, i_local=i_local, ray_offsets=offsets_b, last_trans=last_trans, stats=dict(n_sampled=n_ok_a, n_meaningful=n_keep, n_oct_hits=n_hits.to(torch.float32).sum(), max_oct_hits=n_hits.max().to(torch.float32), overflow_a=n_s.to(torch.float32).sum() - n_ok_a, n_saturated=(n_s >= st.max_s).to(torch.float32).sum(), n_trav_truncated=trav_trunc.to(torch.float32).sum(), overflow_b=overflow_b), trav_iters=trav_iters)
    return (result, occ)
