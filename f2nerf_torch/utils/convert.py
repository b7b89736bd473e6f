"""Carry state across the two packages.

Two entry points:

  * ``convert_state`` turns the JAX package's params, Adam state and
    consts, given as numpy arrays (nested dicts/lists as the JAX pytrees
    are), into the port's tensors;
  * ``state_from_named`` / ``state_to_named`` read and write the
    name-keyed checkpoint layout of ``f2nerf_tpu`` ``Trainer`` (state.npz:
    ``p:['feat_pool']``, ``o:[1].count``, ``o:[1].mu['field_mlp'][0]``,
    ``c:['prim_pool']`` ...), with ``octree_from_named`` /
    ``octree_to_named`` for the host tree (``node_*``, warp and edge keys).

The optax chain's state is (MaskedState(EmptyState), ScaleByAdamState);
only the second element has leaves, hence the ``o:[1]`` prefix. The port
keeps the uint32 primes as int32 bits (every prime is < 2^31) and writes
them back as uint32. The layout is the same for both fields: the feature
pool is HashBlock's [16, n_blocks, 128] tables or Hash3DAnchored's
[pool, 2] pool, carried by shape.
"""

from __future__ import annotations

import numpy as np
import torch

from ..sampler.octree import OctreeHost
from .tree import map_leaves, named_leaves

_OPT = "o:[1]"


def _tensor(x, device, grad=False):
    t = torch.as_tensor(np.array(x, copy=True), device=device)
    return t.requires_grad_(True) if grad else t


def convert_state(params: dict, opt: dict, consts: dict, device="cpu"):
    """(params, opt_state, consts) of the port from numpy trees.

    params: {feat_pool, field_mlp: [...], shader_mlp: [...], app_emb};
    opt: {count, mu, nu} (mu/nu shaped like params); consts: {prim_pool
    (uint32), bias_pool}."""
    p = map_leaves(lambda x: _tensor(np.asarray(x, np.float32), device, True),
                   params)
    o = dict(count=_tensor(np.asarray(opt["count"], np.int32), device),
             mu=map_leaves(lambda x: _tensor(np.asarray(x, np.float32), device),
                           opt["mu"]),
             nu=map_leaves(lambda x: _tensor(np.asarray(x, np.float32), device),
                           opt["nu"]))
    c = dict(prim_pool=_tensor(np.asarray(consts["prim_pool"]).astype(np.int32),
                               device),
             bias_pool=_tensor(np.asarray(consts["bias_pool"], np.float32), device))
    return p, o, c


def _unflatten_like(names: list[str], prefix: str, z) -> dict:
    """Rebuild the {feat_pool, field_mlp: [..], ...} tree from keys."""
    out: dict = {}
    for name in names:
        key = name[len(prefix):]          # e.g. "['field_mlp'][0]"
        parts = key.strip("[]").split("][")
        top = parts[0].strip("'")
        if len(parts) == 1:
            out[top] = z[name]
        else:
            out.setdefault(top, {})[int(parts[1])] = z[name]
    return {k: [v[i] for i in sorted(v)] if isinstance(v, dict) else v
            for k, v in out.items()}


def state_from_named(z, device="cpu"):
    """(params, opt_state, consts) from a name-keyed mapping (an opened
    state.npz of either package)."""
    files = list(z.keys()) if hasattr(z, "keys") else list(z.files)
    params = _unflatten_like([k for k in files if k.startswith("p:")], "p:", z)
    mu = _unflatten_like([k for k in files if k.startswith(_OPT + ".mu")],
                         _OPT + ".mu", z)
    nu = _unflatten_like([k for k in files if k.startswith(_OPT + ".nu")],
                         _OPT + ".nu", z)
    consts = _unflatten_like([k for k in files if k.startswith("c:")], "c:", z)
    return convert_state(params, dict(count=z[_OPT + ".count"], mu=mu, nu=nu),
                         consts, device)


def state_to_named(params: dict, opt_state: dict, consts: dict) -> dict:
    """The name-keyed numpy mapping of the JAX checkpoint layout."""
    def host(t):
        return t.detach().cpu().numpy()

    out = {f"p:{k}": host(v) for k, v in named_leaves(params)}
    out[_OPT + ".count"] = host(opt_state["count"]).astype(np.int32)
    out.update({f"{_OPT}.mu{k}": host(v) for k, v in named_leaves(opt_state["mu"])})
    out.update({f"{_OPT}.nu{k}": host(v) for k, v in named_leaves(opt_state["nu"])})
    out["c:['bias_pool']"] = host(consts["bias_pool"])
    out["c:['prim_pool']"] = host(consts["prim_pool"]).astype(np.uint32)
    return out


_NODE_KEYS = dict(center="node_center", side="node_side", parent="node_parent",
                  childs="node_childs", is_leaf="node_is_leaf",
                  trans_idx="node_trans", weight_stats="node_wstat",
                  alpha_stats="node_astat", visit_cnt="node_visit")
_TABLE_KEYS = ("w2xz", "weight", "t_center", "t_dis", "edge_t", "edge_center",
               "edge_dir0", "edge_dir1")


def octree_from_named(z) -> OctreeHost:
    """The host octree from a checkpoint mapping."""
    kw = {f: np.array(z[k]) for f, k in _NODE_KEYS.items()}
    kw.update({k: np.array(z[k]) for k in _TABLE_KEYS})
    return OctreeHost(side_len=float(z["side_len"]),
                      milestones=[int(m) for m in z["milestones"]], **kw)


def octree_to_named(t: OctreeHost) -> dict:
    out = {k: getattr(t, f) for f, k in _NODE_KEYS.items()}
    out.update({k: getattr(t, k) for k in _TABLE_KEYS})
    out["side_len"] = t.side_len
    out["milestones"] = np.asarray(t.milestones, np.int64)
    return out


def octree_from_fields(tree) -> OctreeHost:
    """Copy any object with OctreeHost's fields (the JAX package's host
    tree) into the port's OctreeHost."""
    kw = {f: np.array(getattr(tree, f)) for f in _NODE_KEYS}
    kw.update({k: np.array(getattr(tree, k)) for k in _TABLE_KEYS})
    return OctreeHost(side_len=float(tree.side_len),
                      milestones=list(tree.milestones), **kw)
