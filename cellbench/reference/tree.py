"""Frozen plain copy of the port's ``utils.tree``: every kernel dispatch replaced by the plain version it routes CPU tensors to, so this module runs plain torch on any device. It imports nothing of the port; cellbench's reference runs it.

Leaf naming for the port's param/optimizer trees (nested dicts and
lists of tensors), identical to ``jax.tree_util.keystr`` on the JAX
package's pytrees: dict keys sorted, e.g. ``['field_mlp'][0]``. The
checkpoint keys and the optimizer's leaf order both come from here."""
from __future__ import annotations

def named_leaves(tree, path: str='') -> list[tuple[str, object]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += named_leaves(tree[k], f'{path}[{k!r}]')
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += named_leaves(v, f'{path}[{i}]')
        return out
    return [(path, tree)]

def map_leaves(fn, tree):
    """Same structure, each leaf replaced by fn(leaf)."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)((map_leaves(fn, v) for v in tree))
    return fn(tree)
