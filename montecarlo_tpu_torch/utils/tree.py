"""Nested containers of tensors: the few tree operations the engine needs.

The JAX package's state, parameters and observables are pytrees.  Here they
are tuples, lists, dicts and dataclasses of tensors (or numpy arrays);
everything else is a leaf.  Sequences are walked in order, dataclass fields
in declaration order and dict keys in sorted order, as ``jax.tree_util``
walks them (a rebuilt dict has its keys sorted, as JAX's has).
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["tree_map", "tree_map_with_path", "tree_leaves",
           "tree_leaves_with_path", "ravel"]


def _children(node):
    """``(keys, values, rebuild)`` of an inner node, or None for a leaf."""
    if isinstance(node, (tuple, list)):
        return (tuple(range(len(node))), tuple(node),
                lambda vs, t=type(node): t(vs))
    if isinstance(node, dict):
        keys = tuple(sorted(node))
        return keys, tuple(node[k] for k in keys), \
            lambda vs: dict(zip(keys, vs))
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        names = tuple(f.name for f in dataclasses.fields(node))
        return (names, tuple(getattr(node, n) for n in names),
                lambda vs: dataclasses.replace(node, **dict(zip(names, vs))))
    return None


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over trees of the same structure."""
    ch = _children(tree)
    if ch is None:
        return fn(tree, *rest)
    keys, values, rebuild = ch
    others = [_children(r)[1] for r in rest]
    return rebuild([tree_map(fn, v, *(o[i] for o in others))
                    for i, v in enumerate(values)])


def tree_map_with_path(fn, tree, path=()):
    """Apply ``fn(path, leaf)`` leafwise, ``path`` as
    :func:`tree_leaves_with_path` gives it."""
    ch = _children(tree)
    if ch is None:
        return fn(path, tree)
    keys, values, rebuild = ch
    return rebuild([tree_map_with_path(fn, v, path + (k,))
                    for k, v in zip(keys, values)])


def tree_leaves_with_path(tree, path=()):
    """``[(path, leaf), ...]`` with ``path`` a tuple of dict keys, field
    names and sequence indices."""
    ch = _children(tree)
    if ch is None:
        return [(path, tree)]
    out = []
    for k, v in zip(ch[0], ch[1]):
        out.extend(tree_leaves_with_path(v, path + (k,)))
    return out


def tree_leaves(tree):
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def ravel(tree):
    """Flatten a tree of tensors into one 1-D tensor, the counterpart of
    ``jax.flatten_util.ravel_pytree``.

    Returns ``(flat, unravel)``: ``flat`` concatenates the leaves in tree
    order; ``unravel(v)`` cuts a ``(..., P)`` tensor back into the tree,
    each leaf a contiguous tensor of its shape and of ``v``'s dtype, with
    any leading axes of ``v`` kept in front (a ``(B, P)`` tensor gives
    leaves with a leading ``B`` axis).
    """
    leaves = [torch.as_tensor(x) for x in tree_leaves(tree)]
    shapes = [x.shape for x in leaves]
    sizes = [x.numel() for x in leaves]
    flat = torch.cat([x.reshape(-1) for x in leaves])

    def unravel(v):
        pieces = iter([p.reshape(v.shape[:-1] + s).contiguous()
                       for p, s in zip(torch.split(v, sizes, dim=-1), shapes)])
        return tree_map(lambda _: next(pieces), tree)

    return flat, unravel
