"""Nested containers of tensors: the few tree operations the engine needs.

The JAX package's state, parameters and observables are pytrees.  Here they
are tuples, lists, dicts and dataclasses of tensors (or numpy arrays);
everything else is a leaf.  Dataclass fields and dict keys are walked in
declaration / insertion order, as ``jax.tree_util`` walks them.
"""

from __future__ import annotations

import dataclasses

__all__ = ["tree_map", "tree_leaves", "tree_leaves_with_path"]


def _children(node):
    """``(keys, values, rebuild)`` of an inner node, or None for a leaf."""
    if isinstance(node, (tuple, list)):
        return (tuple(range(len(node))), tuple(node),
                lambda vs, t=type(node): t(vs))
    if isinstance(node, dict):
        keys = tuple(node)
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
