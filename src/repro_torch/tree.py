"""The port's one walker over param trees: nested dicts and tuples of
tensors (the xLSTM stack keeps its layers as a tuple of per-layer dicts,
every other family nests dicts only).

``leaves``/``tree_map``/``unflatten`` walk in the tree's own order (dict
insertion order, tuple order); ``paths`` walks in JAX's flatten order
(dict keys sorted, tuples in order), which the checkpoint layout numbers
its leaves by, and ``treedef_str`` prints JAX's ``str(treedef)``.
"""
from __future__ import annotations

import dataclasses

import torch


def leaves(tree) -> list:
    """The leaves in the tree's own order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, tuple):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of trees of one structure (the first tree's
    key order)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, v, *(r[i] for r in rest))
                     for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(like, values):
    """``like``'s structure with its leaves replaced, in ``leaves`` order,
    by ``values``."""
    it = iter(values)
    return tree_map(lambda _: next(it), like)


def paths(tree, prefix=()):
    """(key path, leaf) pairs in JAX's flatten order: dict keys sorted,
    tuple entries in order (a tuple entry's key is its index)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from paths(tree[k], prefix + (k,))
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            yield from paths(v, prefix + (i,))
    else:
        yield prefix, tree


def treedef_str(tree) -> str:
    """The reference's ``str(jax.tree_util.tree_flatten(tree)[1])``."""
    def one(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {one(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, tuple):
            inner = ", ".join(one(v) for v in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        return "*"
    return f"PyTreeDef({one(tree)})"


def rebuild(like, by_path):
    """``like``'s structure with each leaf taken from ``by_path[key
    path]`` (the key paths of ``paths``)."""
    def go(t, prefix):
        if isinstance(t, dict):
            return {k: go(v, prefix + (k,)) for k, v in t.items()}
        if isinstance(t, tuple):
            return tuple(go(v, prefix + (i,)) for i, v in enumerate(t))
        return by_path[prefix]
    return go(like, ())


def named_map(fn, tree, names=()):
    """``fn(names, leaf)`` over every tensor of a tree of dicts, tuples and
    dataclasses (the caches), rebuilt in the same structure.  ``names`` are
    the dict keys and dataclass field names on the way to the leaf (tuple
    indices are not names), as the reference's ``_names`` reads a JAX key
    path; a field that holds no tensor (``None``, a window, a page size)
    stays as it is."""
    if isinstance(tree, dict):
        return {k: named_map(fn, v, names + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(named_map(fn, v, names) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: named_map(fn, getattr(tree, f.name), names + (f.name,))
            for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name),
                          (dict, tuple, torch.Tensor))
            or dataclasses.is_dataclass(getattr(tree, f.name))})
    if isinstance(tree, torch.Tensor):
        return fn(names, tree)
    return tree
