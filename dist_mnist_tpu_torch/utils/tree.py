"""Nested-dict parameter trees: the port's stand-in for JAX pytrees.

Params are plain nested dicts of tensors (lists/tuples allowed), with
`ops.quant.QuantizedArray` as a leaf. Paths are tuples of keys, the same
components `jax.tree_util.tree_flatten_with_path` yields for a dict tree,
so leaf rules and error reports name leaves identically in both packages.
"""

from __future__ import annotations


def flatten_with_path(tree, path: tuple = ()) -> list[tuple[tuple, object]]:
    """[(path, leaf)] in key-sorted order (JAX's dict flattening order)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten_with_path(tree[k], (*path, k))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += flatten_with_path(v, (*path, i))
        return out
    return [(path, tree)]


def map_with_path(fn, tree, path: tuple = ()):
    """Structure-preserving `fn(path, leaf)` over every leaf."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, (*path, k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, (*path, i))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_map(fn, tree):
    return map_with_path(lambda _path, leaf: fn(leaf), tree)


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]
